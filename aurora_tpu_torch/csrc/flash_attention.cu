// Flash attention for training, sm_90a: the forward, the dK/dV backward and
// the dQ backward.
//
// Replaces: aurora_tpu/ops/pallas/flash_attention.py `_flash_fwd` (Pallas
// kernel `_fwd_kernel`) and `_flash_bwd` (`_bwd_dkv_kernel`,
// `_bwd_dq_kernel`). Contract, per (batch, head), with GQA already repeated
// by the caller: s = scale * q . k over the visible pairs, where a query row
// t sees key s iff t < T, s < S, (not causal or t + q_offset >= s) and, with
// segment ids, q_seg[t] == kv_seg[s]. The forward keeps an fp32 online
// softmax and writes out = acc / max(l, 1e-30) in bf16 and
// lse = m + log(max(l, 1e-30)) in fp32, m starting at -2.3819763e38, so a
// row that sees no key gives out 0 and lse -2.3819763e38. The backward
// recomputes p = exp(s - lse) on visible pairs (0 elsewhere) and takes
// delta = rowsum(dO * O) (minus the lse cotangent) from the caller:
// dV = p^T dO, dS = p (dO V^T - delta) scale, dK = dS^T q, dQ = dS k.
//
// What bounds it on the H100: at the training shape (B 4, T 2048, H 32,
// D 128, causal) each K/V tile is reused by every query tile below it, so
// the work is ~1.4e11 multiply-adds (x2 FLOPs) in the forward against ~0.2
// GB of q/k/v/out: compute-bound, tensor cores are what matters.
//
// Design: tiles of 64 rows, 4 warps of 16 rows, WMMA bf16 16x16x16 products
// with fp32 accumulation; a block loops over the other sequence axis (the
// Pallas grid's sequential kv axis) inside itself, stopping at the causal
// limit. Heads narrower than 128 are zero-padded in shared memory, which
// leaves every product unchanged. Forward: one block per (q tile, b·h); the
// scores, probabilities and output accumulator live in shared memory, where
// each warp rescales its own rows (WMMA fragments are opaque). dK/dV: one
// block per (kv tile, b·h), looping over the q tiles that can see it; each
// warp computes S^T and dP^T for its 16 keys, so P^T and dS^T never cross
// warps, and dK/dV stay in WMMA fragments for the whole loop. dQ: one block
// per (q tile, b·h), looping over kv tiles, dQ in fragments. No atomics:
// every output element has one writer, so runs agree bitwise. Loads are
// plain 16-byte loads; cp.async/TMA pipelining and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 128;        // widest head_dim; narrower heads are padded
constexpr int BT = 64;         // rows per tile, both sequence axes
constexpr int NTHREADS = 128;  // 4 warps, 16 rows each
constexpr int LDH = HD + 8;    // bf16 [64][HD] tile row stride (elements)
constexpr int LDF = BT + 4;    // fp32 [64][64] tile row stride
constexpr int LDB = BT + 8;    // bf16 [64][64] tile row stride
constexpr int LDO = HD + 4;    // fp32 [64][HD] tile row stride
constexpr float NEG_INF = -2.3819763e38f;  // the reference's mask value

constexpr size_t TILE_H = size_t(BT) * LDH * sizeof(bf16);
constexpr size_t TILE_F = size_t(BT) * LDF * sizeof(float);
constexpr size_t TILE_B = size_t(BT) * LDB * sizeof(bf16);
constexpr size_t TILE_O = size_t(BT) * LDO * sizeof(float);
constexpr size_t ROWS = size_t(BT) * 4 * sizeof(float);  // 4 per-row arrays
constexpr size_t SMEM_FWD = 3 * TILE_H + TILE_F + TILE_B + TILE_O + ROWS;
constexpr size_t SMEM_DKV = 4 * TILE_H + 2 * TILE_F + 2 * TILE_B + ROWS;
constexpr size_t SMEM_DQ = 4 * TILE_H + 2 * TILE_F + TILE_B + ROWS;
static_assert(TILE_O <= 2 * TILE_F, "dK/dV/dQ staging reuses two fp32 tiles");

struct Shape {
  int T, S, H, D, causal, q_offset, use_seg;
  float scale;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ARow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BCol;

// rows [row0, row0 + 64) of one head (row r at src + r * row_stride) into a
// [64][LDH] tile; rows >= n and columns >= D are zero
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int n, int row_stride,
                                          int D) {
  for (int c = threadIdx.x; c < BT * (HD / 8); c += NTHREADS) {
    const int r = c / (HD / 8);
    const int col = (c % (HD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && col < D)
      val = *reinterpret_cast<const uint4*>(
          src + size_t(row0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * LDH + col) = val;
  }
}

// out[16][64] (fp32, stride ldo) = A[16][HD] . Bm[64][HD]^T, both bf16
// tiles of stride LDH
__device__ __forceinline__ void mm_abt(float* out, int ldo, const bf16* A,
                                       const bf16* Bm) {
  Acc acc[BT / 16];
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    ARow a;
    wmma::load_matrix_sync(a, A + kk, LDH);
#pragma unroll
    for (int j = 0; j < BT / 16; ++j) {
      // B = Bm^T: element (d, j) sits at Bm[j * LDH + d] (column-major)
      BCol b;
      wmma::load_matrix_sync(b, Bm + j * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BT / 16; ++j)
    wmma::store_matrix_sync(out + j * 16, acc[j], ldo, wmma::mem_row_major);
}

// acc[16][HD] += A[16][64] (bf16, stride LDB) . Bm[64][HD] (stride LDH)
__device__ __forceinline__ void mm_acc(Acc (&acc)[HD / 16], const bf16* A,
                                       const bf16* Bm) {
#pragma unroll
  for (int kq = 0; kq < BT / 16; ++kq) {
    ARow a;
    wmma::load_matrix_sync(a, A + kq * 16, LDB);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      BRow b;
      wmma::load_matrix_sync(b, Bm + kq * 16 * LDH + j * 16, LDH);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// segment id of row r of a [B, n] plane, or 0 without segments / past n
__device__ __forceinline__ int seg_at(const int* seg, int b, int n, int r) {
  return (seg != nullptr && r < n) ? seg[size_t(b) * n + r] : 0;
}

// the accumulators of this warp's 16 rows of the tile starting at row0 →
// bf16 rows of one head, through the warp's part of a [64][LDO] fp32
// staging tile
__device__ __forceinline__ void store_rows(Acc (&acc)[HD / 16], float* stage,
                                           bf16* dst, int row0, int n,
                                           int row_stride, int D) {
  const int warp = threadIdx.x >> 5;
  float* mine = stage + warp * 16 * LDO;
#pragma unroll
  for (int j = 0; j < HD / 16; ++j)
    wmma::store_matrix_sync(mine + j * 16, acc[j], LDO, wmma::mem_row_major);
  __syncwarp();
  const int r = threadIdx.x >> 1;  // a row of this warp's strip
  const int half = threadIdx.x & 1;
  if (row0 + r < n) {
    const float* src = stage + r * LDO + half * 64;
    bf16* out = dst + size_t(row0 + r) * row_stride + half * 64;
    for (int c = 0; c < 64 && half * 64 + c < D; c += 2)
      *reinterpret_cast<__nv_bfloat162*>(out + c) =
          __floats2bfloat162_rn(src[c], src[c + 1]);
  }
  __syncwarp();
}

// last key a query tile [q0, q0 + 64) can see, + 1
__device__ __forceinline__ int key_end(const Shape& sh, int q0) {
  int kend = sh.S;
  if (sh.causal) {
    const int last_t = min(q0 + BT, sh.T) - 1;
    kend = min(kend, last_t + sh.q_offset + 1);
  }
  return max(kend, 0);
}

__device__ __forceinline__ bool visible(const Shape& sh, int t, int s,
                                        int qs, int ks) {
  return t < sh.T && s < sh.S && (!sh.causal || t + sh.q_offset >= s) &&
         (!sh.use_seg || qs == ks);
}

__global__ void __launch_bounds__(NTHREADS)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const int* __restrict__ q_seg,
           const int* __restrict__ kv_seg, bf16* __restrict__ out,
           float* __restrict__ lse, Shape sh) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BT * LDH;
  bf16* sV = sK + BT * LDH;
  float* sS = reinterpret_cast<float*>(sV + BT * LDH);
  bf16* sP = reinterpret_cast<bf16*>(sS + BT * LDF);
  float* sO = reinterpret_cast<float*>(sP + BT * LDB);
  float* sM = sO + BT * LDO;
  float* sL = sM + BT;
  int* sQs = reinterpret_cast<int*>(sL + BT);
  int* sKs = sQs + BT;

  const int bh = blockIdx.y;
  const int b = bh / sh.H, h = bh % sh.H;
  const int q0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int rs = sh.H * sh.D;  // sequence stride of [B, L, H, D]
  const size_t qh = (size_t(b) * sh.T * sh.H + h) * sh.D;
  const size_t kh = (size_t(b) * sh.S * sh.H + h) * sh.D;

  load_rows(sQ, q + qh, q0, sh.T, rs, sh.D);
  for (int i = tid; i < BT * LDO; i += NTHREADS) sO[i] = 0.f;
  if (tid < BT) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
    sQs[tid] = seg_at(q_seg, b, sh.T, q0 + tid);
  }
  const int kend = key_end(sh, q0);
  __syncthreads();

  // softmax ownership: thread -> (row tid/2, 32-column half tid&1); the row
  // lies in the strip of the thread's own warp
  const int srow = tid >> 1;
  const int shalf = tid & 1;
  const int t = q0 + srow;

  for (int kb = 0; kb < kend; kb += BT) {
    load_rows(sK, k + kh, kb, sh.S, rs, sh.D);
    load_rows(sV, v + kh, kb, sh.S, rs, sh.D);
    if (tid < BT) sKs[tid] = seg_at(kv_seg, b, sh.S, kb + tid);
    __syncthreads();

    mm_abt(sS + warp * 16 * LDF, LDF, sQ + warp * 16 * LDH, sK);
    __syncwarp();

    {
      const float* srow_s = sS + srow * LDF + shalf * 32;
      bf16* prow = sP + srow * LDB + shalf * 32;
      const int c0 = shalf * 32;
      float mx = NEG_INF;
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        if (visible(sh, t, kb + c0 + c, sQs[srow], sKs[c0 + c]))
          mx = fmaxf(mx, srow_s[c] * sh.scale);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sM[srow];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        float p = 0.f;
        if (visible(sh, t, kb + c0 + c, sQs[srow], sKs[c0 + c]))
          p = expf(srow_s[c] * sh.scale - m_new);
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = expf(m_old - m_new);
      float* orow = sO + srow * LDO + shalf * 64;
#pragma unroll 8
      for (int c = 0; c < 64; ++c) orow[c] *= alpha;
      __syncwarp();
      if (shalf == 0) {
        sM[srow] = m_new;
        sL[srow] = sL[srow] * alpha + sum;
      }
    }
    __syncwarp();

    // O[strip] += P[strip] . V
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      Acc o;
      float* optr = sO + warp * 16 * LDO + j * 16;
      wmma::load_matrix_sync(o, optr, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kq = 0; kq < BT / 16; ++kq) {
        ARow a;
        wmma::load_matrix_sync(a, sP + warp * 16 * LDB + kq * 16, LDB);
        BRow vb;
        wmma::load_matrix_sync(vb, sV + kq * 16 * LDH + j * 16, LDH);
        wmma::mma_sync(o, a, vb, o);
      }
      wmma::store_matrix_sync(optr, o, LDO, wmma::mem_row_major);
    }
    __syncthreads();  // every warp is done with sK/sV before the next load
  }
  __syncwarp();

  if (t < sh.T) {
    const float l = fmaxf(sL[srow], 1e-30f);
    const float* orow = sO + srow * LDO + shalf * 64;
    bf16* dst = out + qh + size_t(t) * rs + shalf * 64;
    for (int c = 0; c < 64 && shalf * 64 + c < sh.D; c += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + c) =
          __floats2bfloat162_rn(orow[c] / l, orow[c + 1] / l);
    if (shalf == 0) lse[size_t(bh) * sh.T + t] = sM[srow] + logf(l);
  }
}

// the per-row lse / delta / segment of q rows [q0, q0 + 64) into shared
__device__ __forceinline__ void load_q_rows(float* sLse, float* sDel,
                                            int* sQs, const float* lse,
                                            const float* delta,
                                            const int* q_seg, int b, int bh,
                                            int q0, const Shape& sh) {
  const int tid = threadIdx.x;
  if (tid < BT) {
    const int t = q0 + tid;
    const bool live = t < sh.T;
    sLse[tid] = live ? lse[size_t(bh) * sh.T + t] : 0.f;
    sDel[tid] = live ? delta[size_t(bh) * sh.T + t] : 0.f;
    sQs[tid] = seg_at(q_seg, b, sh.T, t);
  }
}

__global__ void __launch_bounds__(NTHREADS)
bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, const int* __restrict__ q_seg,
               const int* __restrict__ kv_seg, bf16* __restrict__ dk,
               bf16* __restrict__ dv, Shape sh) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BT * LDH;
  bf16* sQ = sV + BT * LDH;
  bf16* sdO = sQ + BT * LDH;
  float* sS = reinterpret_cast<float*>(sdO + BT * LDH);  // S^T [key][q]
  float* sdP = sS + BT * LDF;                            // dP^T [key][q]
  bf16* sPt = reinterpret_cast<bf16*>(sdP + BT * LDF);
  bf16* sdSt = sPt + BT * LDB;
  float* sLse = reinterpret_cast<float*>(sdSt + BT * LDB);
  float* sDel = sLse + BT;
  int* sQs = reinterpret_cast<int*>(sDel + BT);
  int* sKs = sQs + BT;

  const int bh = blockIdx.y;
  const int b = bh / sh.H, h = bh % sh.H;
  const int k0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int rs = sh.H * sh.D;
  const size_t qh = (size_t(b) * sh.T * sh.H + h) * sh.D;
  const size_t kh = (size_t(b) * sh.S * sh.H + h) * sh.D;

  load_rows(sK, k + kh, k0, sh.S, rs, sh.D);
  load_rows(sV, v + kh, k0, sh.S, rs, sh.D);
  if (tid < BT) sKs[tid] = seg_at(kv_seg, b, sh.S, k0 + tid);

  Acc dk_acc[HD / 16], dv_acc[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }
  // the first q tile with a row that can see key k0
  int qstart = 0;
  if (sh.causal) qstart = max(0, k0 - sh.q_offset) / BT * BT;

  // elementwise ownership: thread -> (key row tid/2 of its warp's strip,
  // 32 query columns tid&1)
  const int krow = tid >> 1;
  const int khalf = tid & 1;
  const int s = k0 + krow;

  for (int qb = qstart; qb < sh.T; qb += BT) {
    __syncthreads();  // the previous tile's readers of sQ/sdO are done
    load_rows(sQ, q + qh, qb, sh.T, rs, sh.D);
    load_rows(sdO, dout + qh, qb, sh.T, rs, sh.D);
    load_q_rows(sLse, sDel, sQs, lse, delta, q_seg, b, bh, qb, sh);
    __syncthreads();

    mm_abt(sS + warp * 16 * LDF, LDF, sK + warp * 16 * LDH, sQ);
    mm_abt(sdP + warp * 16 * LDF, LDF, sV + warp * 16 * LDH, sdO);
    __syncwarp();
    {
      const int c0 = khalf * 32;
      const float* srow_s = sS + krow * LDF + c0;
      const float* drow = sdP + krow * LDF + c0;
      bf16* prow = sPt + krow * LDB + c0;
      bf16* dsrow = sdSt + krow * LDB + c0;
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const int cc = c0 + c;
        float p = 0.f;
        if (visible(sh, qb + cc, s, sQs[cc], sKs[krow]))
          p = expf(srow_s[c] * sh.scale - sLse[cc]);
        prow[c] = __float2bfloat16(p);
        dsrow[c] = __float2bfloat16(p * (drow[c] - sDel[cc]) * sh.scale);
      }
    }
    __syncwarp();
    mm_acc(dv_acc, sPt + warp * 16 * LDB, sdO);
    mm_acc(dk_acc, sdSt + warp * 16 * LDB, sQ);
  }
  __syncthreads();  // sS/sdP become the staging tile
  store_rows(dk_acc, sS, dk + kh, k0, sh.S, rs, sh.D);
  store_rows(dv_acc, sS, dv + kh, k0, sh.S, rs, sh.D);
}

__global__ void __launch_bounds__(NTHREADS)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
              bf16* __restrict__ dq, Shape sh) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BT * LDH;
  bf16* sK = sdO + BT * LDH;
  bf16* sV = sK + BT * LDH;
  float* sS = reinterpret_cast<float*>(sV + BT * LDH);
  float* sdP = sS + BT * LDF;
  bf16* sdS = reinterpret_cast<bf16*>(sdP + BT * LDF);
  float* sLse = reinterpret_cast<float*>(sdS + BT * LDB);
  float* sDel = sLse + BT;
  int* sQs = reinterpret_cast<int*>(sDel + BT);
  int* sKs = sQs + BT;

  const int bh = blockIdx.y;
  const int b = bh / sh.H, h = bh % sh.H;
  const int q0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int rs = sh.H * sh.D;
  const size_t qh = (size_t(b) * sh.T * sh.H + h) * sh.D;
  const size_t kh = (size_t(b) * sh.S * sh.H + h) * sh.D;

  load_rows(sQ, q + qh, q0, sh.T, rs, sh.D);
  load_rows(sdO, dout + qh, q0, sh.T, rs, sh.D);
  load_q_rows(sLse, sDel, sQs, lse, delta, q_seg, b, bh, q0, sh);
  const int kend = key_end(sh, q0);

  Acc dq_acc[HD / 16];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) wmma::fill_fragment(dq_acc[j], 0.f);

  const int qrow = tid >> 1;
  const int qhalf = tid & 1;
  const int t = q0 + qrow;

  for (int kb = 0; kb < kend; kb += BT) {
    __syncthreads();  // the previous tile's readers of sK/sV are done
    load_rows(sK, k + kh, kb, sh.S, rs, sh.D);
    load_rows(sV, v + kh, kb, sh.S, rs, sh.D);
    if (tid < BT) sKs[tid] = seg_at(kv_seg, b, sh.S, kb + tid);
    __syncthreads();

    mm_abt(sS + warp * 16 * LDF, LDF, sQ + warp * 16 * LDH, sK);
    mm_abt(sdP + warp * 16 * LDF, LDF, sdO + warp * 16 * LDH, sV);
    __syncwarp();
    {
      const int c0 = qhalf * 32;
      const float* srow_s = sS + qrow * LDF + c0;
      const float* drow = sdP + qrow * LDF + c0;
      bf16* dsrow = sdS + qrow * LDB + c0;
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        float p = 0.f;
        if (visible(sh, t, kb + c0 + c, sQs[qrow], sKs[c0 + c]))
          p = expf(srow_s[c] * sh.scale - sLse[qrow]);
        dsrow[c] = __float2bfloat16(p * (drow[c] - sDel[qrow]) * sh.scale);
      }
    }
    __syncwarp();
    mm_acc(dq_acc, sdS + warp * 16 * LDB, sK);
  }
  __syncthreads();  // sS/sdP become the staging tile
  store_rows(dq_acc, sS, dq + qh, q0, sh.T, rs, sh.D);
}

bool bad_shape(int B, int T, int S, int H, int D) {
  return B <= 0 || T <= 0 || S <= 0 || H <= 0 || D <= 0 || D > HD ||
         D % 16 != 0 || size_t(B) * H > 65535u;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace

// q [B, T, H, D], k/v [B, S, H, D] bf16 (KV heads already repeated);
// q_seg [B, T] / kv_seg [B, S] int32 or both null; out [B, T, H, D] bf16,
// lse [B, H, T] fp32
extern "C" int aurora_flash_fwd(const void* q, const void* k, const void* v,
                                const void* q_seg, const void* kv_seg,
                                void* out, void* lse, int B, int T, int S,
                                int H, int D, int causal, int q_offset,
                                float scale, void* stream) {
  if (bad_shape(B, T, S, H, D) || ((q_seg == nullptr) != (kv_seg == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(fwd_kernel, SMEM_FWD);
  if (err != cudaSuccess) return int(err);
  const Shape sh{T, S, H, D, causal, q_offset, q_seg != nullptr, scale};
  dim3 grid((T + BT - 1) / BT, B * H);
  fwd_kernel<<<grid, NTHREADS, SMEM_FWD, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<bf16*>(out),
      static_cast<float*>(lse), sh);
  return int(cudaGetLastError());
}

// dout like q; lse, delta [B, H, T] fp32; dk/dv like k
extern "C" int aurora_flash_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* q_seg, const void* kv_seg,
                                    void* dk, void* dv, int B, int T, int S,
                                    int H, int D, int causal, int q_offset,
                                    float scale, void* stream) {
  if (bad_shape(B, T, S, H, D) || ((q_seg == nullptr) != (kv_seg == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(bwd_dkv_kernel, SMEM_DKV);
  if (err != cudaSuccess) return int(err);
  const Shape sh{T, S, H, D, causal, q_offset, q_seg != nullptr, scale};
  dim3 grid((S + BT - 1) / BT, B * H);
  bwd_dkv_kernel<<<grid, NTHREADS, SMEM_DKV,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sh);
  return int(cudaGetLastError());
}

// dq like q
extern "C" int aurora_flash_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* q_seg, const void* kv_seg,
                                   void* dq, int B, int T, int S, int H,
                                   int D, int causal, int q_offset,
                                   float scale, void* stream) {
  if (bad_shape(B, T, S, H, D) || ((q_seg == nullptr) != (kv_seg == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(bwd_dq_kernel, SMEM_DQ);
  if (err != cudaSuccess) return int(err);
  const Shape sh{T, S, H, D, causal, q_offset, q_seg != nullptr, scale};
  dim3 grid((T + BT - 1) / BT, B * H);
  bwd_dq_kernel<<<grid, NTHREADS, SMEM_DQ,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
      static_cast<bf16*>(dq), sh);
  return int(cudaGetLastError());
}
