// Extend (prefill) attention over row-contiguous KV buffers, sm_90a: bf16
// KV, int8 KV with per-token fp32 scales, or nibble-packed int4 KV with the
// same scales.
//
// Replaces: aurora_tpu/ops/pallas/ragged_attention.py `ragged_attention`
// (Pallas kernel `_kernel`, its bf16, int8 `quant` and packed int4
// `kv_pack` modes). Contract:
// causal attention of each lane's T new queries (global positions
// q_offsets[i] + t) against KV row row_ids[i] of layer `layer` in
// k_rows/v_rows [L, B, Hkv, S, hd], reading only keys < kv_lens[i]; fp32
// online softmax; lanes with kv_lens == 0 and fully masked query rows
// produce zeros. In int8 mode the logits are multiplied by the key's scale
// after `scale` and before the mask, and the probabilities by the value's
// scale (after the row sum) before P·V, as the reference does; scales are
// the [L, B, Hkv, S] fp32 planes. In int4 mode the rows are [L, B, Hkv,
// S/2, hd] bytes: token seg*256 + j (j < 128) in the low nibble and token
// seg*256 + 128 + j in the high nibble of packed row seg*128 + j, each a
// signed 4-bit value (the grid is [-7, 7]); the scales stay token-space.
// Options of every mode, the reference's `window=` and `logit_cap=`: with
// window w > 0 a query at position p sees only the keys in (p - w, p];
// with cap c > 0 each logit x becomes c * tanhf(x * inv_c) (inv_c =
// fp32(1 / c), the multiply XLA makes of the reference's division by a
// constant) after the scale and the int8 key scale, before the mask.
// tanhf, not tanh.approx.f32, whose ~2^-11 relative error is larger than
// the twins' bounds.
//
// What bounds it on the H100: at the serving shape (T = 1536 new tokens
// against ~1.4k keys, hd = 128) every K/V tile is reused by 64 query rows,
// so the kernel does ~64 FLOP per KV byte: it is compute-bound, and the
// tensor cores are the resource that matters.
//
// Design: one block per (query tile of 64 folded rows, KV head, lane).
// GQA folds the G query heads of a KV head into the query-row axis as
// row = t * G + g, so one K/V tile load serves all G heads and the causal
// bound of a tile stays tight. QK^T and PV run on the tensor cores through
// WMMA bf16 16x16x16 fragments with fp32 accumulation; the scores, the
// probabilities and the output accumulator live in shared memory, where
// each warp rescales its own 16 rows for the online softmax. The loop over
// key tiles stops at min(kv_len, last query position + 1) and, with a
// window, starts at the tile that holds the block's first visible key,
// max(0, first query position - w + 1): tiles wholly below every row's
// window are neither loaded nor computed, and the keys of the first tiles
// that lie below a row's window are masked per element. int8 tiles are
// converted to bf16 as they are stored to shared memory (exact for
// |v| <= 127), so both modes share the tensor-core code; the tile's scales
// sit beside it in shared memory. In int4 mode a key tile is 32 packed
// rows read once: their low nibbles become tile keys 0-31 (positions
// base + [0, 32)) and their high nibbles tile keys 32-63 (base + 128 +
// [0, 32)), so each softmax thread's half of a tile row is one contiguous
// run of positions; both nibbles are sign-extended on the way to bf16
// (exact). Loads are plain 16-byte loads; cp.async/TMA pipelining and
// wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 128;        // head_dim taken by this kernel
constexpr int BQ = 64;         // folded query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps, 16 query rows each
constexpr int LDH = HD + 8;    // bf16 Q/K/V tile row stride (elements)
constexpr int LDS = BK + 4;    // fp32 score tile row stride
constexpr int LDP = BK + 8;    // bf16 probability tile row stride
constexpr int LDO = HD + 4;    // fp32 output accumulator row stride
constexpr float NEG = -1e30f;

constexpr size_t SMEM_Q = size_t(BQ) * LDH * sizeof(bf16);
constexpr size_t SMEM_KV = size_t(BK) * LDH * sizeof(bf16);
constexpr size_t SMEM_S = size_t(BQ) * LDS * sizeof(float);
constexpr size_t SMEM_P = size_t(BQ) * LDP * sizeof(bf16);
constexpr size_t SMEM_O = size_t(BQ) * LDO * sizeof(float);
constexpr size_t SMEM_ROW = size_t(BQ) * 3 * sizeof(float);
constexpr size_t SMEM_SC = size_t(2) * BK * sizeof(float);
constexpr size_t SMEM_TOTAL =
    SMEM_Q + 2 * SMEM_KV + SMEM_S + SMEM_P + SMEM_O + SMEM_ROW + SMEM_SC;

// one tile row chunk of K or V into shared memory as bf16: 8 values of a
// bf16 row, or 16 values of an int8 row (two 16-byte stores)
__device__ __forceinline__ void stage(const bf16* src, bf16* dst, bool live) {
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (live) val = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<uint4*>(dst) = val;
}
// int8 → float without a conversion instruction: the byte, biased to
// b + 128 (xor 0x80), goes into the low mantissa bits of 2^23 and
// 2^23 + 128 is subtracted; exact for every int8. Such a float has at
// most 8 significant bits, so its high 16 bits are its exact bf16.
// `mul` rescales it exactly (a power of two).
__device__ __forceinline__ unsigned s8_to_f_bits(unsigned biased, int i,
                                                 float mul = 1.f) {
  return __float_as_uint(
      (__int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + i)) -
       8388736.f) * mul);
}
// four biased bytes → two bf16 pairs, the lower-addressed value in the low
// half of each
__device__ __forceinline__ void bf16x4(unsigned biased, float mul,
                                       unsigned* w) {
  w[0] = __byte_perm(s8_to_f_bits(biased, 0, mul),
                     s8_to_f_bits(biased, 1, mul), 0x7632);
  w[1] = __byte_perm(s8_to_f_bits(biased, 2, mul),
                     s8_to_f_bits(biased, 3, mul), 0x7632);
}
__device__ __forceinline__ void stage(const int8_t* src, bf16* dst,
                                      bool live) {
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (live) val = *reinterpret_cast<const uint4*>(src);
  const unsigned in[4] = {val.x, val.y, val.z, val.w};
  unsigned w[8];  // bf16 pairs, the lower-addressed value in the low half
#pragma unroll
  for (int j = 0; j < 4; ++j) bf16x4(in[j] ^ 0x80808080u, 1.f, w + 2 * j);
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}
// int4: 16 bytes of one packed row → its 16 low-nibble values to dst_lo
// and its 16 high-nibble values to dst_hi. (w << 4) & 0xF0F0F0F0 holds
// 16 * each low nibble as a signed byte, w & 0xF0F0F0F0 16 * each high
// one; the 1/16 is exact.
__device__ __forceinline__ void stage4(const int8_t* src, bf16* dst_lo,
                                       bf16* dst_hi, bool live_lo,
                                       bool live_hi) {
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (live_lo || live_hi) val = *reinterpret_cast<const uint4*>(src);
  const unsigned in[4] = {val.x, val.y, val.z, val.w};
  unsigned lo[8], hi[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bf16x4(((in[j] << 4) & 0xF0F0F0F0u) ^ 0x80808080u, 0.0625f, lo + 2 * j);
    bf16x4((in[j] & 0xF0F0F0F0u) ^ 0x80808080u, 0.0625f, hi + 2 * j);
  }
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  reinterpret_cast<uint4*>(dst_lo)[0] =
      live_lo ? make_uint4(lo[0], lo[1], lo[2], lo[3]) : z;
  reinterpret_cast<uint4*>(dst_lo)[1] =
      live_lo ? make_uint4(lo[4], lo[5], lo[6], lo[7]) : z;
  reinterpret_cast<uint4*>(dst_hi)[0] =
      live_hi ? make_uint4(hi[0], hi[1], hi[2], hi[3]) : z;
  reinterpret_cast<uint4*>(dst_hi)[1] =
      live_hi ? make_uint4(hi[4], hi[5], hi[6], hi[7]) : z;
}

// int4 tiles: tile `it` covers packed rows seg*128 + h*32 + [0, 32) of
// segment seg = it / 4, h = it % 4, i.e. positions base + [0, 32) (low
// nibbles) and base + 128 + [0, 32) (high nibbles), base = seg*256 + h*32
__device__ __forceinline__ int tile_base(int it, bool pack) {
  return pack ? (it >> 2) * 256 + (it & 3) * 32 : it * BK;
}
// the first tile that can hold key position s: packed rows skip whole
// 256-token segments only, since a tile pairs the low keys base + [0, 32)
// with the high keys base + 128 + [0, 32), and s may sit in either plane
__device__ __forceinline__ int first_tile(int s, bool pack) {
  return pack ? (s >> 8) * 4 : s / BK;
}
// position of tile key c (c < BK)
__device__ __forceinline__ int tile_pos(int base, int c, bool pack) {
  return base + c + (pack && c >= BK / 2 ? 128 - BK / 2 : 0);
}

template <typename KV, bool PACK>
__global__ void __launch_bounds__(NTHREADS)
extend_kernel(const bf16* __restrict__ q, const KV* __restrict__ k_rows,
              const KV* __restrict__ v_rows,
              const float* __restrict__ k_scales,
              const float* __restrict__ v_scales, bf16* __restrict__ out,
              const int* __restrict__ kv_lens,
              const int* __restrict__ q_offsets,
              const int* __restrict__ row_ids,
              const int* __restrict__ layer_ptr, int T, int Hq, int Hkv,
              int B, int S, float scale, int window, float cap,
              float inv_cap) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int CW = 16 / sizeof(KV);  // values per 16-byte global load
  static_assert(!PACK || QUANT, "packed rows are int8 bytes");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDH;
  bf16* sV = sK + BK * LDH;
  float* sS = reinterpret_cast<float*>(sV + BK * LDH);
  bf16* sP = reinterpret_cast<bf16*>(sS + BQ * LDS);
  float* sO = reinterpret_cast<float*>(sP + BQ * LDP);
  float* sM = sO + BQ * LDO;
  float* sL = sM + BQ;
  float* sKs = sL + 2 * BQ;  // after sM, sL and one spare row of floats
  float* sVs = sKs + BK;

  const int qt = blockIdx.x;
  const int kvh = blockIdx.y;
  const int lane_b = blockIdx.z;
  const int G = Hq / Hkv;
  const int rows_total = G * T;
  const int r0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  const int kv_len = min(kv_lens[lane_b], S);
  const int q_off = q_offsets[lane_b];
  const int row = row_ids[lane_b];
  const int layer = *layer_ptr;
  const size_t stripe = (size_t(layer) * B + row) * Hkv + kvh;
  const size_t row_elems = size_t(PACK ? S / 2 : S) * HD;
  const KV* Kp = k_rows + stripe * row_elems;
  const KV* Vp = v_rows + stripe * row_elems;

  // Q tile: BQ folded rows x HD, 16-byte chunks; padded rows are zero
  for (int c = tid; c < BQ * (HD / 8); c += NTHREADS) {
    const int r = c / (HD / 8);
    const int col = (c % (HD / 8)) * 8;
    const int rr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rr < rows_total) {
      const int t = rr / G, g = rr % G;
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t(lane_b) * T + t) * Hq + kvh * G + g) * HD + col);
    }
    *reinterpret_cast<uint4*>(sQ + r * LDH + col) = val;
  }
  for (int i = tid; i < BQ * LDO; i += NTHREADS) sO[i] = 0.f;
  if (tid < BQ) {
    sM[tid] = NEG;
    sL[tid] = 0.f;
  }

  // causal bound of this tile: the last live row's position + 1; with a
  // window, the first row's first visible key
  const int last_rr = min(r0 + BQ, rows_total) - 1;
  int kend = 0;
  if (last_rr >= r0) kend = min(kv_len, q_off + last_rr / G + 1);
  const int kstart = window > 0 ? max(0, q_off + r0 / G - window + 1) : 0;
  __syncthreads();

  // softmax ownership: thread -> (row tid/2, 32-column half tid&1); the
  // row lies in the strip of the thread's own warp
  const int srow = tid >> 1;
  const int shalf = tid & 1;
  const int srr = r0 + srow;
  const int sqpos = srr < rows_total ? q_off + srr / G : -1;
  // keys at or below wlo lie outside the row's window
  const int wlo = window > 0 ? sqpos - window : -1;

  for (int it = first_tile(kstart, PACK);; ++it) {
    const int kb = tile_base(it, PACK);  // increases with it
    if (kb >= kend) break;
    if constexpr (PACK) {
      const int brow = (kb >> 8) * 128 + (kb & 255);  // first packed row
      for (int c = tid; c < (BK / 2) * (HD / 16); c += NTHREADS) {
        const int r = c / (HD / 16);
        const int col = (c % (HD / 16)) * 16;
        const size_t src = size_t(brow + r) * HD + col;
        const bool lo = kb + r < kend, hi = kb + 128 + r < kend;
        stage4(Kp + src, sK + r * LDH + col, sK + (BK / 2 + r) * LDH + col,
               lo, hi);
        stage4(Vp + src, sV + r * LDH + col, sV + (BK / 2 + r) * LDH + col,
               lo, hi);
      }
    } else {
      for (int c = tid; c < BK * (HD / CW); c += NTHREADS) {
        const int r = c / (HD / CW);
        const int col = (c % (HD / CW)) * CW;
        const int s = kb + r;
        stage(Kp + size_t(s) * HD + col, sK + r * LDH + col, s < kend);
        stage(Vp + size_t(s) * HD + col, sV + r * LDH + col, s < kend);
      }
    }
    if (QUANT && tid < BK) {
      const int s = tile_pos(kb, tid, PACK);
      sKs[tid] = s < kend ? k_scales[stripe * size_t(S) + s] : 0.f;
      sVs[tid] = s < kend ? v_scales[stripe * size_t(S) + s] : 0.f;
    }
    __syncthreads();

    // scores for this warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + warp * 16 * LDH + kk, LDH);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          // B = K^T: element (d, s) sits at sK[s * LDH + d] (column-major)
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              bfr;
          wmma::load_matrix_sync(bfr, sK + j * 16 * LDH + kk, LDH);
          wmma::mma_sync(acc[j], a, bfr, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(sS + warp * 16 * LDS + j * 16, acc[j], LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this thread's 32 columns of its row
    {
      const float* srow_s = sS + srow * LDS + shalf * 32;
      bf16* prow = sP + srow * LDP + shalf * 32;
      const float* ks = sKs + shalf * 32;
      const float* vs = sVs + shalf * 32;
      // this half's 32 keys sit at 32 consecutive positions from s0
      const int s0 = tile_pos(kb, shalf * 32, PACK);
      float lg[32];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        float x = srow_s[c] * scale;
        if (QUANT) x *= ks[c];
        if (cap > 0.f) x = cap * tanhf(x * inv_cap);
        lg[c] = x;
        const int s = s0 + c;
        if (s < kv_len && s <= sqpos && s > wlo) mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = sM[srow];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int s = s0 + c;
        float p = 0.f;
        if (s < kv_len && s <= sqpos && s > wlo) p = expf(lg[c] - m_new);
        sum += p;
        prow[c] = __float2bfloat16(QUANT ? p * vs[c] : p);
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

    // O[strip] += P[strip] @ V
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          pa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], sP + warp * 16 * LDP + kk * 16, LDP);
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        float* optr = sO + warp * 16 * LDO + j * 16;
        wmma::load_matrix_sync(o, optr, LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              vb;
          wmma::load_matrix_sync(vb, sV + kk * 16 * LDH + j * 16, LDH);
          wmma::mma_sync(o, pa[kk], vb, o);
        }
        wmma::store_matrix_sync(optr, o, LDO, wmma::mem_row_major);
      }
    }
    __syncthreads();  // every warp is done with sK/sV before the next load
  }
  __syncwarp();

  if (srr < rows_total) {
    const int t = srr / G, g = srr % G;
    const float inv = 1.f / fmaxf(sL[srow], 1e-30f);
    const float* orow = sO + srow * LDO + shalf * 64;
    bf16* dst = out + ((size_t(lane_b) * T + t) * Hq + kvh * G + g) * HD +
                shalf * 64;
#pragma unroll 8
    for (int c = 0; c < 64; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + c) =
          __floats2bfloat162_rn(orow[c] * inv, orow[c + 1] * inv);
    }
  }
}

template <typename KV, bool PACK>
int launch(const void* q, const void* k_rows, const void* v_rows,
           const void* k_scales, const void* v_scales, void* out,
           const void* kv_lens, const void* q_offsets, const void* row_ids,
           const void* layer, int Bk, int T, int Hq, int Hkv, int B, int S,
           int head_dim, float scale, int window, float cap, float inv_cap,
           void* stream) {
  if (head_dim != HD || Hkv <= 0 || Hq % Hkv != 0 || Bk <= 0 || T <= 0 ||
      (PACK && S % 256 != 0) || cap < 0.f)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      extend_kernel<KV, PACK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SMEM_TOTAL));
  if (err != cudaSuccess) return int(err);
  const int G = Hq / Hkv;
  dim3 grid((G * T + BQ - 1) / BQ, Hkv, Bk);
  extend_kernel<KV, PACK><<<grid, NTHREADS, SMEM_TOTAL,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(k_rows),
      static_cast<const KV*>(v_rows), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<bf16*>(out),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_offsets),
      static_cast<const int*>(row_ids), static_cast<const int*>(layer), T,
      Hq, Hkv, B, S, scale, window, cap, inv_cap);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int aurora_ragged_extend_bf16(
    const void* q, const void* k_rows, const void* v_rows, void* out,
    const void* kv_lens, const void* q_offsets, const void* row_ids,
    const void* layer, int Bk, int T, int Hq, int Hkv, int B, int S,
    int head_dim, float scale, int window, float cap, float inv_cap,
    void* stream) {
  return launch<bf16, false>(q, k_rows, v_rows, nullptr, nullptr, out,
                             kv_lens, q_offsets, row_ids, layer, Bk, T, Hq,
                             Hkv, B, S, head_dim, scale, window, cap, inv_cap,
                             stream);
}

// int8 rows [L, B, Hkv, S, hd] with fp32 scale planes [L, B, Hkv, S];
// q and out stay bf16
extern "C" int aurora_ragged_extend_int8(
    const void* q, const void* k_rows, const void* v_rows,
    const void* k_scales, const void* v_scales, void* out,
    const void* kv_lens, const void* q_offsets, const void* row_ids,
    const void* layer, int Bk, int T, int Hq, int Hkv, int B, int S,
    int head_dim, float scale, int window, float cap, float inv_cap,
    void* stream) {
  return launch<int8_t, false>(q, k_rows, v_rows, k_scales, v_scales, out,
                               kv_lens, q_offsets, row_ids, layer, Bk, T, Hq,
                               Hkv, B, S, head_dim, scale, window, cap,
                               inv_cap, stream);
}

// packed int4 rows [L, B, Hkv, S/2, hd] with fp32 scale planes
// [L, B, Hkv, S]; S is the token count (a multiple of 256)
extern "C" int aurora_ragged_extend_int4(
    const void* q, const void* k_rows, const void* v_rows,
    const void* k_scales, const void* v_scales, void* out,
    const void* kv_lens, const void* q_offsets, const void* row_ids,
    const void* layer, int Bk, int T, int Hq, int Hkv, int B, int S,
    int head_dim, float scale, int window, float cap, float inv_cap,
    void* stream) {
  return launch<int8_t, true>(q, k_rows, v_rows, k_scales, v_scales, out,
                              kv_lens, q_offsets, row_ids, layer, Bk, T, Hq,
                              Hkv, B, S, head_dim, scale, window, cap,
                              inv_cap, stream);
}
