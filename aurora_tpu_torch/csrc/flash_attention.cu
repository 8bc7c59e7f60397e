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
// D 128, causal) there are 2.69e8 visible (query, key) pairs; the forward
// does 2 D multiply-adds per pair (q.k and p.v), 1.375e11 FLOPs, against
// 0.27 GB of q, k, v and out: 0.139 ms at 989 TFLOP/s, 0.08 ms at 3.35
// TB/s. dK/dV does 4 D multiply-adds per pair, dQ 3 D. So all three are
// compute-bound, and only wgmma reaches the tensor cores' full rate.
//
// Design (hopper_common.cuh holds the building blocks): 256 threads a
// block, two warpgroups of 64 rows each, so ptxas may give a thread up to
// 255 registers (a third, producer warpgroup caps every thread at 168,
// and ptxas did not allocate past that for setmaxnreg: the dK/dV kernel,
// with 128 accumulator registers a thread for the whole loop, spilled).
// Tiles arrive by TMA (4-D maps over [B, L, H, D], boxes of 64 columns
// with the 128-byte swizzle; rows past T or S and columns past D arrive as
// zeros) into a ring of 3 stages, each with a full mbarrier; thread 0
// issues the first loads, and the last of the 8 warps to finish with a
// stage (a shared counter) refills it. Products are wgmma bf16 -> fp32
// with the accumulators in registers; a probability tile is converted to
// bf16 in registers and is the register A operand of the next product,
// its B operand the same shared tile read MN-major. Masking is decided per
// tile: only a tile that crosses the causal diagonal, the edge at T or S,
// or that has segment ids tests each element; key tiles past the causal
// limit are never loaded. Exponentials are exp2 with scale * log2(e)
// folded in.
// Forward: one block per (128-row q tile, b h), the heaviest causal tiles
// first; key tiles of 128; O, the row max and the row sum stay in
// registers for the whole key loop (the max is reduced over the 4 threads
// of a row by shuffles). Each warpgroup waits for its own products, and
// the other warpgroup's products fill the tensor cores meanwhile: FA3's
// software pipeline (the scores of tile j beside P V of tile j - 1) and its
// ping-pong of the two warpgroups, measured on the card, were slower
// (ptxas serialized the pipelined products). dK/dV: one block per
// (128-key tile, b h), each warpgroup owning 64 keys, looping over the
// 64-row q tiles that can see them; S^T = K Q^T and dP^T = V dO^T into
// registers as two wgmma groups (P^T forms while dP^T is computed), then
// dV += P^T dO and dK += dS^T Q; lse, delta and the segment ids of each q
// tile ride in the ring beside it. dQ: one block per (128-row q tile,
// b h), key tiles of 64, the same two groups, dQ in registers. No atomics
// on the outputs: every output element has one writer, so runs agree
// bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include "hopper_common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 128;        // widest head_dim; narrower heads read zeros
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int WARPS = NTHREADS / 32;
constexpr int STAGES = 3;
constexpr uint32_t BOX64 = 64 * 128;    // bytes of a [64][64] bf16 box
constexpr uint32_t BOX128 = 128 * 128;  // bytes of a [128][64] bf16 box
constexpr float NEG_INF = -2.3819763e38f;  // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 1024 bytes of alignment slack, the tiles loaded once, the ring's stages
// (two head-wide tiles each: K and V, or Q and dO), [dK/dV: 64 rows each of
// lse * log2(e), delta and q segment ids a stage], then the barriers and
// the counters
constexpr size_t RING = 8 * (1 + STAGES) + 4 * STAGES;
constexpr size_t SMEM_FWD = 1024 + 2 * BOX128 + STAGES * 4 * BOX128 + RING;
constexpr size_t SMEM_DKV =
    1024 + 4 * BOX128 + STAGES * 4 * BOX64 + STAGES * 192 * 4 + RING;
constexpr size_t SMEM_DQ = 1024 + 4 * BOX128 + STAGES * 4 * BOX64 + RING;

struct Shape {
  int T, S, H, D, causal, q_offset, use_seg;
  float scale;
};

// last key a q tile [q0, q0 + rows) can see, + 1
__device__ __forceinline__ int key_end(const Shape& sh, int q0, int rows) {
  int kend = sh.S;
  if (sh.causal) kend = min(kend, min(q0 + rows, sh.T) + sh.q_offset);
  return max(kend, 0);
}

// both 64-column boxes of a tile of rows [row0, row0 + box rows)
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int head, int row0,
                                          int b, uint32_t box_bytes) {
  hopper::tma_load_4d(dst, map, bar, 0, head, row0, b);
  hopper::tma_load_4d(dst + box_bytes, map, bar, 64, head, row0, b);
}

// tiles j of two maps (rows [j rows, (j + 1) rows)) into ring stage st;
// one thread
__device__ __forceinline__ void fill_pair(uint8_t* ring, uint64_t* full,
                                          int st, int j,
                                          const CUtensorMap* a,
                                          const CUtensorMap* b_map, int head,
                                          int b, int rows, uint32_t box) {
  uint8_t* dst = ring + st * 4 * box;
  hopper::mbar_expect_tx(&full[st], 4 * box);
  load_tile(dst, a, &full[st], head, j * rows, b, box);
  load_tile(dst + 2 * box, b_map, &full[st], head, j * rows, b, box);
}

// offset of k16 step kk of a head-wide K-major operand whose boxes are
// box_bytes apart
__device__ __forceinline__ uint32_t k_step(int kk, uint32_t box_bytes) {
  return (kk / 4) * box_bytes + (kk % 4) * 32;
}

// element i of an m64nN accumulator: row half (0: the thread's first row,
// 1: that row + 8) and column
__device__ __forceinline__ int acc_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
}

// bf16 row of an m64n128 accumulator (the thread's columns) to dst
__device__ __forceinline__ void store_row(bf16* dst, const float (&acc)[64],
                                          int half, int lane, int D,
                                          float mul) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (col < D)
      *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
  }
}

// bar[0]: the tiles loaded once; bar[1 + s]: stage s is full (full_count
// arrivals and the TMA bytes); done[s]: warps finished with stage s
__device__ __forceinline__ void init_ring(uint64_t* bar, int* done,
                                          uint32_t full_count) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(bar + 1 + s, full_count);
      done[s] = 0;
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// a warp is done with stage st (its products on it have completed) → true
// in every lane of the warp that completes the stage, which then refills
// it
__device__ __forceinline__ bool release(int* done, int st) {
  __syncwarp();
  int last = 0;
  if (threadIdx.x % 32 == 0) {
    __threadfence_block();
    last = atomicAdd(&done[st], 1) == WARPS - 1;
    if (last) done[st] = 0;
  }
  return __shfl_sync(0xffffffffu, last, 0);
}

// the scores of key tile [k0, k0 + 128) → probabilities in place (exp2 of
// s c - m, 0 off the visible pairs), the running max m and sum l of the
// thread's two rows updated, alpha = the factor that rescales their O; a
// row's 4 threads agree on its max through the quad shuffles
__device__ __forceinline__ void online_softmax(
    float (&s)[64], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const Shape& sh, float c, int q0w, int t0, int k0, int lane,
    const int (&qs)[2], const int* kv_seg, int b) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] *= c;
  if (sh.use_seg || k0 + 128 > sh.S ||
      (sh.causal && k0 + 127 > q0w + sh.q_offset)) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int t = t0 + 8 * acc_half(i);
      const int key = k0 + acc_col(i, lane);
      const bool vis =
          key < sh.S && (!sh.causal || t + sh.q_offset >= key) &&
          (!sh.use_seg || qs[acc_half(i)] == kv_seg[size_t(b) * sh.S + key]);
      if (!vis) s[i] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[acc_half(i)] = fmaxf(mx[acc_half(i)], s[i]);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    alpha[hf] = exp2f(m[hf] - mx[hf]);
    m[hf] = mx[hf];
    l[hf] *= alpha[hf];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = exp2f(s[i] - m[acc_half(i)]);
    l[acc_half(i)] += s[i];
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, bf16* __restrict__ out,
                 float* __restrict__ lse, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = hopper::align1024(smem_raw);
  uint8_t* sKV = sQ + 2 * BOX128;  // stage st: K, then V, 2 boxes each
  uint64_t* bar = reinterpret_cast<uint64_t*>(sKV + STAGES * 4 * BOX128);
  uint64_t* full = bar + 1;
  int* done = reinterpret_cast<int*>(bar + 1 + STAGES);

  const int bh = blockIdx.y;
  const int b = bh / sh.H, head = bh % sh.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 128;  // heaviest tiles first
  const int ntiles = (key_end(sh, q0, 128) + 127) / 128;
  init_ring(bar, done, 1);
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(bar, 2 * BOX128);
    load_tile(sQ, &tm_q, bar, head, q0, b, BOX128);
    for (int j = 0; j < min(STAGES, ntiles); ++j)
      fill_pair(sKV, full, j, j, &tm_k, &tm_v, head, b, 128, BOX128);
  }

  const int cw = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int q0w = q0 + 64 * cw;
  const int t0 = q0w + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const float c = sh.scale * LOG2E;
  int qs[2] = {0, 0};
  if (sh.use_seg) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (t0 + 8 * hf < sh.T) qs[hf] = q_seg[size_t(b) * sh.T + t0 + 8 * hf];
  }
  float o[64], s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  hopper::mbar_wait(bar, 0);
  const uint64_t dq = hopper::desc_k(sQ + cw * 64 * 128);
  uint32_t pa[8][4];  // P as bf16 register operands
  float alpha[2];
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    uint8_t* sK = sKV + st * 4 * BOX128;
    hopper::mbar_wait(&full[st], (j / STAGES) & 1);

    // S = Q K^T, the warpgroup's 64 rows x 128 keys
    const uint64_t dk = hopper::desc_k(sK);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::mma_64x128_ss(s, hopper::desc_add(dq, k_step(kk, BOX128)),
                            hopper::desc_add(dk, k_step(kk, BOX128)), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    online_softmax(s, m, l, alpha, sh, c, q0w, t0, j * 128, lane, qs, kv_seg,
                   b);
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= alpha[acc_half(i)];

    // O += P V
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) hopper::acc_to_a(s, kk, pa[kk]);
    const uint64_t dv = hopper::desc_mn(sK + 2 * BOX128, BOX128);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 128 / 16; ++kk)
      hopper::mma_64x128_rs(o, pa[kk], hopper::desc_add(dv, kk * 2048));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (release(done, st) && lane == 0 && j + STAGES < ntiles)
      fill_pair(sKV, full, st, j + STAGES, &tm_k, &tm_v, head, b, 128,
                BOX128);
  }

  const int rs = sh.H * sh.D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const int t = t0 + 8 * hf;
    if (t < sh.T) {
      const float lc = fmaxf(l[hf], 1e-30f);
      store_row(out + (size_t(b) * sh.T + t) * rs + size_t(head) * sh.D, o,
                hf, lane, sh.D, 1.f / lc);
      if (lane % 4 == 0)
        lse[size_t(bh) * sh.T + t] =
            m[hf] == NEG_INF ? NEG_INF : m[hf] * LN2 + logf(lc);
    }
  }
}

// q tile j of the dK/dV loop (rows [qb, qb + 64)) into ring stage st, by
// one whole warp: its lanes write the tile's lse * log2(e), delta and q
// segment ids (0 past T) and arrive, lane 0 loads Q and dO
__device__ __forceinline__ void fill_q_tile(
    uint8_t* ring, float* rows, uint64_t* full, int st, int qb,
    const CUtensorMap* tm_q, const CUtensorMap* tm_do, const float* lse,
    const float* delta, const int* q_seg, int b, int bh, int head,
    const Shape& sh) {
  const int lane = threadIdx.x % 32;
  float* rv = rows + st * 192;
  for (int r = lane; r < 64; r += 32) {
    const bool live = qb + r < sh.T;
    rv[r] = live ? lse[size_t(bh) * sh.T + qb + r] * LOG2E : 0.f;
    rv[64 + r] = live ? delta[size_t(bh) * sh.T + qb + r] : 0.f;
    reinterpret_cast<int*>(rv)[128 + r] =
        live && sh.use_seg ? q_seg[size_t(b) * sh.T + qb + r] : 0;
  }
  if (lane == 0) {
    uint8_t* dst = ring + st * 4 * BOX64;
    hopper::mbar_expect_tx(&full[st], 4 * BOX64);
    load_tile(dst, tm_q, &full[st], head, qb, b, BOX64);
    load_tile(dst + 2 * BOX64, tm_do, &full[st], head, qb, b, BOX64);
  } else {
    hopper::mbar_arrive(&full[st]);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = hopper::align1024(smem_raw);
  uint8_t* sV = sK + 2 * BOX128;
  uint8_t* sQd = sV + 2 * BOX128;  // stage st: Q, then dO, 2 boxes each
  float* rows = reinterpret_cast<float*>(sQd + STAGES * 4 * BOX64);
  uint64_t* bar = reinterpret_cast<uint64_t*>(rows + STAGES * 192);
  uint64_t* full = bar + 1;
  int* done = reinterpret_cast<int*>(bar + 1 + STAGES);

  const int bh = blockIdx.y;
  const int b = bh / sh.H, head = bh % sh.H;
  const int k0 = blockIdx.x * 128;
  // the first 64-row q tile with a row that can see key k0
  const int qstart = sh.causal ? max(0, k0 - sh.q_offset) / 64 * 64 : 0;
  const int ntiles = qstart < sh.T ? (sh.T - qstart + 63) / 64 : 0;
  init_ring(bar, done, 32);
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bar, 4 * BOX128);
      load_tile(sK, &tm_k, bar, head, k0, b, BOX128);
      load_tile(sV, &tm_v, bar, head, k0, b, BOX128);
    }
    for (int j = 0; j < min(STAGES, ntiles); ++j)
      fill_q_tile(sQd, rows, full, j, qstart + 64 * j, &tm_q, &tm_do, lse,
                  delta, q_seg, b, bh, head, sh);
  }

  const int cw = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int k0w = k0 + 64 * cw;
  const int s0 = k0w + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const float c = sh.scale * LOG2E;
  int ks[2] = {0, 0};
  if (sh.use_seg) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (s0 + 8 * hf < sh.S) ks[hf] = kv_seg[size_t(b) * sh.S + s0 + 8 * hf];
  }
  float dk_acc[64], dv_acc[64], st_acc[32], dp_acc[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hopper::mbar_wait(bar, 0);
  const uint64_t dK = hopper::desc_k(sK + cw * 64 * 128);
  const uint64_t dV = hopper::desc_k(sV + cw * 64 * 128);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    const int qb = qstart + 64 * j;
    uint8_t* sQ = sQd + st * 4 * BOX64;
    uint8_t* sdO = sQ + 2 * BOX64;
    const float* rv = rows + st * 192;
    hopper::mbar_wait(&full[st], (j / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, this warpgroup's 64 keys x 64 rows,
    // as two groups: P^T forms while dP^T is still in the tensor cores
    const uint64_t dQ = hopper::desc_k(sQ), dO = hopper::desc_k(sdO);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::mma_64x64_ss(st_acc, hopper::desc_add(dK, k_step(kk, BOX128)),
                           hopper::desc_add(dQ, k_step(kk, BOX64)), kk);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::mma_64x64_ss(dp_acc, hopper::desc_add(dV, k_step(kk, BOX128)),
                           hopper::desc_add(dO, k_step(kk, BOX64)), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(st_acc);

    // P^T = exp2(S^T c - lse log2 e), 0 off the visible pairs
    const bool masked = sh.use_seg || qb + 64 > sh.T || k0w + 64 > sh.S ||
                        (sh.causal && qb + sh.q_offset < k0w + 63);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = acc_col(i, lane);
      float p = exp2f(st_acc[i] * c - rv[col]);
      if (masked) {
        const int t = qb + col, key = s0 + 8 * acc_half(i);
        const bool vis =
            t < sh.T && key < sh.S && (!sh.causal || t + sh.q_offset >= key) &&
            (!sh.use_seg ||
             reinterpret_cast<const int*>(rv)[128 + col] == ks[acc_half(i)]);
        if (!vis) p = 0.f;
      }
      st_acc[i] = p;
    }
    uint32_t pa[4][4], da[4][4];  // bf16 A operands, 16 q rows each
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(st_acc, kk, pa[kk]);

    // dS^T = P^T (dP^T - delta) scale
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp_acc);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp_acc[i] =
          st_acc[i] * (dp_acc[i] - rv[64 + acc_col(i, lane)]) * sh.scale;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(dp_acc, kk, da[kk]);

    // dV += P^T dO, dK += dS^T Q
    const uint64_t mdO = hopper::desc_mn(sdO, BOX64);
    const uint64_t mQ = hopper::desc_mn(sQ, BOX64);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::mma_64x128_rs(dv_acc, pa[kk], hopper::desc_add(mdO, kk * 2048));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::mma_64x128_rs(dk_acc, da[kk], hopper::desc_add(mQ, kk * 2048));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    if (release(done, st) && j + STAGES < ntiles)
      fill_q_tile(sQd, rows, full, st, qb + 64 * STAGES, &tm_q, &tm_do, lse,
                  delta, q_seg, b, bh, head, sh);
  }

  const int rs = sh.H * sh.D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = s0 + 8 * hf;
    if (key < sh.S) {
      const size_t at = (size_t(b) * sh.S + key) * rs + size_t(head) * sh.D;
      store_row(dk + at, dk_acc, hf, lane, sh.D, 1.f);
      store_row(dv + at, dv_acc, hf, lane, sh.D, 1.f);
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, bf16* __restrict__ dq,
                    Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = hopper::align1024(smem_raw);
  uint8_t* sdO = sQ + 2 * BOX128;
  uint8_t* sKV = sdO + 2 * BOX128;  // stage st: K, then V, 2 boxes each
  uint64_t* bar = reinterpret_cast<uint64_t*>(sKV + STAGES * 4 * BOX64);
  uint64_t* full = bar + 1;
  int* done = reinterpret_cast<int*>(bar + 1 + STAGES);

  const int bh = blockIdx.y;
  const int b = bh / sh.H, head = bh % sh.H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 128;  // heaviest tiles first
  const int ntiles = (key_end(sh, q0, 128) + 63) / 64;
  init_ring(bar, done, 1);
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(bar, 4 * BOX128);
    load_tile(sQ, &tm_q, bar, head, q0, b, BOX128);
    load_tile(sdO, &tm_do, bar, head, q0, b, BOX128);
    for (int j = 0; j < min(STAGES, ntiles); ++j)
      fill_pair(sKV, full, j, j, &tm_k, &tm_v, head, b, 64, BOX64);
  }

  const int cw = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int q0w = q0 + 64 * cw;
  const int t0 = q0w + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const float c = sh.scale * LOG2E;
  float lse2[2] = {0.f, 0.f}, del[2] = {0.f, 0.f};
  int qs[2] = {0, 0};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = t0 + 8 * hf;
    if (t < sh.T) {
      lse2[hf] = lse[size_t(bh) * sh.T + t] * LOG2E;
      del[hf] = delta[size_t(bh) * sh.T + t];
      if (sh.use_seg) qs[hf] = q_seg[size_t(b) * sh.T + t];
    }
  }
  float dq_acc[64], s_acc[32], dp_acc[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;

  hopper::mbar_wait(bar, 0);
  const uint64_t dQ = hopper::desc_k(sQ + cw * 64 * 128);
  const uint64_t dO = hopper::desc_k(sdO + cw * 64 * 128);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    const int kb = 64 * j;
    uint8_t* sK = sKV + st * 4 * BOX64;
    hopper::mbar_wait(&full[st], (j / STAGES) & 1);

    // S = Q K^T and dP = dO V^T, this warpgroup's 64 rows x 64 keys, as
    // two groups: P forms while dP is still in the tensor cores
    const uint64_t dK = hopper::desc_k(sK);
    const uint64_t dV = hopper::desc_k(sK + 2 * BOX64);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::mma_64x64_ss(s_acc, hopper::desc_add(dQ, k_step(kk, BOX128)),
                           hopper::desc_add(dK, k_step(kk, BOX64)), kk);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::mma_64x64_ss(dp_acc, hopper::desc_add(dO, k_step(kk, BOX128)),
                           hopper::desc_add(dV, k_step(kk, BOX64)), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s_acc);

    const bool masked = sh.use_seg || kb + 64 > sh.S ||
                        (sh.causal && kb + 63 > q0w + sh.q_offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = acc_half(i);
      float p = exp2f(s_acc[i] * c - lse2[hf]);
      if (masked) {
        const int t = t0 + 8 * hf, key = kb + acc_col(i, lane);
        const bool vis =
            key < sh.S && (!sh.causal || t + sh.q_offset >= key) &&
            (!sh.use_seg || qs[hf] == kv_seg[size_t(b) * sh.S + key]);
        if (!vis) p = 0.f;
      }
      s_acc[i] = p;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp_acc);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp_acc[i] = s_acc[i] * (dp_acc[i] - del[acc_half(i)]) * sh.scale;

    // dQ += dS K
    const uint64_t mK = hopper::desc_mn(sK, BOX64);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk) {
      uint32_t a[4];
      hopper::acc_to_a(dp_acc, kk, a);
      hopper::mma_64x128_rs(dq_acc, a, hopper::desc_add(mK, kk * 2048));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq_acc);
    if (release(done, st) && lane == 0 && j + STAGES < ntiles)
      fill_pair(sKV, full, st, j + STAGES, &tm_k, &tm_v, head, b, 64, BOX64);
  }

  const int rs = sh.H * sh.D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = t0 + 8 * hf;
    if (t < sh.T)
      store_row(dq + (size_t(b) * sh.T + t) * rs + size_t(head) * sh.D,
                dq_acc, hf, lane, sh.D, 1.f);
  }
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
  CUtensorMap mq, mk, mv;
  if (!hopper::map_blhd(&mq, q, B, T, H, D, 128) ||
      !hopper::map_blhd(&mk, k, B, S, H, D, 128) ||
      !hopper::map_blhd(&mv, v, B, S, H, D, 128))
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(flash_fwd_kernel, SMEM_FWD);
  if (err != cudaSuccess) return int(err);
  const Shape sh{T, S, H, D, causal, q_offset, q_seg != nullptr, scale};
  dim3 grid((T + 127) / 128, B * H);
  flash_fwd_kernel<<<grid, NTHREADS, SMEM_FWD, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<const int*>(q_seg),
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
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::map_blhd(&mq, q, B, T, H, D, 64) ||
      !hopper::map_blhd(&mk, k, B, S, H, D, 128) ||
      !hopper::map_blhd(&mv, v, B, S, H, D, 128) ||
      !hopper::map_blhd(&mdo, dout, B, T, H, D, 64))
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel, SMEM_DKV);
  if (err != cudaSuccess) return int(err);
  const Shape sh{T, S, H, D, causal, q_offset, q_seg != nullptr, scale};
  dim3 grid((S + 127) / 128, B * H);
  flash_bwd_dkv_kernel<<<grid, NTHREADS, SMEM_DKV,
                   static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sh);
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
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::map_blhd(&mq, q, B, T, H, D, 128) ||
      !hopper::map_blhd(&mk, k, B, S, H, D, 64) ||
      !hopper::map_blhd(&mv, v, B, S, H, D, 64) ||
      !hopper::map_blhd(&mdo, dout, B, T, H, D, 128))
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel, SMEM_DQ);
  if (err != cudaSuccess) return int(err);
  const Shape sh{T, S, H, D, causal, q_offset, q_seg != nullptr, scale};
  dim3 grid((T + 127) / 128, B * H);
  flash_bwd_dq_kernel<<<grid, NTHREADS, SMEM_DQ,
                  static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<bf16*>(dq), sh);
  return int(cudaGetLastError());
}

// the ragged attention kernels (ragged_decode.cu, ragged_extend.cu)
extern "C" int aurora_ragged_decode_kernel(const char* mode, int gm,
                                           const void** fn, int* smem);
extern "C" int aurora_ragged_extend_kernel(const char* mode, const void** fn,
                                           int* smem);
// the weight streamers (w8a8_matmul.cu, w4_flat_matmul.cu, w4a8_matmul.cu)
// and the fused W4 MLP's tile kernel (fused_mlp_w4.cu)
extern "C" int aurora_w8a8_kernel(int rows, const void** fn, int* smem,
                                  int* blocks);
extern "C" int aurora_w4a16_kernel(int rows, int group, const void** fn,
                                   int* smem, int* blocks);
extern "C" int aurora_w4a8_kernel(int rows, int group, const void** fn,
                                  int* smem, int* blocks);
extern "C" int aurora_w4a8_flat_kernel(int rows, int group, const void** fn,
                                       int* smem, int* blocks);
extern "C" int aurora_fused_mlp_kernel(int rows, const void** fn, int* smem);

// registers a thread, local (spill) bytes a thread and shared bytes a block
// (static and dynamic) of one kernel of the library: "flash_fwd",
// "flash_bwd_dkv", "flash_bwd_dq", "ragged_extend_<mode>",
// "ragged_decode_<mode>_g<1|2|4|8>" (mode bf16, int8 or int4),
// "w8a8_b<rows>", "w4a16_b<rows>", "w4a8_b<rows>", "w4a8_flat_b<rows>"
// (groups of 128) or "fused_mlp_b<rows>" (rows 8, 16, 32, 64)
extern "C" int aurora_kernel_attrs(const char* name, int* regs,
                                   int* local_bytes, int* smem) {
  const void* fn = nullptr;
  int dynamic = 0;
  int err_name = 0;
  char mode[8] = {0};
  int gm = 0, blocks = 0;
  if (strcmp(name, "flash_fwd") == 0) {
    fn = reinterpret_cast<const void*>(flash_fwd_kernel);
    dynamic = int(SMEM_FWD);
  } else if (strcmp(name, "flash_bwd_dkv") == 0) {
    fn = reinterpret_cast<const void*>(flash_bwd_dkv_kernel);
    dynamic = int(SMEM_DKV);
  } else if (strcmp(name, "flash_bwd_dq") == 0) {
    fn = reinterpret_cast<const void*>(flash_bwd_dq_kernel);
    dynamic = int(SMEM_DQ);
  } else if (strncmp(name, "ragged_extend_", 14) == 0 &&
             strlen(name + 14) < sizeof(mode)) {
    err_name = aurora_ragged_extend_kernel(name + 14, &fn, &dynamic);
  } else if (strncmp(name, "ragged_decode_", 14) == 0 &&
             sscanf(name + 14, "%4[a-z0-9]_g%d", mode, &gm) == 2) {
    err_name = aurora_ragged_decode_kernel(mode, gm, &fn, &dynamic);
  } else if (sscanf(name, "w8a8_b%d", &gm) == 1) {
    err_name = aurora_w8a8_kernel(gm, &fn, &dynamic, &blocks);
  } else if (sscanf(name, "w4a16_b%d", &gm) == 1) {
    err_name = aurora_w4a16_kernel(gm, 128, &fn, &dynamic, &blocks);
  } else if (sscanf(name, "w4a8_flat_b%d", &gm) == 1) {
    err_name = aurora_w4a8_flat_kernel(gm, 128, &fn, &dynamic, &blocks);
  } else if (sscanf(name, "w4a8_b%d", &gm) == 1) {
    err_name = aurora_w4a8_kernel(gm, 128, &fn, &dynamic, &blocks);
  } else if (sscanf(name, "fused_mlp_b%d", &gm) == 1) {
    err_name = aurora_fused_mlp_kernel(gm, &fn, &dynamic);
  } else {
    return int(cudaErrorInvalidValue);
  }
  if (err_name != 0 || fn == nullptr) return int(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return int(err);
  *regs = attr.numRegs;
  *local_bytes = int(attr.localSizeBytes);
  *smem = int(attr.sharedSizeBytes) + dynamic;
  return 0;
}
