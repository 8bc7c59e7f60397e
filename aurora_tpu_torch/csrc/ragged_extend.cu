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
// against ~1.4k keys, hd = 128) every K/V tile is reused by 128 query
// rows, so the kernel does ~128 FLOP per KV byte it stages and is
// compute-bound: only wgmma reaches the tensor cores' full rate.
//
// Design: flash_fwd_kernel's (flash_attention.cu; hopper_common.cuh holds
// the building blocks) with a row indirection, GQA folding, dequantized
// tiles, the window and the cap. One block of 256 threads (two
// warpgroups of 64 rows) per (128 folded query rows, KV head, lane), the
// heaviest query tiles first. GQA folds the G query heads of a KV head
// into the row axis as row = t * G + g (query head kvh * G + g at position
// q_offsets[lane] + t), so one K/V tile serves all G heads and the causal
// bound of a tile stays tight; Q is loaded once with 16-byte loads into
// the swizzled layout. K/V tiles of 128 keys arrive by TMA through the 3-D
// map (hd, S, L * B * Hkv) of the rows, at the stripe (layer * B +
// row_ids[lane]) * Hkv + kvh that the block computes from the device
// tensors, so TMA zero-fills past S within each stripe; they land in a
// ring of 3 stages on mbarriers. bf16 tiles are the wgmma operands
// themselves (two boxes of 64 columns, 128-byte swizzle), and the last of
// the 8 warps to finish with a stage refills it. int8 tiles land raw (one
// 128-byte box row per key) and int4 tiles as 64 packed rows, whose low
// nibbles are keys base + [0, 64) and high nibbles base + 128 + [0, 64);
// all 256 threads convert a raw tile into one swizzled bf16 K and V tile
// (exact: int8 and int4 values are bf16 numbers), fence the async proxy
// and sync before the products read it, and thread 0 refills the raw stage
// at once; the tile's key and value scales ride in the ring beside it
// (1-D bulk copies from the scale planes). S = Q K^T and O += P V are
// wgmma bf16 -> fp32 with O, the row max and the row sum in registers, P
// the register A operand and V read MN-major. In registers the key scale
// multiplies the scores after `scale`, then the cap, then the mask; the
// value scale multiplies p after the row sum; exponentials are exp2 with
// log2(e) folded in. The tile loop runs from the tile of the block's first
// visible key, max(0, first query position - w + 1) (int4: its segment's
// first tile), to min(kv_len, last query position + 1): tiles wholly below
// every row's window are neither loaded nor computed. Masking is decided
// per tile and warpgroup: only a tile that crosses the causal diagonal,
// kv_len or the window's lower edge of one of the warpgroup's rows tests
// its elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 128;        // head_dim taken by this kernel
constexpr int BQ = 128;        // folded query rows a block, 64 a warpgroup
constexpr int BK = 128;        // keys a tile
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int WARPS = NTHREADS / 32;
constexpr int STAGES = 3;
constexpr uint32_t BOX = 128 * 128;      // bytes of a [128][64] bf16 box
constexpr uint32_t HEAD_TILE = 2 * BOX;  // [128][128] bf16: Q, K or V
constexpr float NEG_INF = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f;

// bytes of one K (or V) tile as TMA brings it: a bf16 tile is the wgmma
// operand itself; int8 [128 keys][128 B]; int4 [64 packed rows][128 B]
template <typename KV, bool PACK>
__host__ __device__ constexpr uint32_t raw_bytes() {
  return sizeof(KV) == 2 ? HEAD_TILE : (PACK ? 64u * 128u : 128u * 128u);
}

// 1024 bytes of alignment slack, Q, the ring (K then V a stage), [int8 /
// int4: the dequantized K and V tiles, the scales a stage (K then V, BK
// floats each) and the scales of the tile in use], the full barriers and
// the counters
template <typename KV, bool PACK>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + HEAD_TILE + STAGES * 2 * size_t(raw_bytes<KV, PACK>()) +
         (sizeof(KV) == 1 ? 2 * HEAD_TILE + (STAGES + 1) * 2 * BK * 4 : 0) +
         8 * STAGES + 4 * STAGES;
}

struct Shape {
  int T, Hq, Hkv, B, S, G, window;
  float scale, cap, inv_cap;
};

// tile `it` of a row: keys it * BK + [0, BK); int4: packed rows
// seg * 128 + h * 64 + [0, 64) of segment seg = it / 2, h = it % 2, keys
// base + [0, 64) (low nibbles) and base + 128 + [0, 64) (high), base =
// seg * 256 + h * 64
__device__ __forceinline__ int tile_base(int it, bool pack) {
  return pack ? (it >> 1) * 256 + (it & 1) * 64 : it * BK;
}
// the first tile that can hold key position s: packed rows skip whole
// 256-token segments only, since a tile pairs base + [0, 64) with
// base + 128 + [0, 64) and s may sit in either plane
__device__ __forceinline__ int first_tile(int s, bool pack) {
  return pack ? (s >> 8) * 2 : s / BK;
}
// the number of tiles whose base lies below kend
__device__ __forceinline__ int tile_count(int kend, bool pack) {
  if (kend <= 0) return 0;
  if (!pack) return (kend + BK - 1) / BK;
  const int rem = kend & 255;
  return (kend >> 8) * 2 + (rem > 0) + (rem > 64);
}
// position of tile key (column) c
__device__ __forceinline__ int tile_pos(int base, int c, bool pack) {
  return base + c + (pack && c >= 64 ? 64 : 0);
}

// offset of k16 step kk of a head-wide K-major operand
__device__ __forceinline__ uint32_t k_step(int kk) {
  return (kk / 4) * BOX + (kk % 4) * 32;
}

// element i of an m64nN accumulator: row half and column
__device__ __forceinline__ int acc_half(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
}

// int8 → float bits without a conversion instruction: the byte, biased to
// b + 128 (xor 0x80), goes into the low mantissa bits of 2^23 and
// 2^23 + 128 is subtracted; exact for every int8. Such a float has at
// most 8 significant bits, so its high 16 bits are its exact bf16.
// `mul` rescales it exactly (a power of two).
__device__ __forceinline__ unsigned s8_to_f_bits(unsigned biased, int i,
                                                 float mul) {
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
// 16 biased bytes (cols 16c .. 16c + 15 of row r) → row r of a swizzled
// bf16 head tile
__device__ __forceinline__ void store16(uint8_t* tile, int r, int c,
                                        const unsigned (&b)[4], float mul) {
  unsigned w[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) bf16x4(b[i], mul, w + 2 * i);
  uint8_t* box = tile + (c >> 2) * BOX;
  const int ch = (c & 3) * 2;
  *reinterpret_cast<uint4*>(box + hopper::swz128(r, ch)) =
      make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(box + hopper::swz128(r, ch + 1)) =
      make_uint4(w[4], w[5], w[6], w[7]);
}

// a raw int8 / int4 K or V tile → its swizzled bf16 tile, and the
// tile's BK scales from the stage into `scales`; all threads
template <bool PACK>
__device__ __forceinline__ void dequantize(const uint8_t* raw, uint8_t* dst,
                                           const float* stage_scales,
                                           float* scales) {
  constexpr int ROWS = PACK ? 64 : 128;
  for (int e = threadIdx.x; e < ROWS * 8; e += NTHREADS) {
    const int r = e >> 3, c = e & 7;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * 128 + c * 16);
    const unsigned in[4] = {v.x, v.y, v.z, v.w};
    if constexpr (PACK) {
      unsigned lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = ((in[i] << 4) & 0xF0F0F0F0u) ^ 0x80808080u;
        hi[i] = (in[i] & 0xF0F0F0F0u) ^ 0x80808080u;
      }
      store16(dst, r, c, lo, 0.0625f);
      store16(dst, 64 + r, c, hi, 0.0625f);
    } else {
      unsigned b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = in[i] ^ 0x80808080u;
      store16(dst, r, c, b, 1.f);
    }
  }
  if (threadIdx.x < BK) scales[threadIdx.x] = stage_scales[threadIdx.x];
  hopper::fence_proxy_async();  // the products read dst through TMA's proxy
}

// bf16 row of an m64n128 accumulator (the thread's columns) to dst
__device__ __forceinline__ void store_row(bf16* dst, const float (&acc)[64],
                                          int half, int lane, float mul) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
        acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
  }
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

template <typename KV, bool PACK>
__global__ void __launch_bounds__(NTHREADS, 1)
extend_kernel(const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const bf16* __restrict__ q, const float* __restrict__ k_scales,
              const float* __restrict__ v_scales, bf16* __restrict__ out,
              const int* __restrict__ kv_lens,
              const int* __restrict__ q_offsets,
              const int* __restrict__ row_ids,
              const int* __restrict__ layer_ptr, Shape sh) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr uint32_t RAW = raw_bytes<KV, PACK>();
  static_assert(!PACK || QUANT, "packed rows are int8 bytes");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = hopper::align1024(smem_raw);
  uint8_t* ring = sQ + HEAD_TILE;  // stage st: K, then V
  uint8_t* sKc = ring + STAGES * 2 * RAW;  // int8 / int4: dequantized
  uint8_t* sVc = sKc + HEAD_TILE;
  float* sSc = reinterpret_cast<float*>(QUANT ? sVc + HEAD_TILE : sKc);
  float* sScT = sSc + STAGES * 2 * BK;  // the scales of the tile in use
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(sSc) +
      (QUANT ? (STAGES + 1) * 2 * BK * 4 : 0));
  int* done = reinterpret_cast<int*>(full + STAGES);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int kvh = blockIdx.y, lb = blockIdx.z;
  const int G = sh.G, rows_total = G * sh.T, r0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int kv_len = min(kv_lens[lb], sh.S);
  const int q_off = q_offsets[lb];
  const int stripe = (*layer_ptr * sh.B + row_ids[lb]) * sh.Hkv + kvh;
  const float* Ks = QUANT ? k_scales + size_t(stripe) * sh.S : nullptr;
  const float* Vs = QUANT ? v_scales + size_t(stripe) * sh.S : nullptr;

  // key tiles: from the one that holds the block's first visible key to
  // the causal limit of its last row
  const int last_rr = min(r0 + BQ, rows_total) - 1;
  const int kend = min(kv_len, q_off + last_rr / G + 1);
  const int kstart =
      sh.window > 0 ? max(0, q_off + r0 / G - sh.window + 1) : 0;
  const int it0 = first_tile(kstart, PACK);
  const int ntiles = max(0, tile_count(kend, PACK) - it0);

  // tile it into ring stage st (K, V and their scales); one thread
  auto fill = [&](int st, int it) {
    uint8_t* dst = ring + st * 2 * RAW;
    const int kb = tile_base(it, PACK);
    uint32_t sbytes = 0;
    if (QUANT) sbytes = PACK ? 4 * 256 : 2 * 4 * min(BK, sh.S - kb);
    hopper::mbar_expect_tx(&full[st], 2 * RAW + sbytes);
    if constexpr (!QUANT) {
      hopper::tma_load_3d(dst, &tm_k, &full[st], 0, kb, stripe);
      hopper::tma_load_3d(dst + BOX, &tm_k, &full[st], 64, kb, stripe);
      hopper::tma_load_3d(dst + RAW, &tm_v, &full[st], 0, kb, stripe);
      hopper::tma_load_3d(dst + RAW + BOX, &tm_v, &full[st], 64, kb, stripe);
    } else {
      const int prow = PACK ? (it >> 1) * 128 + (it & 1) * 64 : kb;
      hopper::tma_load_3d(dst, &tm_k, &full[st], 0, prow, stripe);
      hopper::tma_load_3d(dst + RAW, &tm_v, &full[st], 0, prow, stripe);
      float* sc = sSc + st * 2 * BK;
      if (PACK) {
        hopper::bulk_copy_1d(sc, Ks + kb, 256, &full[st]);
        hopper::bulk_copy_1d(sc + 64, Ks + kb + 128, 256, &full[st]);
        hopper::bulk_copy_1d(sc + BK, Vs + kb, 256, &full[st]);
        hopper::bulk_copy_1d(sc + BK + 64, Vs + kb + 128, 256, &full[st]);
      } else {
        hopper::bulk_copy_1d(sc, Ks + kb, sbytes / 2, &full[st]);
        hopper::bulk_copy_1d(sc + BK, Vs + kb, sbytes / 2, &full[st]);
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      done[s] = 0;
    }
    hopper::fence_barrier_init();
  }
  // scales past S stay finite (zeros) in every stage
  if (QUANT)
    for (int i = tid; i < STAGES * 2 * BK; i += NTHREADS) sSc[i] = 0.f;
  // Q: the block's 128 folded rows, zeros past the last one
  for (int c = tid; c < BQ * (HD / 8); c += NTHREADS) {
    const int r = c >> 4, ch = c & 15, rr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rr < rows_total) {
      const int t = rr / G, g = rr % G;
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t(lb) * sh.T + t) * sh.Hq + kvh * G + g) * HD + ch * 8);
    }
    *reinterpret_cast<uint4*>(sQ + (ch >> 3) * BOX + hopper::swz128(r, ch & 7)) =
        val;
  }
  hopper::fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(STAGES, ntiles); ++j) fill(j, it0 + j);

  const int cw = tid / 128;
  const int r0w = r0 + 64 * cw;
  const int rr0 = r0w + 16 * ((tid / 32) % 4) + lane / 4;  // rows rr0, +8
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qp[h] = q_off + (rr0 + 8 * h) / G;
  // the warpgroup's first and last query positions
  const int pmin = q_off + r0w / G;
  const int pmax = q_off + max(min(r0w + 63, rows_total - 1), r0w) / G;
  const bool plain_scores = !QUANT && !(sh.cap > 0.f);
  const float c_plain = sh.scale * LOG2E;

  float o[64], s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint64_t dq = hopper::desc_k(sQ + cw * 64 * 128);
  uint32_t pa[8][4];

  // int8 / int4: tile j's K is converted while tile j - 1's P V runs (tile
  // 0's here), its V while its own Q K^T runs; two block barriers a tile
  // order the conversions against the products
  if constexpr (QUANT) {
    if (ntiles > 0) {
      hopper::mbar_wait(&full[0], 0);
      dequantize<PACK>(ring, sKc, sSc, sScT);
    }
  }
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    const int kb = tile_base(it0 + j, PACK);
    uint8_t* raw = ring + st * 2 * RAW;
    const uint8_t* tK = raw;
    const uint8_t* tV = raw + RAW;
    if constexpr (QUANT) {
      // K(j) is converted and tile j - 1's products are done everywhere
      __syncthreads();
      tK = sKc;
      tV = sVc;
    } else {
      hopper::mbar_wait(&full[st], (j / STAGES) & 1);
    }

    // S = Q K^T, the warpgroup's 64 rows x 128 keys
    const uint64_t dk = hopper::desc_k(tK);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::mma_64x128_ss(s, hopper::desc_add(dq, k_step(kk)),
                            hopper::desc_add(dk, k_step(kk)), kk);
    hopper::wgmma_commit();
    if constexpr (QUANT)
      dequantize<PACK>(raw + RAW, sVc, sSc + st * 2 * BK + BK, sScT + BK);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // logits (log2 units): scale, key scale, cap; the mask where a key of
    // the tile is past kv_len, above a row's position or below its window
    const int kmax = kb + (PACK ? 191 : BK - 1);
    const bool masked = kmax >= kv_len || kmax > pmin ||
                        (sh.window > 0 && kb <= pmax - sh.window);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = acc_col(i, lane);
      float x;
      if (plain_scores) {
        x = s[i] * c_plain;
      } else {
        x = s[i] * sh.scale;
        if (QUANT) x *= sScT[col];
        if (sh.cap > 0.f) x = sh.cap * tanhf(x * sh.inv_cap);
        x *= LOG2E;
      }
      if (masked) {
        const int key = tile_pos(kb, col, PACK);
        const int p = qp[acc_half(i)];
        const bool vis = key < kv_len && key <= p &&
                         (sh.window <= 0 || key > p - sh.window);
        if (!vis) x = -INFINITY;
      }
      s[i] = x;
    }
    float mx[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
    for (int i = 0; i < 64; ++i)
      mx[acc_half(i)] = fmaxf(mx[acc_half(i)], s[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      s[i] = exp2f(s[i] - m[acc_half(i)]);
      l[acc_half(i)] += s[i];
    }
    if constexpr (QUANT) {
      // V(j) is converted everywhere, and the raw stage is free
      __syncthreads();
      if (tid == 0 && j + STAGES < ntiles) fill(st, it0 + j + STAGES);
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= sScT[BK + acc_col(i, lane)];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= alpha[acc_half(i)];

    // O += P V
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) hopper::acc_to_a(s, kk, pa[kk]);
    const uint64_t dv = hopper::desc_mn(tV, BOX);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::mma_64x128_rs(o, pa[kk], hopper::desc_add(dv, kk * 2048));
    hopper::wgmma_commit();
    if constexpr (QUANT) {
      if (j + 1 < ntiles) {  // every warpgroup is past its Q K^T of tile j
        const int st1 = (j + 1) % STAGES;
        hopper::mbar_wait(&full[st1], ((j + 1) / STAGES) & 1);
        dequantize<PACK>(ring + st1 * 2 * RAW, sKc, sSc + st1 * 2 * BK,
                         sScT);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if constexpr (!QUANT) {
      if (release(done, st) && lane == 0 && j + STAGES < ntiles)
        fill(st, it0 + j + STAGES);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int rr = rr0 + 8 * h;
    if (rr < rows_total) {
      const int t = rr / G, g = rr % G;
      store_row(out + ((size_t(lb) * sh.T + t) * sh.Hq + kvh * G + g) * HD,
                o, h, lane, 1.f / fmaxf(l[h], 1e-30f));
    }
  }
}

template <typename KV, bool PACK>
int launch(const void* q, const void* k_rows, const void* v_rows,
           const void* k_scales, const void* v_scales, void* out,
           const void* kv_lens, const void* q_offsets, const void* row_ids,
           const void* layer, int Bk, int T, int Hq, int Hkv, int L, int B,
           int S, int head_dim, float scale, int window, float cap,
           float inv_cap, void* stream) {
  constexpr bool QUANT = sizeof(KV) == 1;
  if (head_dim != HD || Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 ||
      Bk <= 0 || Bk > 65535 || T <= 0 || L <= 0 || B <= 0 || S <= 0 ||
      (PACK && S % 256 != 0) || (QUANT && S % 4 != 0) || cap < 0.f)
    return int(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const long long stripes = (long long)L * B * Hkv;
  CUtensorMap mk, mv;
  const bool ok =
      QUANT ? hopper::map_stripes(&mk, k_rows, 1, HD, PACK ? S / 2 : S,
                                  stripes, HD, PACK ? 64 : BK, false) &&
                  hopper::map_stripes(&mv, v_rows, 1, HD, PACK ? S / 2 : S,
                                      stripes, HD, PACK ? 64 : BK, false)
            : hopper::map_stripes(&mk, k_rows, 2, 2 * HD, S, stripes, 64, BK,
                                  true) &&
                  hopper::map_stripes(&mv, v_rows, 2, 2 * HD, S, stripes, 64,
                                      BK, true);
  if (!ok) return int(cudaErrorInvalidValue);
  constexpr size_t SMEM = smem_bytes<KV, PACK>();
  cudaError_t err = cudaFuncSetAttribute(
      extend_kernel<KV, PACK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SMEM));
  if (err != cudaSuccess) return int(err);
  const Shape sh{T, Hq, Hkv, B, S, G, window, scale, cap, inv_cap};
  dim3 grid((G * T + BQ - 1) / BQ, Hkv, Bk);
  extend_kernel<KV, PACK>
      <<<grid, NTHREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
          mk, mv, static_cast<const bf16*>(q),
          static_cast<const float*>(k_scales),
          static_cast<const float*>(v_scales), static_cast<bf16*>(out),
          static_cast<const int*>(kv_lens),
          static_cast<const int*>(q_offsets),
          static_cast<const int*>(row_ids), static_cast<const int*>(layer),
          sh);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int aurora_ragged_extend_bf16(
    const void* q, const void* k_rows, const void* v_rows, void* out,
    const void* kv_lens, const void* q_offsets, const void* row_ids,
    const void* layer, int Bk, int T, int Hq, int Hkv, int L, int B, int S,
    int head_dim, float scale, int window, float cap, float inv_cap,
    void* stream) {
  return launch<bf16, false>(q, k_rows, v_rows, nullptr, nullptr, out,
                             kv_lens, q_offsets, row_ids, layer, Bk, T, Hq,
                             Hkv, L, B, S, head_dim, scale, window, cap,
                             inv_cap, stream);
}

// int8 rows [L, B, Hkv, S, hd] with fp32 scale planes [L, B, Hkv, S]
// (S % 4 == 0: the planes are copied in 16-byte units); q and out stay
// bf16
extern "C" int aurora_ragged_extend_int8(
    const void* q, const void* k_rows, const void* v_rows,
    const void* k_scales, const void* v_scales, void* out,
    const void* kv_lens, const void* q_offsets, const void* row_ids,
    const void* layer, int Bk, int T, int Hq, int Hkv, int L, int B, int S,
    int head_dim, float scale, int window, float cap, float inv_cap,
    void* stream) {
  return launch<int8_t, false>(q, k_rows, v_rows, k_scales, v_scales, out,
                               kv_lens, q_offsets, row_ids, layer, Bk, T, Hq,
                               Hkv, L, B, S, head_dim, scale, window, cap,
                               inv_cap, stream);
}

// packed int4 rows [L, B, Hkv, S/2, hd] with fp32 scale planes
// [L, B, Hkv, S]; S is the token count (a multiple of 256)
extern "C" int aurora_ragged_extend_int4(
    const void* q, const void* k_rows, const void* v_rows,
    const void* k_scales, const void* v_scales, void* out,
    const void* kv_lens, const void* q_offsets, const void* row_ids,
    const void* layer, int Bk, int T, int Hq, int Hkv, int L, int B, int S,
    int head_dim, float scale, int window, float cap, float inv_cap,
    void* stream) {
  return launch<int8_t, true>(q, k_rows, v_rows, k_scales, v_scales, out,
                              kv_lens, q_offsets, row_ids, layer, Bk, T, Hq,
                              Hkv, L, B, S, head_dim, scale, window, cap,
                              inv_cap, stream);
}

// the kernel of a mode ("bf16", "int8", "int4") and its dynamic shared
// bytes, for aurora_kernel_attrs
extern "C" int aurora_ragged_extend_kernel(const char* mode, const void** fn,
                                           int* smem) {
  if (strcmp(mode, "bf16") == 0) {
    *fn = reinterpret_cast<const void*>(extend_kernel<bf16, false>);
    *smem = int(smem_bytes<bf16, false>());
  } else if (strcmp(mode, "int8") == 0) {
    *fn = reinterpret_cast<const void*>(extend_kernel<int8_t, false>);
    *smem = int(smem_bytes<int8_t, false>());
  } else if (strcmp(mode, "int4") == 0) {
    *fn = reinterpret_cast<const void*>(extend_kernel<int8_t, true>);
    *smem = int(smem_bytes<int8_t, true>());
  } else {
    return int(cudaErrorInvalidValue);
  }
  return 0;
}
