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
// compute-bound: only wgmma reaches the tensor cores' full rate. At the
// narrower heads (64, 96) the exponentials of a tile cost about as many
// cycles as its products, so a smaller share of the bound is reachable.
//
// Design: flash_fwd_kernel's (flash_attention.cu; hopper_common.cuh holds
// the building blocks) with a row indirection, GQA folding, dequantized
// tiles, the window and the cap, compiled at head widths W = 64, 96 and
// 128 (`extend_kernel<W, ...>`). One block of 256 threads (two
// warpgroups of 64 rows) per (128 folded query rows, KV head, lane), the
// heaviest query tiles first. GQA folds the G query heads of a KV head
// into the row axis as row = t * G + g (query head kvh * G + g at position
// q_offsets[lane] + t), so one K/V tile serves all G heads and the causal
// bound of a tile stays tight; Q is loaded once with 16-byte loads into
// the swizzled layout. A head of W columns lies in shared memory as
// boxes of 128 rows (`Head<W>`): 64 columns under the 128-byte swizzle at
// W = 64 and 128, and 32 columns under the 64-byte swizzle at W = 96, so
// that the 96 columns are three whole swizzle atoms and P V is one
// m64n96 product. K/V tiles of 128 keys arrive by TMA through the 3-D
// map (hd, S, L * B * Hkv) of the rows, at the stripe (layer * B +
// row_ids[lane]) * Hkv + kvh that the block computes from the device
// tensors, so TMA zero-fills past S within each stripe; they land in a
// ring of 3 stages on mbarriers. bf16 tiles are the wgmma operands
// themselves (one box per 64 or 32 columns), and the last of the 8 warps
// to finish with a stage refills it. int8 tiles land raw (one W-byte box
// row per key) and int4 tiles as 64 packed rows, whose low nibbles are
// keys base + [0, 64) and high nibbles base + 128 + [0, 64); all 256
// threads convert a raw tile into one swizzled bf16 K and V tile (exact:
// int8 and int4 values are bf16 numbers), fence the async proxy and sync
// before the products read it, and thread 0 refills the raw stage at
// once; the tile's key and value scales ride in the ring beside it (1-D
// bulk copies from the scale planes). At 128 the K and V of the next
// tile are converted while this tile's products run, into one buffer,
// under two block barriers a tile; below 128 into a second buffer
// (dq_bufs), under one. S = Q K^T (W / 16 k16 steps) and O += P V (N = W)
// are wgmma bf16 -> fp32 with O, the row max and the row sum in
// registers, P the register A operand and V read MN-major. In registers
// the key scale multiplies the scores after `scale`, then the cap, then
// the mask (without a cap, scale, key scale and log2(e) are one
// multiply); the value scale multiplies p after the row sum; each
// exponential is one ex2.approx.ftz, log2(e) folded in. The tile loop
// runs from the tile of the block's first visible key, max(0, first query
// position - w + 1) (int4: its segment's first tile), to min(kv_len, last
// query position + 1): tiles wholly below every row's window are neither
// loaded nor computed. Masking is decided per tile and warpgroup: only a
// tile that crosses the causal diagonal, kv_len or the window's lower edge
// of one of the warpgroup's rows tests its elements.
//
// Head widths: any multiple of 16 from 16 to 256, each run by the kernel
// of the next compile-time width up: 64, 96 and 128 on the design above
// (`extend_kernel`), 256 on its 64-key-tile variant
// (`extend_d256_kernel`). The columns from hd to the kernel's width read
// as zeros (TMA fills a box past the rows' inner extent hd with zeros, the
// 16-byte loads of Q write zeros there), add nothing to Q K^T, and give
// output columns that are never stored; the scale is the caller's (by
// default that of the real hd). So a padded width is exact, and the KV
// rows are never padded in memory: they are the cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 128;        // folded query rows a block, 64 a warpgroup
constexpr int BK = 128;        // keys a tile
constexpr int NTHREADS = 256;  // two warpgroups
constexpr int WARPS = NTHREADS / 32;
constexpr int STAGES = 3;
constexpr uint32_t BOX = 128 * 128;      // bytes of a [128][64] bf16 box
constexpr float NEG_INF = -2.3819763e38f;
constexpr float LOG2E = 1.4426950408889634f;

// a bf16 head of W columns (64, 96, 128, 256) over 128 rows in shared
// memory: NB boxes of BC columns, rows of SPAN = 2 * BC bytes under the
// SPAN-byte swizzle (hopper_common.cuh)
template <int W>
struct Head {
  static constexpr int BC = W == 96 ? 32 : 64;
  static constexpr int NB = W / BC;
  static constexpr int SPAN = 2 * BC;
  static constexpr uint32_t BOXB = 128u * SPAN;  // a box of 128 rows
  static constexpr uint32_t TILE = NB * BOXB;    // [128][W]: Q, K or V
  static constexpr int KB = BC / 16;             // k16 steps a box
  static constexpr CUtensorMapSwizzle SWIZZLE =
      SPAN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

// bytes of one K (or V) tile as TMA brings it: a bf16 tile is the wgmma
// operand itself; int8 [128 keys][W B]; int4 [64 packed rows][W B]
template <int W, typename KV, bool PACK>
__host__ __device__ constexpr uint32_t raw_bytes() {
  return sizeof(KV) == 2 ? Head<W>::TILE : (PACK ? 64u : 128u) * W;
}

// int8 / int4 below width 128: the dequantized K and V tiles and the
// scales of the tile in use are double-buffered, so that tile j + 1's
// conversion runs beside tile j's products under one block barrier a
// tile; at 128 a second buffer does not fit beside the 3-stage ring (one
// buffer, two barriers a tile)
template <int W, typename KV>
__host__ __device__ constexpr int dq_bufs() {
  return sizeof(KV) == 1 && W < 128 ? 2 : 1;
}

// 1024 bytes of alignment slack, Q, the ring (K then V a stage), [int8 /
// int4: the dequantized K and V tiles (dq_bufs each), the scales a stage
// (K then V, BK floats each) and the scales of the tiles in use (dq_bufs
// times K then V)], the full barriers and the counters
template <int W, typename KV, bool PACK>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr size_t TILE = Head<W>::TILE;
  constexpr int NDQ = dq_bufs<W, KV>();
  return 1024 + TILE + STAGES * 2 * size_t(raw_bytes<W, KV, PACK>()) +
         (sizeof(KV) == 1 ? 2 * NDQ * TILE + (STAGES + NDQ) * 2 * BK * 4
                          : 0) +
         8 * STAGES + 4 * STAGES;
}

struct Shape {
  int T, Hq, Hkv, B, S, G, window, hd;  // hd: the rows' head_dim
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

// offset of k16 step kk of a K-major operand laid out as Head<W>
template <int W>
__device__ __forceinline__ uint32_t k_step(int kk) {
  return (kk / Head<W>::KB) * Head<W>::BOXB + (kk % Head<W>::KB) * 32;
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
__device__ __forceinline__ unsigned s8_to_f_bits(unsigned biased, int i) {
  return __float_as_uint(
      __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + i)) -
      8388736.f);
}
// four biased bytes → two bf16 pairs, the lower-addressed value in the low
// half of each
__device__ __forceinline__ void bf16x4(unsigned biased, unsigned* w) {
  w[0] = __byte_perm(s8_to_f_bits(biased, 0), s8_to_f_bits(biased, 1),
                     0x7632);
  w[1] = __byte_perm(s8_to_f_bits(biased, 2), s8_to_f_bits(biased, 3),
                     0x7632);
}
// eight bf16 pairs (cols 16c .. 16c + 15 of row r) → row r of a swizzled
// bf16 head tile laid out as Head<W>, over ROWS rows
template <int W, int ROWS = 128>
__device__ __forceinline__ void store_words(uint8_t* tile, int r, int c,
                                            const unsigned (&w)[8]) {
  using H = Head<W>;
  constexpr int GB = H::BC / 16;  // groups of 16 columns a box
  uint8_t* box = tile + (c / GB) * (ROWS * H::SPAN);
  const int ch = (c % GB) * 2;
  *reinterpret_cast<uint4*>(box + hopper::swz<H::SPAN>(r, ch)) =
      make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(box + hopper::swz<H::SPAN>(r, ch + 1)) =
      make_uint4(w[4], w[5], w[6], w[7]);
}
// 16 biased bytes (cols 16c .. 16c + 15 of row r) → row r of a swizzled
// bf16 head tile
template <int W>
__device__ __forceinline__ void store16(uint8_t* tile, int r, int c,
                                        const unsigned (&b)[4]) {
  unsigned w[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) bf16x4(b[i], w + 2 * i);
  store_words<W>(tile, r, c, w);
}

// the four nibbles of plane h (0: low, 1: high) of a packed word → two
// bf16 pairs, the lower-addressed value in the low half of each, with no
// conversion instruction: the signed nibble n, its top bit flipped, is
// n + 8, which under bf16 128's exponent (0x43) is 136 + n, from which a
// bf16x2 subtraction takes 136 (exact: integers below 256). At int4 this
// takes ~1.5 instructions a value against bf16x4's ~3.5.
__device__ __forceinline__ void s4x4_bf16(unsigned w, int h, unsigned* out) {
  const unsigned u = ((h ? w >> 4 : w) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const unsigned k136 = 0x43084308u;  // bf16 136.0 twice
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const unsigned m = __byte_perm(u, 0x43u, i ? 0x4342 : 0x4140);
    const __nv_bfloat162 r =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                *reinterpret_cast<const __nv_bfloat162*>(&k136));
    out[i] = *reinterpret_cast<const unsigned*>(&r);
  }
}

// a raw int8 / int4 K or V tile (rows of W bytes) → its swizzled bf16
// tile, and the tile's BK scales from the stage into `scales`; all threads
template <int W, bool PACK>
__device__ __forceinline__ void dequantize(const uint8_t* raw, uint8_t* dst,
                                           const float* stage_scales,
                                           float* scales) {
  constexpr int ROWS = PACK ? 64 : 128, C = W / 16;
  for (int e = threadIdx.x; e < ROWS * C; e += NTHREADS) {
    const int r = e / C, c = e % C;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * W + c * 16);
    const unsigned in[4] = {v.x, v.y, v.z, v.w};
    if constexpr (PACK) {
      unsigned lo[8], hi[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s4x4_bf16(in[i], 0, lo + 2 * i);
        s4x4_bf16(in[i], 1, hi + 2 * i);
      }
      store_words<W>(dst, r, c, lo);
      store_words<W>(dst, 64 + r, c, hi);
    } else {
      unsigned b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = in[i] ^ 0x80808080u;
      store16<W>(dst, r, c, b);
    }
  }
  if (threadIdx.x < BK) scales[threadIdx.x] = stage_scales[threadIdx.x];
  hopper::fence_proxy_async();  // the products read dst through TMA's proxy
}

// bf16 row of an m64nN accumulator (the thread's columns below cols) to
// dst
template <int A>
__device__ __forceinline__ void store_row(bf16* dst, const float (&acc)[A],
                                          int half, int lane, float mul,
                                          int cols) {
#pragma unroll
  for (int j = 0; j < A / 4; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (col < cols)
      *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
  }
}

// the block's 128 folded query rows [r0, r0 + 128) of head kvh's group
// into a swizzled head of W columns laid out as Head<W>, 16-byte loads;
// zeros past the last row and from column hd on; all threads
template <int W>
__device__ __forceinline__ void load_q(uint8_t* sQ, const bf16* q,
                                       const Shape& sh, int lb, int kvh,
                                       int r0) {
  using H = Head<W>;
  constexpr int CH = W / 8, CB = H::BC / 8;  // chunks a row, a box row
  const int rows_total = sh.G * sh.T;
  for (int c = threadIdx.x; c < BQ * CH; c += NTHREADS) {
    const int r = c / CH, ch = c % CH, rr = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rr < rows_total && ch * 8 < sh.hd) {
      const int t = rr / sh.G, g = rr % sh.G;
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t(lb) * sh.T + t) * sh.Hq + kvh * sh.G + g) * sh.hd +
          ch * 8);
    }
    *reinterpret_cast<uint4*>(sQ + (ch / CB) * H::BOXB +
                              hopper::swz<H::SPAN>(r, ch % CB)) = val;
  }
}

// O (+)= P V at N = W columns, V MN-major laid out as Head<W>
template <int W>
__device__ __forceinline__ void mma_pv(float (&o)[W / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (W == 64)
    hopper::mma_64x64_rs(o, a, b);
  else if constexpr (W == 96)
    hopper::mma_64x96_rs(o, a, b);
  else
    hopper::mma_64x128_rs(o, a, b);
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

template <int W, typename KV, bool PACK>
__global__ void __launch_bounds__(NTHREADS, 1)
extend_kernel(const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const bf16* __restrict__ q, const float* __restrict__ k_scales,
              const float* __restrict__ v_scales, bf16* __restrict__ out,
              const int* __restrict__ kv_lens,
              const int* __restrict__ q_offsets,
              const int* __restrict__ row_ids,
              const int* __restrict__ layer_ptr, Shape sh) {
  using H = Head<W>;
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr uint32_t RAW = raw_bytes<W, KV, PACK>();
  constexpr int NDQ = dq_bufs<W, KV>();
  constexpr bool ONE_BAR = NDQ == 2;
  static_assert(!PACK || QUANT, "packed rows are int8 bytes");
  static_assert(W == 64 || W == 96 || W == 128, "head widths 64, 96, 128");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = hopper::align1024(smem_raw);
  uint8_t* ring = sQ + H::TILE;  // stage st: K, then V
  uint8_t* sKc = ring + STAGES * 2 * RAW;  // int8 / int4: dequantized
  uint8_t* sVc = sKc + NDQ * H::TILE;
  float* sSc = reinterpret_cast<float*>(QUANT ? sVc + NDQ * H::TILE : sKc);
  float* sScT = sSc + STAGES * 2 * BK;  // the scales of the tiles in use
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(sSc) +
      (QUANT ? (STAGES + NDQ) * 2 * BK * 4 : 0));
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
      for (int i = 0; i < H::NB; ++i) {
        hopper::tma_load_3d(dst + i * H::BOXB, &tm_k, &full[st], i * H::BC,
                            kb, stripe);
        hopper::tma_load_3d(dst + RAW + i * H::BOXB, &tm_v, &full[st],
                            i * H::BC, kb, stripe);
      }
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
  load_q<W>(sQ, q, sh, lb, kvh, r0);
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

  float o[W / 2], s[64];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint64_t dq = hopper::desc_k<H::SPAN>(sQ + cw * 64 * H::SPAN);
  uint32_t pa[8][4];

  // int8 / int4, one buffer: tile j's K is converted while tile j - 1's
  // P V runs (tile 0's here), its V while its own Q K^T runs; two block
  // barriers a tile order the conversions against the products. Two
  // buffers (ONE_BAR): tile j + 1's K is converted into the other buffer
  // while tile j's Q K^T runs, its V while tile j's P V runs, and one
  // block barrier a tile orders them (tile 0's both here)
  if constexpr (QUANT) {
    if (ntiles > 0) {
      hopper::mbar_wait(&full[0], 0);
      dequantize<W, PACK>(ring, sKc, sSc, sScT);
      if constexpr (ONE_BAR)
        dequantize<W, PACK>(ring + RAW, sVc, sSc + BK, sScT + BK);
    }
  }
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES, buf = ONE_BAR ? j & 1 : 0;
    const int kb = tile_base(it0 + j, PACK);
    uint8_t* raw = ring + st * 2 * RAW;
    const uint8_t* tK = raw;
    const uint8_t* tV = raw + RAW;
    const float* scT = sScT + buf * 2 * BK;  // tile j's K, then V scales
    if constexpr (QUANT) {
      // K(j) (ONE_BAR: and V(j)) is converted and tile j - 1's products
      // are done everywhere
      __syncthreads();
      // ONE_BAR: tile j's raw stage was converted in iteration j - 1
      if (ONE_BAR && tid == 0 && j + STAGES < ntiles)
        fill(st, it0 + j + STAGES);
      tK = sKc + buf * H::TILE;
      tV = sVc + buf * H::TILE;
    } else {
      hopper::mbar_wait(&full[st], (j / STAGES) & 1);
    }

    // S = Q K^T, the warpgroup's 64 rows x 128 keys
    const uint64_t dk = hopper::desc_k<H::SPAN>(tK);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      hopper::mma_64x128_ss(s, hopper::desc_add(dq, k_step<W>(kk)),
                            hopper::desc_add(dk, k_step<W>(kk)), kk);
    hopper::wgmma_commit();
    if constexpr (ONE_BAR) {
      if (j + 1 < ntiles) {
        const int st1 = (j + 1) % STAGES;
        hopper::mbar_wait(&full[st1], ((j + 1) / STAGES) & 1);
        dequantize<W, PACK>(ring + st1 * 2 * RAW, sKc + (buf ^ 1) * H::TILE,
                            sSc + st1 * 2 * BK, sScT + (buf ^ 1) * 2 * BK);
      }
    } else if constexpr (QUANT) {
      dequantize<W, PACK>(raw + RAW, sVc, sSc + st * 2 * BK + BK,
                          sScT + BK);
    }
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
      } else if (!(sh.cap > 0.f)) {  // int8 / int4: one multiply a score
        x = s[i] * (scT[col] * c_plain);
      } else {
        x = s[i] * sh.scale;
        if (QUANT) x *= scT[col];
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
      alpha[h] = hopper::ex2(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      s[i] = hopper::ex2(s[i] - m[acc_half(i)]);
      l[acc_half(i)] += s[i];
    }
    if constexpr (QUANT) {
      if constexpr (!ONE_BAR) {
        // V(j) is converted everywhere, and the raw stage is free
        __syncthreads();
        if (tid == 0 && j + STAGES < ntiles) fill(st, it0 + j + STAGES);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= scT[BK + acc_col(i, lane)];
    }
#pragma unroll
    for (int i = 0; i < W / 2; ++i) o[i] *= alpha[acc_half(i)];

    // O += P V
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) hopper::acc_to_a(s, kk, pa[kk]);
    const uint64_t dv = hopper::desc_mn<H::SPAN>(tV, H::BOXB);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_pv<W>(o, pa[kk], hopper::desc_add(dv, kk * 16 * H::SPAN));
    hopper::wgmma_commit();
    if constexpr (QUANT) {
      if (j + 1 < ntiles) {
        const int st1 = (j + 1) % STAGES;
        if constexpr (ONE_BAR) {
          dequantize<W, PACK>(ring + st1 * 2 * RAW + RAW,
                              sVc + (buf ^ 1) * H::TILE,
                              sSc + st1 * 2 * BK + BK,
                              sScT + (buf ^ 1) * 2 * BK + BK);
        } else {  // every warpgroup is past its Q K^T of tile j
          hopper::mbar_wait(&full[st1], ((j + 1) / STAGES) & 1);
          dequantize<W, PACK>(ring + st1 * 2 * RAW, sKc, sSc + st1 * 2 * BK,
                              sScT);
        }
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
      store_row(out + ((size_t(lb) * sh.T + t) * sh.Hq + kvh * G + g) * sh.hd,
                o, h, lane, 1.f / fmaxf(l[h], 1e-30f), sh.hd);
    }
  }
}


// ------------------------------------------------------------- head_dim 256
// Kernel width 256 (head_dim 144-256; Gemma's heads): `extend_kernel`'s
// contract and walk at a 256-column head, on the design of flash_attention
// .cu's `flash_fwd_d256_kernel`. 256 threads as two warpgroups of 64
// folded rows and no producer warpgroup (a producer warp caps every thread
// at 168 registers); Q, 128 folded rows, loaded once with 16-byte loads
// into four swizzled boxes of 64 columns (64 KB). Key tiles of 64 keys:
// bf16 K and V arrive by TMA as four boxes each (64 KB a stage, boxes
// wholly past hd zeroed once and never loaded) in a ring of 2 stages,
// refilled by the last warp done with a stage; int8 tiles land raw (64
// keys x 256 B) and int4 ones as 64 packed rows x 256 B, which hold two
// tiles, keys base + [0, 64) in the low nibbles and base + 128 + [0, 64)
// in the high ones, so no byte is read twice. All threads convert a raw
// tile (int4: one nibble plane) into swizzled bf16 K and V tiles of four
// boxes, V while Q K^T runs and the next K while P V runs, as at 128; the
// scales ride in the ring beside the raw tiles. S = Q K^T is one wgmma
// m64n64 group of 16 k16 steps (32 floats a thread); the scale, the key
// scale, the cap, the mask and exp2 in registers as above; O, 64 x 256 a
// warpgroup, is two m64n128 accumulators (128 floats a thread) fed by P
// as bf16 register operands and V read MN-major. Shared memory: ~193 KB
// (bf16) and ~196 KB (int8 / int4).

constexpr int DW = 256;                // the head width of this kernel
constexpr int DK = 64;                 // keys a tile
constexpr int D_STAGES = 2;
constexpr uint32_t BOX64 = 64 * 128;   // bytes of a [64][64] bf16 box
constexpr uint32_t D_TILE = 4 * BOX64;  // a [64][256] bf16 K or V tile
constexpr int D_SC = 2 * 128;          // scale floats a stage: K, then V

// bytes of a raw K (or V) tile as TMA brings it
template <typename KV>
__host__ __device__ constexpr uint32_t d_raw_bytes() {
  return sizeof(KV) == 2 ? D_TILE : 64u * 256u;
}

// 1024 bytes of alignment slack, Q, the ring (K then V a stage), [int8 /
// int4: the dequantized K and V tiles, the scales a stage and the scales
// of the tile in use (K then V, 64 each)], the full barriers, the counters
template <typename KV>
__host__ __device__ constexpr size_t d_smem_bytes() {
  return 1024 + 4 * size_t(BOX) + D_STAGES * 2 * size_t(d_raw_bytes<KV>()) +
         (sizeof(KV) == 1 ? 2 * D_TILE + (D_STAGES * D_SC + 2 * DK) * 4 : 0) +
         8 * D_STAGES + 4 * D_STAGES;
}

// a raw int8 tile (PACK false) or the nibble plane h of a raw int4 tile →
// its swizzled bf16 [64][256] tile, and the tile's 64 scales from the
// stage into `scales`; all threads
template <bool PACK>
__device__ __forceinline__ void dequantize256(const uint8_t* raw, int h,
                                              uint8_t* dst,
                                              const float* stage_scales,
                                              float* scales) {
  for (int e = threadIdx.x; e < DK * 16; e += NTHREADS) {
    const int r = e >> 4, c = e & 15;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * 256 + c * 16);
    const unsigned in[4] = {v.x, v.y, v.z, v.w};
    unsigned w[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (PACK)
        s4x4_bf16(in[i], h, w + 2 * i);
      else
        bf16x4(in[i] ^ 0x80808080u, w + 2 * i);
    }
    store_words<DW, DK>(dst, r, c, w);
  }
  if (threadIdx.x < DK) scales[threadIdx.x] = stage_scales[threadIdx.x];
  hopper::fence_proxy_async();  // the products read dst through TMA's proxy
}

template <typename KV, bool PACK>
__global__ void __launch_bounds__(NTHREADS, 1)
extend_d256_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const bf16* __restrict__ q,
                   const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales, bf16* __restrict__ out,
                   const int* __restrict__ kv_lens,
                   const int* __restrict__ q_offsets,
                   const int* __restrict__ row_ids,
                   const int* __restrict__ layer_ptr, Shape sh) {
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr uint32_t RAW = d_raw_bytes<KV>();
  static_assert(!PACK || QUANT, "packed rows are int8 bytes");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = hopper::align1024(smem_raw);
  uint8_t* ring = sQ + 4 * BOX;  // stage st: K, then V
  uint8_t* sKc = ring + D_STAGES * 2 * RAW;  // int8 / int4: dequantized
  uint8_t* sVc = sKc + D_TILE;
  float* sSc = reinterpret_cast<float*>(QUANT ? sVc + D_TILE : sKc);
  float* sScT = sSc + D_STAGES * D_SC;  // the scales of the tile in use
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(sSc) +
      (QUANT ? (D_STAGES * D_SC + 2 * DK) * 4 : 0));
  int* done = reinterpret_cast<int*>(full + D_STAGES);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int kvh = blockIdx.y, lb = blockIdx.z;
  const int G = sh.G, rows_total = G * sh.T, r0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid % 32;
  const int kv_len = min(kv_lens[lb], sh.S);
  const int q_off = q_offsets[lb];
  const int stripe = (*layer_ptr * sh.B + row_ids[lb]) * sh.Hkv + kvh;
  const float* Ks = QUANT ? k_scales + size_t(stripe) * sh.S : nullptr;
  const float* Vs = QUANT ? v_scales + size_t(stripe) * sh.S : nullptr;
  const int nbox = (sh.hd + 63) / 64;  // bf16 boxes that hold columns < hd

  // key tiles: from the one that holds the block's first visible key to
  // the causal limit of its last row. Raw tiles: bf16 / int8 one tile
  // each; int4 the packed rows (rt / 2) * 128 + (rt % 2) * 64 + [0, 64),
  // tiles 2 * rt (low nibbles) and 2 * rt + 1 (high), the pairing of
  // extend_kernel's tile_base
  const int last_rr = min(r0 + BQ, rows_total) - 1;
  const int kend = min(kv_len, q_off + last_rr / G + 1);
  const int kstart =
      sh.window > 0 ? max(0, q_off + r0 / G - sh.window + 1) : 0;
  const int rt0 = PACK ? first_tile(kstart, true) : kstart / DK;
  const int nraw = max(0, (PACK ? tile_count(kend, true)
                                : (kend + DK - 1) / DK) - rt0);
  const int ntiles = PACK ? 2 * nraw : nraw;

  // raw tile rt into ring stage st (K, V and their scales); one thread
  auto fill = [&](int st, int rt) {
    uint8_t* dst = ring + st * 2 * RAW;
    if constexpr (!QUANT) {
      const int kb = rt * DK;
      hopper::mbar_expect_tx(&full[st], 2 * nbox * BOX64);
      for (int i = 0; i < nbox; ++i) {
        hopper::tma_load_3d(dst + i * BOX64, &tm_k, &full[st], 64 * i, kb,
                            stripe);
        hopper::tma_load_3d(dst + RAW + i * BOX64, &tm_v, &full[st], 64 * i,
                            kb, stripe);
      }
    } else {
      const int kb = PACK ? tile_base(rt, true) : rt * DK;
      const int prow = PACK ? (rt >> 1) * 128 + (rt & 1) * 64 : kb;
      const uint32_t sbytes = PACK ? 4 * 256 : 2 * 4 * min(DK, sh.S - kb);
      hopper::mbar_expect_tx(&full[st], 2 * RAW + sbytes);
      hopper::tma_load_3d(dst, &tm_k, &full[st], 0, prow, stripe);
      hopper::tma_load_3d(dst + RAW, &tm_v, &full[st], 0, prow, stripe);
      float* sc = sSc + st * D_SC;
      if (PACK) {
        hopper::bulk_copy_1d(sc, Ks + kb, 256, &full[st]);
        hopper::bulk_copy_1d(sc + 64, Ks + kb + 128, 256, &full[st]);
        hopper::bulk_copy_1d(sc + 128, Vs + kb, 256, &full[st]);
        hopper::bulk_copy_1d(sc + 192, Vs + kb + 128, 256, &full[st]);
      } else {
        hopper::bulk_copy_1d(sc, Ks + kb, sbytes / 2, &full[st]);
        hopper::bulk_copy_1d(sc + 128, Vs + kb, sbytes / 2, &full[st]);
      }
    }
  };

  if (tid == 0) {
    for (int st = 0; st < D_STAGES; ++st) {
      hopper::mbar_init(&full[st], 1);
      done[st] = 0;
    }
    hopper::fence_barrier_init();
  }
  if constexpr (QUANT) {  // scales past S stay finite (zeros)
    for (int i = tid; i < D_STAGES * D_SC; i += NTHREADS) sSc[i] = 0.f;
  } else {  // the ring's boxes past hd stay zeros
    for (int e = tid; e < D_STAGES * 2 * (4 - nbox) * int(BOX64 / 16);
         e += NTHREADS) {
      const int per = (4 - nbox) * int(BOX64 / 16), t = e / per;
      reinterpret_cast<uint4*>(ring + t * D_TILE + nbox * BOX64)[e % per] =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  load_q<DW>(sQ, q, sh, lb, kvh, r0);
  hopper::fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(D_STAGES, nraw); ++j) fill(j, rt0 + j);

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

  float o0[64], o1[64], s[32];  // O's columns [0, 128) and [128, 256)
#pragma unroll
  for (int i = 0; i < 64; ++i) o0[i] = o1[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint64_t dq = hopper::desc_k(sQ + cw * 64 * 128);
  uint32_t pa[4][4];

  // int8 / int4: tile j's K is converted while tile j - 1's P V runs (tile
  // 0's here), its V while its own Q K^T runs; two block barriers a tile
  // order the conversions against the products
  if constexpr (QUANT) {
    if (ntiles > 0) {
      hopper::mbar_wait(&full[0], 0);
      dequantize256<PACK>(ring, 0, sKc, sSc, sScT);
    }
  }
  for (int j = 0; j < ntiles; ++j) {
    const int rj = PACK ? j >> 1 : j, h = PACK ? j & 1 : 0;
    const int st = rj % D_STAGES;
    const int kb = PACK ? tile_base(rt0 + rj, true) + 128 * h
                        : (rt0 + rj) * DK;
    uint8_t* raw = ring + st * 2 * RAW;
    const uint8_t* tK = raw;
    const uint8_t* tV = raw + RAW;
    if constexpr (QUANT) {
      // K(j) is converted and tile j - 1's products are done everywhere
      __syncthreads();
      tK = sKc;
      tV = sVc;
    } else {
      hopper::mbar_wait(&full[st], (rj / D_STAGES) & 1);
    }

    // S = Q K^T, the warpgroup's 64 rows x 64 keys
    const uint64_t dk = hopper::desc_k(tK);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW / 16; ++kk)
      hopper::mma_64x64_ss(s, hopper::desc_add(dq, k_step<DW>(kk)),
                           hopper::desc_add(dk, (kk / 4) * BOX64 +
                                                    (kk % 4) * 32),
                           kk);
    hopper::wgmma_commit();
    if constexpr (QUANT)
      dequantize256<PACK>(raw + RAW, h, sVc, sSc + st * D_SC + 128 + 64 * h,
                          sScT + DK);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // logits (log2 units): scale, key scale, cap; the mask where a key of
    // the tile is past kv_len, above a row's position or below its window
    const int kmax = kb + DK - 1;
    const bool masked = kmax >= kv_len || kmax > pmin ||
                        (sh.window > 0 && kb <= pmax - sh.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
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
        const int key = kb + col;
        const int p = qp[acc_half(i)];
        const bool vis = key < kv_len && key <= p &&
                         (sh.window <= 0 || key > p - sh.window);
        if (!vis) x = -INFINITY;
      }
      s[i] = x;
    }
    float mx[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[acc_half(i)] = fmaxf(mx[acc_half(i)], s[i]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      alpha[hf] = exp2f(m[hf] - mx[hf]);
      m[hf] = mx[hf];
      l[hf] *= alpha[hf];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - m[acc_half(i)]);
      l[acc_half(i)] += s[i];
    }
    if constexpr (QUANT) {
      // V(j) is converted everywhere; the raw stage is free once its last
      // tile's V is (int4: the high plane)
      __syncthreads();
      if (tid == 0 && (!PACK || h == 1) && rj + D_STAGES < nraw)
        fill(st, rt0 + rj + D_STAGES);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= sScT[DK + acc_col(i, lane)];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      o0[i] *= alpha[acc_half(i)];
      o1[i] *= alpha[acc_half(i)];
    }

    // O += P V, each half of the head from two of V's boxes
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(s, kk, pa[kk]);
    const uint64_t dv0 = hopper::desc_mn(tV, BOX64);
    const uint64_t dv1 = hopper::desc_mn(tV + 2 * BOX64, BOX64);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      hopper::mma_64x128_rs(o0, pa[kk], hopper::desc_add(dv0, kk * 2048));
      hopper::mma_64x128_rs(o1, pa[kk], hopper::desc_add(dv1, kk * 2048));
    }
    hopper::wgmma_commit();
    if constexpr (QUANT) {
      if (j + 1 < ntiles) {  // every warpgroup is past its Q K^T of tile j
        const int r1 = PACK ? (j + 1) >> 1 : j + 1, h1 = PACK ? (j + 1) & 1 : 0;
        const int st1 = r1 % D_STAGES;
        if (r1 != rj) hopper::mbar_wait(&full[st1], (r1 / D_STAGES) & 1);
        dequantize256<PACK>(ring + st1 * 2 * RAW, h1, sKc,
                            sSc + st1 * D_SC + 64 * h1, sScT);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o0);
    hopper::fence_regs(o1);
    if constexpr (!QUANT) {
      if (release(done, st) && lane == 0 && rj + D_STAGES < nraw)
        fill(st, rt0 + rj + D_STAGES);
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const int rr = rr0 + 8 * hf;
    if (rr < rows_total) {
      const int t = rr / G, g = rr % G;
      bf16* dst = out + ((size_t(lb) * sh.T + t) * sh.Hq + kvh * G + g) * sh.hd;
      const float mul = 1.f / fmaxf(l[hf], 1e-30f);
      store_row(dst, o0, hf, lane, mul, sh.hd);
      store_row(dst + 128, o1, hf, lane, mul, sh.hd - 128);
    }
  }
}

// the kernel of width W (64, 96, 128: extend_kernel; 256:
// extend_d256_kernel) over (G * T / BQ, Hkv, Bk), the rows as the 3-D map
// (head_dim, rows, L * B * Hkv): bf16 boxes of Head<W>'s columns x `keys`
// rows under its swizzle, int8 / int4 boxes of W bytes x `keys` rows;
// columns past head_dim read as zeros
template <int W, typename KV, bool PACK>
int launch_at(const void* q, const void* k_rows, const void* v_rows,
              const void* k_scales, const void* v_scales, void* out,
              const void* kv_lens, const void* q_offsets,
              const void* row_ids, const void* layer, int Bk, int L,
              const Shape& sh, void* stream) {
  using H = Head<W>;
  constexpr bool QUANT = sizeof(KV) == 1, WIDE = W == DW;
  const int keys = WIDE ? DK : (PACK ? 64 : BK);
  const long long stripes = (long long)L * sh.B * sh.Hkv;
  const int rows = PACK ? sh.S / 2 : sh.S;
  CUtensorMap mk, mv;
  const bool ok =
      QUANT ? hopper::map_stripes(&mk, k_rows, 1, sh.hd, rows, stripes, W,
                                  keys, false) &&
                  hopper::map_stripes(&mv, v_rows, 1, sh.hd, rows, stripes,
                                      W, keys, false)
            : hopper::map_stripes(&mk, k_rows, 2, 2 * sh.hd, sh.S, stripes,
                                  H::BC, keys, H::SWIZZLE) &&
                  hopper::map_stripes(&mv, v_rows, 2, 2 * sh.hd, sh.S,
                                      stripes, H::BC, keys, H::SWIZZLE);
  if (!ok) return int(cudaErrorInvalidValue);
  const void* fn;
  size_t smem;
  if constexpr (WIDE) {
    fn = reinterpret_cast<const void*>(extend_d256_kernel<KV, PACK>);
    smem = d_smem_bytes<KV>();
  } else {
    fn = reinterpret_cast<const void*>(extend_kernel<W, KV, PACK>);
    smem = smem_bytes<W, KV, PACK>();
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((sh.G * sh.T + BQ - 1) / BQ, sh.Hkv, Bk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  bf16* o = static_cast<bf16*>(out);
  const int* lens = static_cast<const int*>(kv_lens);
  const int* offs = static_cast<const int*>(q_offsets);
  const int* rids = static_cast<const int*>(row_ids);
  const int* lay = static_cast<const int*>(layer);
  if constexpr (WIDE)
    extend_d256_kernel<KV, PACK><<<grid, NTHREADS, smem, st>>>(
        mk, mv, qp, ks, vs, o, lens, offs, rids, lay, sh);
  else
    extend_kernel<W, KV, PACK><<<grid, NTHREADS, smem, st>>>(
        mk, mv, qp, ks, vs, o, lens, offs, rids, lay, sh);
  return int(cudaGetLastError());
}

template <typename KV, bool PACK>
int launch(const void* q, const void* k_rows, const void* v_rows,
           const void* k_scales, const void* v_scales, void* out,
           const void* kv_lens, const void* q_offsets, const void* row_ids,
           const void* layer, int Bk, int T, int Hq, int Hkv, int L, int B,
           int S, int head_dim, float scale, int window, float cap,
           float inv_cap, void* stream) {
  constexpr bool QUANT = sizeof(KV) == 1;
  // head_dim % 16: an int8 row of head_dim bytes is a TMA stride
  if (head_dim < 16 || head_dim > 256 || head_dim % 16 != 0 ||
      Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 ||
      Bk <= 0 || Bk > 65535 || T <= 0 || L <= 0 || B <= 0 || S <= 0 ||
      (PACK && S % 256 != 0) || (QUANT && S % 4 != 0) || cap < 0.f)
    return int(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const Shape sh{T,      Hq,    Hkv, B,   S,      G,
                 window, head_dim, scale, cap, inv_cap};
#define AURORA_EXTEND_ARGS                                                 \
  q, k_rows, v_rows, k_scales, v_scales, out, kv_lens, q_offsets, row_ids, \
      layer, Bk, L, sh, stream
  if (head_dim <= 64) return launch_at<64, KV, PACK>(AURORA_EXTEND_ARGS);
  if (head_dim <= 96) return launch_at<96, KV, PACK>(AURORA_EXTEND_ARGS);
  if (head_dim <= 128) return launch_at<128, KV, PACK>(AURORA_EXTEND_ARGS);
  return launch_at<DW, KV, PACK>(AURORA_EXTEND_ARGS);
#undef AURORA_EXTEND_ARGS
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

// the kernel of a mode ("bf16", "int8", "int4"; kernel width 128, or with
// "_hd64" or "_hd96" extend_kernel at that width, with "_hd256"
// extend_d256_kernel) and its dynamic shared bytes, for
// aurora_kernel_attrs
extern "C" int aurora_ragged_extend_kernel(const char* mode, const void** fn,
                                           int* smem) {
#define AURORA_EXTEND_FN(M, KERNEL, SMEM)        \
  if (strcmp(mode, M) == 0) {                    \
    *fn = reinterpret_cast<const void*>(KERNEL); \
    *smem = int(SMEM);                           \
    return 0;                                    \
  }
#define AURORA_EXTEND_MODES(S, W)                                          \
  AURORA_EXTEND_FN("bf16" S, (extend_kernel<W, bf16, false>),             \
                   (smem_bytes<W, bf16, false>()))                         \
  AURORA_EXTEND_FN("int8" S, (extend_kernel<W, int8_t, false>),           \
                   (smem_bytes<W, int8_t, false>()))                       \
  AURORA_EXTEND_FN("int4" S, (extend_kernel<W, int8_t, true>),            \
                   (smem_bytes<W, int8_t, true>()))
  AURORA_EXTEND_MODES("_hd64", 64)
  AURORA_EXTEND_MODES("_hd96", 96)
  AURORA_EXTEND_MODES("", 128)
  AURORA_EXTEND_FN("bf16_hd256", (extend_d256_kernel<bf16, false>),
                   d_smem_bytes<bf16>())
  AURORA_EXTEND_FN("int8_hd256", (extend_d256_kernel<int8_t, false>),
                   d_smem_bytes<int8_t>())
  AURORA_EXTEND_FN("int4_hd256", (extend_d256_kernel<int8_t, true>),
                   d_smem_bytes<int8_t>())
#undef AURORA_EXTEND_MODES
#undef AURORA_EXTEND_FN
  return int(cudaErrorInvalidValue);
}
