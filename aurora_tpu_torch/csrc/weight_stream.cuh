// The tensor-core weight streamers of the decode matmuls, sm_90a: the
// block shape, the ring of stages that one producer warp fills by TMA,
// the mma.sync wrappers, the W4A8 unit on the int8 tensor cores, the W4
// dequantization to bf16 fragments and the deterministic split-K ending.
// Used by w8a8_matmul.cu (`w8a8_kernel`), w4_flat_matmul.cu
// (`w4a16_kernel`), w4a8_matmul.cu (`w4a8_kernel`, stripe and flat W4)
// and fused_mlp_w4.cu.
//
// What bounds them on the H100: at decode (B <= 64 token rows) each
// weight byte feeds at most 2 * 64 int8 operations (W8) or 4 * 64 bf16
// ones (W4), below the ~590 int8 and ~295 bf16 operations a byte at which
// the tensor cores' peaks take over from HBM's 3.35 TB/s, so the weight
// stream is the bound; the design keeps enough of it in flight and reads
// it once whatever B is.
//
// Shape of a launch, planned on the host by `weight_plan`
// (ops/pallas/quant_matmul.py): a grid of (column tile, K split) blocks,
// as many splits as let every block of the grid sit on the card at once
// (the kernel's occupancy: one wave, no tail). A block owns BN = 128
// output channels and the K range [split * span, min((split + 1) * span,
// K)), span a multiple of the plan's group. The weights are the mma's A
// operand (M = output channels) and the token rows its B operand (N =
// tokens, n8 tiles): every weight fragment is loaded and dequantized once
// and serves every token tile, so the weights cross HBM once for any
// B <= 64.
//
// The block has 9 warps. Warp PRODUCER fills a ring of NS stages of SK k
// values each: a TMA box of the weight tile and boxes of the token rows'
// activations (the 128-byte swizzle; rows past B, columns past N or K
// read as zeros), and for W4 the scale rows the stage touches (1-D bulk
// copies, or 4-byte cp.async by the producer's lanes where they are
// strided); each stage completes on its `full` mbarrier, and is refilled
// once the 8 consumer warps have arrived on its `empty` mbarrier.
// Consumer warps split the tile's channels and the stage's k between
// them (W8A8, W4A16: 2 channel slices of 64 by 4 k-slices of the mma
// k-steps; W4A8: `A8` below, k-slices of whole scale groups). At the end
// the k-slices' partial sums meet in shared memory (the ring's bytes,
// read no more) and are added in k-slice order. With one split the block
// then writes the output. With more, each block stores its partial to
// part[split][B][N] and takes a ticket on its column tile; the last block
// adds the partials in split order, writes the output and resets the
// ticket. The sums are thus taken in the same order whichever block comes
// last, and every run gives the same bits. part and the tickets are per
// device and reused by every launch (see quant_matmul.py), so launches of
// one kernel on one device must not overlap.

#pragma once

#include "hopper_common.cuh"
#include "w4_common.cuh"

namespace ws {

constexpr int BN = 128;                    // output channels per block
constexpr int CW = BN / 64;                // channel slices of 64
constexpr int KW = 4;                      // k-slices
constexpr int CONSUMERS = 32 * CW * KW;    // 256 threads
constexpr int PRODUCER = CW * KW;          // the producer's warp index
constexpr int NT = CONSUMERS + 32;
constexpr int NS = 4;                      // stages in the ring
constexpr int SK = 128;                    // k values a stage

// Fragment row (or column) g of an mma reads tile row 8i + spread(g) of
// a box with the 128-byte swizzle: the rows of one half-warp's 8-byte
// reads (g < 4, g >= 4) are then 0, 2, 4, 6 and 1, 3, 5, 7 mod 8, whose
// 16-byte chunk pairs the swizzle puts on distinct banks. spread4 does
// the same for 16-byte reads, a quarter-warp (g 0-1, 2-3, ...) at a time:
// rows 0, 4, then 1, 5, ...
__host__ __device__ constexpr int spread(int g) {
  return ((g & 3) << 1) | (g >> 2);
}
__host__ __device__ constexpr int spread4(int g) {
  return ((g & 1) << 2) | (g >> 1);
}

// token tiles of 8 for B rows: the kernels are instantiated for 1, 2, 4
// and 8, which sizes the accumulators
inline int token_tiles(int B) {
  return B <= 8 ? 1 : B <= 16 ? 2 : B <= 32 ? 4 : 8;
}

// blocks an SM should hold (ptxas caps the registers to fit them): three
// at one or two token tiles, so that a plan of three blocks an SM runs
// in one wave
__host__ __device__ constexpr int min_blocks(int TT) {
  return TT <= 2 ? 3 : 1;
}

// dynamic shared bytes of a block: the ring of NS stages of `stage`
// bytes, or the ending's `red` bytes where more, and the 1024-byte
// alignment
inline size_t ring_smem(size_t stage, size_t red) {
  const size_t ring = NS * stage;
  return (ring > red ? ring : red) + 1024;
}

struct Bars {
  uint64_t full[NS];
  uint64_t empty[NS];
  int last;
};

__device__ __forceinline__ void init_bars(Bars& b) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&b.full[s], 1);
      hopper::mbar_init(&b.empty[s], CW * KW);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// barrier 1 over the consumer warps (the producer may have exited)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// the producer, before it fills the ring's i-th stage: wait until every
// consumer warp has released the slot's previous stage; → the slot
__device__ __forceinline__ int producer_acquire(Bars& b, int i) {
  if (i >= NS) hopper::mbar_wait(&b.empty[i % NS], ((i / NS) - 1) & 1);
  return i % NS;
}

// a consumer warp, before it reads the ring's i-th stage; → the slot
__device__ __forceinline__ int consumer_wait(Bars& b, int i) {
  hopper::mbar_wait(&b.full[i % NS], (i / NS) & 1);
  return i % NS;
}

__device__ __forceinline__ void consumer_release(Bars& b, int slot) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&b.empty[slot]);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// the mbarrier's phase waits, besides its arrivals, for this thread's
// cp.async copies so far
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                   hopper::smem_u32(bar))
               : "memory");
}

// D[16][8] += A[16][16] . B[16][8], bf16 in, fp32 accumulation. Fragments
// (g = lane / 4, q = lane % 4): a0 (row g, k 2q, 2q + 1), a1 (row g + 8,
// same k), a2 (row g, k 2q + 8, 2q + 9), a3 (row g + 8, those k); b0 (k
// 2q, 2q + 1, column g), b1 (k 2q + 8, 2q + 9); d0, d1 (row g, columns
// 2q, 2q + 1), d2, d3 (row g + 8). The lower k of a pair in the low half.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D[16][8] += A[16][32] . B[32][8], int8 in, exact int32 accumulation;
// the fragments of mma_bf16 with 4 k values a register: a0 (row g, k
// 4q .. 4q + 3), a2 (row g, k 16 + 4q ..), b0 (k 4q .., column g), b1
// (k 16 + 4q ..)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- W4A16
// bf16x2 of the two nibbles at bits 0-3 and 16-19 of t, times s2 (the
// bf16 scale pair): (nibble & 0xF) ^ 0x4308 is the bf16 of 128 + (v + 8)
// for the signed value v, less 136 (exact) gives v, and one bf16 multiply
// rounds v * s once: bf16(bf16(v) * bf16(s)), since v * s is exact in
// fp32 (w4_flat_matmul.cu's W4A16 kernel and the fused MLP's down stream)
__device__ __forceinline__ uint32_t dq_pair(uint32_t t, uint32_t s2) {
  const uint32_t v = (t & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const uint32_t k136 = 0x43084308u;
  x = __hsub2(x, *reinterpret_cast<const __nv_bfloat162*>(&k136));
  x = __hmul2(x, *reinterpret_cast<const __nv_bfloat162*>(&s2));
  return *reinterpret_cast<uint32_t*>(&x);
}

// The B fragment of bf16 token row `row` for k 4q .. 4q + 3 of k-step j
// (16 k) from boxes of `abox` bytes (rows of 128 bytes, 64 k, 128-byte
// swizzle): (k 4q, 4q + 2), (k 4q + 1, 4q + 3), the pairing of the W4A16
// A fragment below
__device__ __forceinline__ void act_pair_bf16(const uint8_t* act, int abox,
                                              int row, int j, int q,
                                              uint32_t& b0, uint32_t& b1) {
  const uint8_t* box = act + (j >> 2) * abox;
  const uint2 u = *reinterpret_cast<const uint2*>(
      box + hopper::swz128(row, 2 * (j & 3) + (q >> 1)) + 8 * (q & 1));
  b0 = __byte_perm(u.x, u.y, 0x5410);
  b1 = __byte_perm(u.x, u.y, 0x7632);
}

// The A fragments of W4A16 k-step j from a box of flat W4 (64 packed rows
// of 128 columns, 128-byte swizzle, packed row p holding k 2p and 2p + 1
// of each column): thread (g, q) owns the 8 consecutive columns col ..
// col + 7 and the packed rows 8j + 2q and 8j + 2q + 1, whose bytes give,
// column by column, bf16 pairs (k 2p, 2p + 2) and (k 2p + 1, 2p + 3):
// fragment k pairs q and q + 4. Column col + jj is fragment row jj / 2 *
// 16 + jj % 2 * 8 + g; s2[jj] its bf16 scale pair. off0 / off1: the
// thread's byte offsets of its two rows at j = 0 (the swizzle repeats
// every 8 rows, so step j adds 1024 j).
__device__ __forceinline__ void w4a16_frag(const uint8_t* box, int off0,
                                           int off1, int j,
                                           const uint32_t (&s2)[8],
                                           uint32_t (&a)[4][4]) {
  const uint2 wa = *reinterpret_cast<const uint2*>(box + 1024 * j + off0);
  const uint2 wb = *reinterpret_cast<const uint2*>(box + 1024 * j + off1);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const uint32_t t = __byte_perm(jj < 4 ? wa.x : wa.y, jj < 4 ? wb.x : wb.y,
                                   (jj & 3) | ((4 + (jj & 3)) << 8));
    a[jj >> 1][jj & 1] = dq_pair(t, s2[jj]);
    a[jj >> 1][2 + (jj & 1)] = dq_pair(t >> 4, s2[jj]);
  }
}

// ---------------------------------------------------------------- W4A8
// W4A8 on the int8 tensor cores (w4a8_matmul.cu, fused_mlp_w4.cu). The
// token rows' int8 activations come as two planes he (even k) and ho
// (odd k), byte p of each lining up with packed byte p (k 2p in the low
// nibble, 2p + 1 in the high one). A word w of four packed bytes of one
// channel gives 16 x its four low nibbles as (w << 4) & 0xF0F0F0F0 and
// 16 x its four high ones as w & 0xF0F0F0F0, signed int8 each: the A
// registers of one mma m16n8k32 whose k 4q .. and 16 + 4q .. take the
// same four bytes of he and of ho as B. One mma is thus 16 x the exact
// int32 dot of 16 packed bytes (32 k), in a permutation of k shared by A
// and B, which the exact int32 sum does not see.
//
// The weight-fragment policy (A8Warp's FLAT) says where a thread finds
// those words. Stripes (w4a8_matmul_tiled, the fused MLP's gate/up): a
// weight box holds channel rows of packed W4 (128 bytes, 256 k, a row),
// so a word is four consecutive bytes of one row. A unit is the k a
// thread reads at once from each of its rows: RW = 16 bytes (groups of a
// multiple of 128 k) make a unit of 64 packed bytes (128 k, four mma):
// thread q reads chunk 4u + q of the 128-byte row, and word i of it
// feeds mma i; RW = 4 (groups of 32 or 64 k) a unit of one 16-byte chunk
// (32 k, one mma): thread q reads its bytes 4q .. 4q + 3. Fragment row
// (and token column) g reads box row 8i + a8_row<RW>(g), so that the
// reads of a quarter-warp (RW 16) or of the warp (RW 4) fall on distinct
// banks.
//
// Flat (w4a8_matmul): the reference's K-major layout, a weight box of
// 128 packed rows x 128 channels, so consecutive bytes are consecutive
// channels. Thread (g, q) owns the 2 MT consecutive channels c0 + 2 MT g
// .. + 2 MT - 1 (W4A16's ownership): column jj is fragment row g + 8
// (jj % 2) of m-tile jj / 2. mma i of unit u covers the 16 packed rows
// of chunk NW u + i (NW = RW / 4 mma a unit, as above), and thread q
// reads its rows 4q .. 4q + 3 there (2 MT bytes each); a 4 x 4 byte
// transpose (__byte_perm) per 4 channels turns them into one word of
// four consecutive packed bytes a channel. B is bytes 4q .. 4q + 3 of
// the chunk in he / ho for token row 8i + g, on distinct banks across
// the warp. The weight reads of q and q + 2 share a swizzle phase (2-way
// bank conflicts); an order of the rows that avoids them read no faster
// on an H100 (PERF.md §6).
//
// A unit never spans two scale groups, and the warps split k by whole
// groups, so a group's int32 partial is whole in its accumulator when
// the group ends: it is shifted down by 4 (exact), converted, multiplied
// by the group's scale with one rounding (__fmul_rn: no fma contraction,
// the plain twin's rounded product) and added to the fp32 sum. Only the
// order of the sum over the groups then differs from the twin
// (quant_matmul.py `_w4a8_fp32`).

template <int RW>
__host__ __device__ constexpr int a8_row(int g) {
  return RW == 16 ? spread4(g) : g;
}

// the consumer geometry at TT token tiles over a box of CB channel rows
// (128, or 64 for the fused MLP's small blocks): MT m-tiles of 16
// channels a warp, CW channel slices, TW token slices of TPW tiles each,
// KW group slices (slice kw takes the groups g with g % KW == kw; the
// same KW for both CB). A warp holds an int32 and an fp32 accumulator for
// each of its TPW x MT tiles: MT falls past one token tile (2 blocks an
// SM cap a thread at 96 registers) and the tokens split at 8 tiles (one
// block an SM, 168 registers), so that no geometry spills
template <int TT, int CB = BN>
struct A8 {
  static constexpr int MT = (TT == 1 ? 4 : 2) * CB / BN;
  static constexpr int TW = TT == 8 ? 2 : 1;
  static constexpr int TPW = TT / TW;
  static constexpr int CW = CB / (16 * MT);
  static constexpr int KW = (CONSUMERS / 32) / (CW * TW);
  // warp w's (channel slice, token slice, group slice)
  __device__ static int cw(int w) { return w % CW; }
  __device__ static int tw(int w) { return (w / CW) % TW; }
  __device__ static int kw(int w) { return w / (CW * TW); }
};

__device__ __forceinline__ uint32_t lo16(uint32_t w) {
  return (w << 4) & 0xF0F0F0F0u;
}
__device__ __forceinline__ uint32_t hi16(uint32_t w) {
  return w & 0xF0F0F0F0u;
}

template <int RW>
__device__ __forceinline__ void ld_words(uint32_t (&v)[RW / 4],
                                         const uint8_t* p) {
  if constexpr (RW == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// 4 x 4 byte transpose: v[t] holds four channels' bytes of packed row t
// → x[c] the four rows' bytes of channel c, row 0 in the low byte
__device__ __forceinline__ void transpose4(const uint32_t (&v)[4],
                                           uint32_t* x) {
  const uint32_t t01l = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t t01h = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t23l = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t23h = __byte_perm(v[2], v[3], 0x7362);
  x[0] = __byte_perm(t01l, t23l, 0x5410);
  x[1] = __byte_perm(t01l, t23l, 0x7632);
  x[2] = __byte_perm(t01h, t23h, 0x5410);
  x[3] = __byte_perm(t01h, t23h, 0x7632);
}

// One consumer warp's W4A8 state: ai the int32 partials (16 x) of its
// current group, af the fp32 sums of the groups done, for its TPW token
// tiles (from tile t0) x MT m-tiles; c0 the warp's first channel of the
// box; FLAT the weight-fragment policy (above).
template <int TT, int RW, int CB = BN, bool FLAT = false>
struct A8Warp {
  static constexpr int MT = A8<TT, CB>::MT;
  static constexpr int TPW = A8<TT, CB>::TPW;
  static constexpr int NW = RW / 4;      // mma k-steps of a unit
  static_assert(!FLAT || (CB == BN && (MT == 2 || MT == 4)),
                "flat fragments: 4 or 8 channels a thread");
  int t0;
  int ai[TPW][MT][4];
  float af[TPW][MT][4];

  // the token row of fragment column g in its tile, and the box channel
  // of fragment row g + 8 h of m-tile mt
  __device__ static int trow(int g) { return FLAT ? g : a8_row<RW>(g); }
  __device__ static int chan(int c0, int mt, int h, int g) {
    return FLAT ? c0 + 2 * MT * g + 2 * mt + h
                : c0 + 16 * mt + 8 * h + a8_row<RW>(g);
  }

  __device__ __forceinline__ void clear(int tile0) {
    t0 = tile0;
#pragma unroll
    for (int t = 0; t < TPW; ++t)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ai[t][mt][e] = 0;
          af[t][mt][e] = 0.f;
        }
  }

  // unit u of a stage: the weight box at w (rows of 128 bytes), the
  // planes' boxes at he and ho (8 * TT rows each)
  __device__ __forceinline__ void unit(const uint8_t* w, const uint8_t* he,
                                       const uint8_t* ho, int c0, int u,
                                       int g, int q) {
    if constexpr (FLAT)
      unit_flat(w, he, ho, c0, u, g, q);
    else
      unit_stripe(w, he, ho, c0, u, g, q);
  }

  // unit u of a stripe weight box (128 channel rows of 128 packed bytes)
  __device__ __forceinline__ void unit_stripe(const uint8_t* w,
                                              const uint8_t* he,
                                              const uint8_t* ho, int c0,
                                              int u, int g, int q) {
    const int chunk = RW == 16 ? 4 * u + q : u;
    const int off = RW == 16 ? 0 : 4 * q;
    const int rg = a8_row<RW>(g);
    // the weight words: held across the token tiles where MT is 1 or 2,
    // read again for each tile at MT 4 (registers for 2 blocks an SM)
    uint32_t wv[MT][2][NW];
    auto load_w = [&]() {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ld_words<RW>(wv[mt][h], w + hopper::swz128(c0 + 16 * mt + 8 * h +
                                                         rg, chunk) + off);
    };
    if constexpr (MT != 4) load_w();
#pragma unroll
    for (int t = 0; t < TPW; ++t) {
      if constexpr (MT == 4) load_w();
      uint32_t e[NW], o[NW];
      const uint32_t at = hopper::swz128(8 * (t0 + t) + rg, chunk) + off;
      ld_words<RW>(e, he + at);
      ld_words<RW>(o, ho + at);
#pragma unroll
      for (int i = 0; i < NW; ++i)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t a[4] = {lo16(wv[mt][0][i]), lo16(wv[mt][1][i]),
                                 hi16(wv[mt][0][i]), hi16(wv[mt][1][i])};
          mma_s8(ai[t][mt], a, e[i], o[i]);
        }
    }
  }

  // unit u of a flat weight box (128 packed rows of 128 channels)
  __device__ __forceinline__ void unit_flat(const uint8_t* w,
                                            const uint8_t* he,
                                            const uint8_t* ho, int c0, int u,
                                            int g, int q) {
    constexpr int CPT = 2 * MT;            // channels a thread
    const int col = c0 + CPT * g;
    // the thread's four rows of chunk 0; the swizzle repeats every 8
    // rows, so chunk c adds 2048 c
    int off[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      off[t] = hopper::swz128(4 * q + t, col >> 4) + (col & 15);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int chunk = NW * u + i;
      const uint8_t* wc = w + 2048 * chunk;
      uint32_t x[CPT];
      if constexpr (MT == 4) {
        uint32_t v0[4], v1[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint2 d = *reinterpret_cast<const uint2*>(wc + off[t]);
          v0[t] = d.x;
          v1[t] = d.y;
        }
        transpose4(v0, x);
        transpose4(v1, x + 4);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[t] = *reinterpret_cast<const uint32_t*>(wc + off[t]);
        transpose4(v, x);
      }
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = lo16(x[2 * mt]);
        a[mt][1] = lo16(x[2 * mt + 1]);
        a[mt][2] = hi16(x[2 * mt]);
        a[mt][3] = hi16(x[2 * mt + 1]);
      }
#pragma unroll
      for (int t = 0; t < TPW; ++t) {
        const uint32_t at = hopper::swz128(8 * (t0 + t) + g, chunk) + 4 * q;
        const uint32_t e = *reinterpret_cast<const uint32_t*>(he + at);
        const uint32_t o = *reinterpret_cast<const uint32_t*>(ho + at);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(ai[t][mt], a[mt], e, o);
      }
    }
  }

  // the current group ends: sc holds its scales of the box's CB channels
  __device__ __forceinline__ void flush(const float* sc, int c0, int g) {
    float s[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) s[mt][h] = sc[chan(c0, mt, h, g)];
#pragma unroll
    for (int t = 0; t < TPW; ++t)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          af[t][mt][e] += __fmul_rn(float(ai[t][mt][e] >> 4), s[mt][e >> 1]);
          ai[t][mt][e] = 0;
        }
  }

  // every unit of one stage that falls in this warp's groups: the
  // stage's k are [kc, kc + len), groups of 1 << lg k (a power of two of
  // at least 8 * RW), the stage's scale rows sc[(grp - (kc >> lg)) * CB +
  // channel]
  __device__ __forceinline__ void stage(const uint8_t* w, const uint8_t* he,
                                        const uint8_t* ho, const float* sc,
                                        int kc, int len, int lg, int kw,
                                        int c0, int g, int q) {
    constexpr int UK = 8 * RW;             // k of a unit
    constexpr int KW = A8<TT, CB>::KW;
    const int g0 = kc >> lg;
    for (int u = 0; u * UK < len; ++u) {
      const int k = kc + u * UK, grp = k >> lg;
      if ((grp & (KW - 1)) != kw) continue;
      unit(w, he, ho, c0, u, g, q);
      if (((k + UK) & ((1 << lg) - 1)) == 0)
        flush(sc + (grp - g0) * CB, c0, g);
    }
  }

  // output (token, channel) of accumulator element (t, mt, e): tok =
  // 8 (t0 + t) + trow(2 q + e % 2), channel chan(c0, mt, e / 2, g)
  template <typename F>
  __device__ __forceinline__ void each(int c0, int g, int q, F f) const {
#pragma unroll
    for (int t = 0; t < TPW; ++t)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(8 * (t0 + t) + trow(2 * q + (e & 1)), chan(c0, mt, e >> 1, g),
            af[t][mt][e]);
  }
};

// The consumers' ending. red holds the nk k-slices' partial sums
// [nk][B][BN] (T: float or int) in shared memory, written by every
// consumer thread before the call. store(b, n, sum) writes output (b, n)
// of the column tile at n0; part and tickets serve nsplit > 1.
template <typename T, typename Store>
__device__ __forceinline__ void finish(Bars& bars, const T* red, T* part,
                                       int* tickets, int B, int N, int n0,
                                       int split, int nsplit, Store store,
                                       int nk = KW) {
  consumers_sync();
  const int nv = min(BN, N - n0);
  const int tid = threadIdx.x;
  for (int e = tid; e < B * BN; e += CONSUMERS) {
    const int b = e / BN, c = e % BN;
    if (c >= nv) continue;
    T v = red[size_t(b) * BN + c];
    for (int k = 1; k < nk; ++k) v += red[(size_t(k) * B + b) * BN + c];
    if (nsplit == 1)
      store(b, n0 + c, v);
    else
      part[(size_t(split) * B + b) * N + n0 + c] = v;
  }
  if (nsplit == 1) return;
  __threadfence();
  consumers_sync();
  if (tid == 0) bars.last = atomicAdd(&tickets[blockIdx.x], 1) == nsplit - 1;
  consumers_sync();
  if (!bars.last) return;
  __threadfence();
  // four outputs a thread at a time, their splits' loads issued together:
  // each sum still runs in split order
  const size_t step = size_t(B) * N;
  for (int e0 = tid; e0 < B * BN; e0 += 4 * CONSUMERS) {
    const T* p[4];
    bool ok[4];
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * CONSUMERS, b = e / BN, c = e % BN;
      ok[u] = e < B * BN && c < nv;
      p[u] = part + size_t(ok[u] ? b : 0) * N + n0 + (ok[u] ? c : 0);
      v[u] = __ldcg(p[u]);
    }
#pragma unroll 4
    for (int s = 1; s < nsplit; ++s) {
      T x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = __ldcg(p[u] + s * step);
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] += x[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * CONSUMERS;
      if (ok[u]) store(e / BN, n0 + e % BN, v[u]);
    }
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}

}  // namespace ws
