// Grouped-expert matmul of the MoE layers: rows sorted by expert times
// that expert's weight stack, with bf16 or int8 experts, sm_90a.
//
// Replaces: no Pallas kernel. The reference's MoE (aurora_tpu/ops/moe.py
// `moe_mlp_grouped`) calls `lax.ragged_dot`, which XLA lowers to the TPU's
// grouped-matmul kernel; this is its counterpart. Contract, for xs [M, K]
// bf16 (token copies sorted by expert), w [E, K, N] (bf16, or int8 with an
// fp32 scale [E, N] per expert and output channel) and offsets [E + 1]
// int32 on the device (expert e owns rows [offsets[e], offsets[e + 1])):
//   out[m, n] = sum_k xs[m, k] * W_e[k, n]   for m in expert e's rows,
// products exact in fp32 and summed in fp32, rounded to the output type
// (bf16 for gate and up, fp32 for down, as the reference's
// preferred_element_type and casts give them). Int8 experts dequantize as
// the reference's `_deq` rounds them: W_e[k, n] = bf16(bf16(q) *
// bf16(scale[e, n])), a bf16 product of two bf16 values, before the
// product; the fp32 scale is never applied after the sum. Rows outside
// [offsets[0], offsets[E]) are not written. No count crosses to the host
// (each block reads the offsets itself), so a launch can sit in a CUDA
// graph; every output element has one writer and one order of sums, so
// runs agree bit for bit.
//
// What bounds it on the H100: at extend (thousands of rows an expert) the
// tensor cores, 2 M K N operations (Mixtral's gate at 4 x 2048 tokens:
// 1.92 TFLOP, 1.95 ms at 989 TFLOP/s); at decode (a few rows an expert)
// the weight stream of the experts the rows touch (5 of Mixtral's 8 int8
// experts at 4 tokens: 294 MB, 0.088 ms at 3.35 TB/s). The host picks one
// of two plans from M, K, N and E alone (`moe_plan`, ops/moe.py).
//
// Extend plan (`extend_kernel`): clusters of 2 CTAs, each cluster a tile
// of 256 rows of one expert (a block, cut at the expert's end) x 256
// output columns at a time, each CTA two consumer warpgroups running wgmma
// (bf16 -> fp32 in registers) and a producer warp that keeps a ring of 4
// stages of 64 k in flight by TMA. A stage has a full barrier (the
// expected bytes) and an empty one (every consumer warp of both CTAs is
// done with it); each CTA loads half of what both need and multicasts it,
// so a stage is refilled only when both CTAs have released it. xs arrives
// as a 2-D map (boxes of 128 rows x 64 columns, 128-byte swizzle); rows
// of the next expert that fall inside a block are computed and dropped at
// the store. W_e arrives as a 3-D map over [E, K, N]. One CTA a 128 x 256
// tile, the first version, read 48 KB from L2 a 64-k step for 4.2 MFLOP
// (11 TB/s at the tensor cores' peak) and ran at ~40% of peak.
// bf16 experts: the CTA of rank r takes rows [128 r, 128 r + 128) of the
// block and all 256 columns; the weight tile is multicast (a CTA reads
// 32 KB a step). Each warpgroup owns 64 rows: m64n256k16 with xs as the
// K-major A operand and the weight stage as the MN-major B operand, as
// flash_attention.cu reads V.
// int8 experts: the CTA of rank r takes all 256 rows and columns [128 r,
// 128 r + 128); the rows are multicast (a CTA reads 24 KB a step). Each
// warpgroup computes out^T = W_e^T . xs^T for 64 columns: m64n256k16 with
// the weights as the register A operand, unpacked and scaled to bf16 in
// registers (hopper_common.cuh `i8_float`, then bf16 pairs times the
// scales with one rounding, the reference's; row 16 w + g + 8 h of warp w
// is column 16 w + 2 g + h, so a k row is one 2-byte load), and the
// block's rows as the K-major B operand (N = 256 rows). A first version
// dequantized each stage into a bf16 tile in shared memory and, with the
// products' reads, moved ~160 KB of shared memory a step, more than an SM
// serves at the tensor cores' rate. ptxas serializes register-A products
// whose operand is defined while one is in flight (and when the A of all
// four k16 steps and the accumulators overflow the registers), so each
// warpgroup makes the A of two k16 steps, issues them as one group and
// waits for it; the other warpgroup's group runs meanwhile.
// The producer is one warp, not a warpgroup: with either, ptxas allocates
// a whole warpgroup's registers to it and caps every thread at 168 (it
// did not raise the consumers past that for setmaxnreg), which the 128
// accumulators just fit. The accumulators leave through shared memory (16
// KB a warpgroup a pass, swizzled) as whole 16-byte chunks of rows:
// stored straight from the accumulator layout, 4 bytes of 8 rows at a
// time, the epilogue had taken ~30% of the kernel's time.
// Persistent clusters, one CTA an SM at most: each CTA counts every
// expert's row blocks into shared memory once, and walks the (column
// tile, block) list in bands of 8 blocks (2048 rows), column-major inside
// a band: the clusters running together share a column tile of an
// expert's weights and a band of rows while both are in L2, and xs, read
// once a band instead of once a column tile, stays there across the band.
//
// Decode plan (`decode_kernel`): the weights are the wide operand. A block
// owns a stripe of 128 output columns of one expert that has rows (block
// y takes the y-th such expert; a block past the last exits before it
// reads a weight, so an expert with no rows reads none) and runs
// out^T = W_e^T . xs^T on mma.sync m16n8k16: weight columns as the M
// rows, the expert's rows as token tiles of 8 or 16 (more rows loop over
// the stripe again). A producer warp keeps a ring of 4 TMA stages of 16
// KB of weights (128 k of int8, 64 of bf16; 128-byte swizzle) and the
// rows' activations in flight; 4 consumer warps own 32 columns each and
// read their weight fragments straight from the stage into registers,
// where int8 is unpacked and scaled to bf16 on the way into the product
// (no shared-memory round trip). A thread's fragment rows are 4
// consecutive columns (m row g + 8h of tile q is column 4g + 2q + h), so
// each k row is one 4-byte (int8) or 8-byte (bf16) load, and its four
// outputs of a token are one store.
//
// The first cut, replaced: 64 x 64 tiles on 4 warps of mma.sync fed by
// a cp.async ring of BK 32, int8 dequantized through a second shared tile,
// a grid of ceil(M / 64) + E row tiles whose blocks each walked the
// offsets. On an H100 SXM at 700 W it took 13.97 / 14.54 ms (bf16 /
// int8) at Mixtral's gate shape and 4 x 2048 tokens, 0.2146 / 0.2304 at 4
// tokens.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ extend plan
constexpr int XM = 128;       // rows of a tile
constexpr int XN = 256;       // output columns of a tile
constexpr int XK = 64;        // k of a stage
constexpr int XSTAGES = 4;
constexpr int XCONS = 256;    // two consumer warpgroups
constexpr int XNT = XCONS + 32;  // and the producer warp
constexpr int XWARPS = XCONS / 32;  // consumer warps
constexpr int BAND = 8;       // row blocks (2 XM rows) of a band
constexpr uint32_t X_BOX = XM * 128;            // xs box: 128 rows x 64
constexpr uint32_t W_BOX = XK * 128;            // bf16 W box: 64 k x 64
constexpr uint32_t W_TILE = 4 * W_BOX;          // 64 k x 256 columns
constexpr uint32_t Q_BOX = XK * 128;            // int8 W box: 64 k x 128

// a stage: bf16, the CTA's 128 rows of xs and the 256 columns of W; int8,
// the block's 256 rows of xs (two boxes) and the CTA's 128 columns of W
template <bool Q>
struct XLayout {
  static constexpr uint32_t X_STAGE = Q ? 2 * X_BOX : X_BOX;
  static constexpr uint32_t STAGE = X_STAGE + (Q ? Q_BOX : W_TILE);
  static constexpr uint32_t STAGING = 2 * 16384;  // 16 KB a warpgroup
  // alignment slack, the ring, the epilogue's staging, the full and empty
  // barriers; the block counts follow
  static constexpr size_t FIXED =
      1024 + XSTAGES * STAGE + STAGING + 16 * XSTAGES;
  static size_t bytes(int E) { return FIXED + 4 * size_t(E + 1); }
};

struct Walk {
  const int* offs;  // [E + 1], in global memory
  const int* cum;   // [E + 1]: row blocks of the experts before e
  int E, R, NC, KT;
};

// item w of the walk: expert e, its row block [b0, b1) (at most 2 XM rows
// from the expert's first, cut at its end) and the tile's first column n0
// (XN columns)
__device__ __forceinline__ void walk_block(const Walk& wk, int w, int& e,
                                           int& b0, int& b1, int& n0) {
  const int band = w / (BAND * wk.NC);
  const int in = w - band * BAND * wk.NC;
  const int nb = min(BAND, wk.R - band * BAND);
  const int c = in / nb;
  const int p = band * BAND + in % nb;
  // the expert whose blocks hold p: the last e with cum[e] <= p
  int lo = 0, hi = wk.E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (wk.cum[mid] <= p) lo = mid;
    else hi = mid - 1;
  }
  e = lo;
  b0 = __ldg(wk.offs + e) + (p - wk.cum[e]) * 2 * XM;
  b1 = min(__ldg(wk.offs + e + 1), b0 + 2 * XM);
  n0 = c * XN;
}

// this CTA's share of item w. bf16: rows [r0, r1) of the block, rank r
// taking XM rows from b0 + XM r (r1 <= r0 where the block is shorter),
// and the tile's XN columns from n0. int8: the whole block, and XN / 2
// columns from n0 + XN / 2 r.
template <bool Q>
__device__ __forceinline__ void walk_tile(const Walk& wk, int w, int rank,
                                          int& e, int& r0, int& r1,
                                          int& n0) {
  int b0, b1;
  walk_block(wk, w, e, b0, b1, n0);
  if constexpr (Q) {
    r0 = b0, r1 = b1, n0 += rank * XN / 2;
  } else {
    r0 = b0 + rank * XM, r1 = min(b1, r0 + XM);
  }
}

// byte i of two words of int8 with their top bits flipped (lo: a's, hi:
// b's) times the bf16 pair s2, as bf16(bf16(q) * s)
__device__ __forceinline__ uint32_t deq_pair(uint32_t a, uint32_t b, int i,
                                             uint32_t s2) {
  return hopper::bf16_mul2(
      hopper::bf16_pair_exact(hopper::i8_float(a, i), hopper::i8_float(b, i)),
      s2);
}

__device__ __forceinline__ void store2(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* out, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
}

// barrier 1 + cw over consumer warpgroup cw alone
__device__ __forceinline__ void warpgroup_sync(int cw) {
  if (cw == 0)
    asm volatile("bar.sync 1, 128;" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;" ::: "memory");
}

template <bool Q, typename TO>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(XNT, 1)
extend_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w,
              const float* __restrict__ scale,
              const int* __restrict__ offsets, TO* __restrict__ out, int K,
              int N, int E) {
  typedef XLayout<Q> L;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);
  uint8_t* staging = ring + XSTAGES * L::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + L::STAGING);
  uint64_t* empty = full + XSTAGES;
  int* cum = reinterpret_cast<int*>(empty + XSTAGES);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rank = int(hopper::cluster_rank());

  // each expert's row blocks summed in expert order by warp 0 (an
  // inclusive scan of 32 experts at a time); both CTAs of the cluster
  // compute the same walk
  if (tid == 0) {
    for (int s = 0; s < XSTAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * XWARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < E; base += 32) {
      const int e = base + lane;
      const int rows = e < E ? __ldg(offsets + e + 1) - __ldg(offsets + e) : 0;
      int v = rows > 0 ? (rows + 2 * XM - 1) / (2 * XM) : 0;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int up = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += up;
      }
      if (e < E) cum[e + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) cum[0] = 0;
  }
  // the peer's barriers are initialized before either CTA arrives on them
  // or loads into its ring
  hopper::cluster_sync();
  const Walk wk{offsets, cum, E, cum[E], (N + XN - 1) / XN,
                (K + XK - 1) / XK};
  const int total = wk.R * wk.NC;
  const int cid = int(hopper::cluster_id()), ncl = int(hopper::cluster_count());
  const int ntile = cid < total ? (total - cid + ncl - 1) / ncl : 0;
  const int nsteps = ntile * wk.KT;

  if (warp == XWARPS) {
    // the producer warp: one thread loads the block's k steps in order,
    // each once both CTAs have released its stage: its expected bytes,
    // this CTA's rows and this CTA's half of the weight tile, sent to
    // both CTAs
    if (lane == 0) {
      int e = 0, row = 0, n0 = 0;
      for (int s = 0, kt = 0, t = 0; s < nsteps; ++s) {
        const int st = s % XSTAGES;
        if (s >= XSTAGES)
          hopper::mbar_wait(&empty[st], ((s / XSTAGES) - 1) & 1);
        if (kt == 0) {
          int r0, r1;
          walk_tile<Q>(wk, cid + t * ncl, rank, e, r0, r1, n0);
          // bf16: a rank with no rows in the block loads (and never
          // stores) the expert's first rows; int8: this rank's half of
          // the block's rows, kept inside xs (rows past the block are
          // never stored)
          row = Q ? min(r0 + rank * XM, __ldg(offsets + E) - 1)
                  : (r1 > r0 ? r0 : __ldg(offsets + e));
        }
        const int k0 = kt * XK;
        if (++kt == wk.KT) kt = 0, ++t;
        uint8_t* dst = ring + st * L::STAGE;
        hopper::mbar_expect_tx(&full[st], L::STAGE);
        if constexpr (Q) {
          hopper::tma_load_3d_multicast(dst + rank * X_BOX, &tm_x, &full[st],
                                        k0, row, 0, 0x3);
          hopper::tma_load_3d(dst + 2 * X_BOX, &tm_w, &full[st], n0, k0, e);
        } else {
          hopper::tma_load_3d(dst, &tm_x, &full[st], k0, row, 0);
#pragma unroll
          for (int i = 2 * rank; i < 2 * rank + 2; ++i)
            hopper::tma_load_3d_multicast(dst + X_BOX + i * W_BOX, &tm_w,
                                          &full[st], n0 + 64 * i, k0, e,
                                          0x3);
        }
      }
    }
    __syncwarp();
    hopper::cluster_sync();
    return;
  }
  // a consumer warp is done with step q: it tells both CTAs' producers
  auto release = [&](int q) {
    __syncwarp();
    if (lane == 0) {
      hopper::mbar_arrive(&empty[q % XSTAGES]);
      hopper::mbar_arrive_cluster(&empty[q % XSTAGES], rank ^ 1);
    }
  };
  const int cw = tid / 128;  // consumer warpgroup
  const int w = warp % 4, g = lane / 4, tq = lane % 4;
  uint8_t* stg = staging + cw * 16384;
  int s = 0;
  for (int t = 0; t < ntile; ++t) {
    if constexpr (Q) {
      // out^T = W_e^T . xs^T: warpgroup cw's 64 columns of the CTA's 128
      // are the register A operand (row 16 w + g + 8 h is column 64 cw +
      // 16 w + 2 g + h), unpacked and scaled in registers; the block's
      // 256 rows of xs are the K-major B operand (N = 256 rows)
      uint32_t sc[2];  // column 2 g + h's scale, bf16, twice
      {
        int e, r0, r1, n0;
        walk_tile<Q>(wk, cid + t * ncl, rank, e, r0, r1, n0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + 64 * cw + 16 * w + 2 * g + h;
          const float v = n < N ? scale[size_t(e) * N + n] : 0.f;
          sc[h] = hopper::pack_bf16(v, v);
        }
      }
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < wk.KT; ++kt, ++s) {
        const int st = s % XSTAGES;
        const uint8_t* stage = ring + st * L::STAGE;
        hopper::mbar_wait(&full[st], (s / XSTAGES) & 1);
        // the A of two k16 steps, then their products as one group:
        // ptxas serializes register-A products when an operand is defined
        // with one in flight (and when the A of all four steps and the
        // accumulators overflow the registers), so the warpgroup makes its
        // next A only after the group is done, while the other
        // warpgroup's group runs
        const uint8_t* wq = stage + 2 * X_BOX;
        const uint64_t db = hopper::desc_k(stage);
#pragma unroll
        for (int k2 = 0; k2 < XK / 16; k2 += 2) {
          uint32_t a[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // rows k = 16 (k2 + i) + {2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9},
            // the thread's two columns (bytes 64 cw + 16 w + 2 g) of each
            uint32_t v[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int k = 16 * (k2 + i) + 2 * tq + (r & 1) + 8 * (r >> 1);
              v[r] = uint32_t(*reinterpret_cast<const uint16_t*>(
                         wq + k * 128 + (((4 * cw + w) ^ (k % 8)) * 16) +
                         2 * g)) ^
                     0x8080u;
            }
            a[i][0] = deq_pair(v[0], v[1], 0, sc[0]);
            a[i][1] = deq_pair(v[0], v[1], 1, sc[1]);
            a[i][2] = deq_pair(v[2], v[3], 0, sc[0]);
            a[i][3] = deq_pair(v[2], v[3], 1, sc[1]);
          }
          hopper::wgmma_fence();
#pragma unroll
          for (int i = 0; i < 2; ++i)
            hopper::mma_64x256_rs_k(acc, a[i],
                                    hopper::desc_add(db, 32 * (k2 + i)));
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
        }
        release(s);
      }
      hopper::fence_regs(acc);
      // out through shared memory: each warpgroup stages PR of the block's
      // rows a pass, its 64 columns each (RB bytes, 16-byte chunks
      // swizzled by row), then writes whole chunks of the rows of this
      // expert inside N (N % 16: a chunk never straddles it)
      constexpr int RB = 64 * int(sizeof(TO));
      constexpr int PR = 16384 / RB;
      int e, r0, r1, n0;
      walk_tile<Q>(wk, cid + t * ncl, rank, e, r0, r1, n0);
#pragma unroll
      for (int p = 0; p < 2 * XM / PR; ++p) {
        warpgroup_sync(cw);  // the last pass's chunks are out
#pragma unroll
        for (int j = 0; j < PR / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // row 8 j + 2 tq + h: columns 16 w + 2 g + (0, 1)
            const int r = 8 * j + 2 * tq + h;
            const int b = (16 * w + 2 * g) * int(sizeof(TO));
            const int i = 4 * (p * PR / 8 + j) + h;
            store2(reinterpret_cast<TO*>(stg + r * RB +
                                         ((b / 16) ^ (r & 7)) * 16 + b % 16),
                   acc[i], acc[i + 2]);
          }
        warpgroup_sync(cw);
#pragma unroll 1
        for (int c = tid % 128; c < PR * RB / 16; c += 128) {
          const int r = c / (RB / 16), ch = c % (RB / 16);
          const int m = r0 + p * PR + r;
          const int n = n0 + 64 * cw + ch * (16 / int(sizeof(TO)));
          if (m < r1 && n < N)
            *reinterpret_cast<uint4*>(out + size_t(m) * N + n) =
                *reinterpret_cast<const uint4*>(stg + r * RB +
                                                ((ch ^ (r & 7)) * 16));
        }
      }
    } else {
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < wk.KT; ++kt, ++s) {
        const int st = s % XSTAGES;
        const uint8_t* stage = ring + st * L::STAGE;
        hopper::mbar_wait(&full[st], (s / XSTAGES) & 1);
        const uint64_t da = hopper::desc_k(stage + cw * 64 * 128);
        const uint64_t db = hopper::desc_mn(stage + X_BOX, W_BOX);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < XK / 16; ++kk)
          hopper::mma_64x256_ss_mn(acc, hopper::desc_add(da, 32 * kk),
                                   hopper::desc_add(db, 2048 * kk), 1);
        hopper::wgmma_commit();
        if (kt > 0) {
          hopper::wgmma_wait<1>();
          release(s - 1);
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(s - 1);
      // (the tile's rows and columns, found again: fewer registers live
      // across the products)
      int e, r0, r1, n0;
      walk_tile<Q>(wk, cid + t * ncl, rank, e, r0, r1, n0);
      // out through shared memory: each warpgroup stages its 64 rows, PC
      // columns a pass (16 KB, 16-byte chunks swizzled by row), then
      // writes whole 16-byte chunks of the rows of this expert inside N
      // (N % 16: a chunk never straddles it), 256 bytes a row
      constexpr int PC = 16384 / (64 * int(sizeof(TO)));
      constexpr int RB = PC * int(sizeof(TO));
      const int wrow = 16 * w + g;  // the thread's rows wrow, wrow + 8
#pragma unroll
      for (int p = 0; p < XN / PC; ++p) {
        warpgroup_sync(cw);  // the last pass's chunks are out
#pragma unroll
        for (int j = 0; j < PC / 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = wrow + 8 * hf;
            const int b = (8 * j + 2 * tq) * int(sizeof(TO));
            const int i = 4 * (p * PC / 8 + j) + 2 * hf;
            store2(reinterpret_cast<TO*>(stg + r * RB +
                                         ((b / 16) ^ (r & 7)) * 16 + b % 16),
                   acc[i], acc[i + 1]);
          }
        warpgroup_sync(cw);
#pragma unroll 1
        for (int c = tid % 128; c < 64 * RB / 16; c += 128) {
          const int r = c / (RB / 16), ch = c % (RB / 16);
          const int m = r0 + 64 * cw + r;
          const int n = n0 + p * PC + ch * (16 / int(sizeof(TO)));
          if (m < r1 && n < N)
            *reinterpret_cast<uint4*>(out + size_t(m) * N + n) =
                *reinterpret_cast<const uint4*>(stg + r * RB +
                                                ((ch ^ (r & 7)) * 16));
        }
      }
    }
  }
  // neither CTA leaves while the other may still load into its ring or
  // arrive on its barriers
  hopper::cluster_sync();
}

// ------------------------------------------------------------ decode plan
constexpr int DN = 128;          // output columns of a block
constexpr int DCW = 4;           // consumer warps, 32 columns each
constexpr int DNT = 32 * (DCW + 1);
constexpr int DSTAGES = 4;
constexpr uint32_t DW_STAGE = 16384;  // weight bytes of a stage

template <bool Q, int TT>
struct DLayout {
  static constexpr int SK = Q ? 128 : 64;           // k of a stage
  static constexpr uint32_t XBOX = 8 * TT * 128;    // 8 TT rows x 64 k
  static constexpr uint32_t STAGE = DW_STAGE + (SK / 64) * XBOX;
  static constexpr size_t BYTES = 1024 + DSTAGES * STAGE + 16 * DSTAGES + 16;
};

template <bool Q, int TT, typename TO>
__global__ void __launch_bounds__(DNT)
decode_kernel(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w,
              const float* __restrict__ scale,
              const int* __restrict__ offsets, TO* __restrict__ out, int K,
              int N, int E) {
  typedef DLayout<Q, TT> L;
  constexpr int SK = L::SK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + DSTAGES * L::STAGE);
  uint64_t* empty = full + DSTAGES;
  int* found = reinterpret_cast<int*>(empty + DSTAGES);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // this block's expert: the blockIdx.y-th one that has rows
  if (warp == 0) {
    int slot = blockIdx.y, e = -1;
    for (int base = 0; base < E && e < 0; base += 32) {
      const int g = base + lane;
      const bool has = g < E && offsets[g + 1] > offsets[g];
      unsigned mask = __ballot_sync(0xffffffffu, has);
      const int cnt = __popc(mask);
      if (slot < cnt) {
        for (int i = 0; i < slot; ++i) mask &= mask - 1;
        e = base + __ffs(mask) - 1;
      } else {
        slot -= cnt;
      }
    }
    if (lane == 0) {
      found[0] = e;
      if (e >= 0) {
        found[1] = offsets[e];
        found[2] = offsets[e + 1];
      }
      for (int s = 0; s < DSTAGES; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], DCW);
      }
      hopper::fence_barrier_init();
    }
  }
  __syncthreads();
  const int e = found[0];
  if (e < 0) return;
  const int lo = found[1], hi = found[2];
  const int n0 = blockIdx.x * DN;
  const int KS = (K + SK - 1) / SK;
  const int nchunk = (hi - lo + 8 * TT - 1) / (8 * TT);

  if (warp == DCW) {
    // the producer: every stage of every chunk of the expert's rows
    if (lane == 0) {
      for (int i = 0; i < nchunk * KS; ++i) {
        const int st = i % DSTAGES;
        if (i >= DSTAGES) hopper::mbar_wait(&empty[st], ((i / DSTAGES) - 1) & 1);
        const int k0 = (i % KS) * SK, r = lo + (i / KS) * 8 * TT;
        uint8_t* dst = ring + st * L::STAGE;
        hopper::mbar_expect_tx(&full[st], L::STAGE);
        if constexpr (Q) {
          hopper::tma_load_3d(dst, &tm_w, &full[st], n0, k0, e);
        } else {
          hopper::tma_load_3d(dst, &tm_w, &full[st], n0, k0, e);
          hopper::tma_load_3d(dst + DW_STAGE / 2, &tm_w, &full[st], n0 + 64,
                              k0, e);
        }
#pragma unroll
        for (int b = 0; b < SK / 64; ++b)
          hopper::tma_load_3d(dst + DW_STAGE + b * L::XBOX, &tm_x, &full[st],
                              k0 + 64 * b, r, 0);
      }
    }
    return;
  }

  // consumer warp `warp`: columns n0 + 32 warp + 4 g + i, i < 4
  const int g = lane / 4, t = lane % 4;
  const int ncol = n0 + 32 * warp + 4 * g;
  uint32_t sc[4];  // column i's scale, bf16, twice
  if constexpr (Q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = ncol + i < N ? scale[size_t(e) * N + ncol + i] : 0.f;
      sc[i] = hopper::pack_bf16(v, v);
    }
  }
  int i = 0;
  for (int c = 0; c < nchunk; ++c) {
    float acc[2][TT][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int tt = 0; tt < TT; ++tt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][tt][j] = 0.f;
    for (int ks = 0; ks < KS; ++ks, ++i) {
      const int st = i % DSTAGES;
      hopper::mbar_wait(&full[st], (i / DSTAGES) & 1);
      const uint8_t* ws = ring + st * L::STAGE;
      const uint8_t* xb = ws + DW_STAGE;
#pragma unroll
      for (int kk = 0; kk < SK / 16; ++kk) {
        // the weight rows k = 16 kk + {2t, 2t + 1, 2t + 8, 2t + 9}
        uint32_t a[2][4];
        if constexpr (Q) {
          uint32_t v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int k = 16 * kk + 2 * t + (r & 1) + 8 * (r >> 1);
            v[r] = *reinterpret_cast<const uint32_t*>(
                       ws + k * 128 + (((2 * warp + g / 4) ^ (k % 8)) * 16) +
                       4 * (g % 4)) ^
                   0x80808080u;
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            a[q][0] = deq_pair(v[0], v[1], 2 * q, sc[2 * q]);
            a[q][1] = deq_pair(v[0], v[1], 2 * q + 1, sc[2 * q + 1]);
            a[q][2] = deq_pair(v[2], v[3], 2 * q, sc[2 * q]);
            a[q][3] = deq_pair(v[2], v[3], 2 * q + 1, sc[2 * q + 1]);
          }
        } else {
          uint2 v[4];
          const uint8_t* box = ws + (warp / 2) * (DW_STAGE / 2);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int k = 16 * kk + 2 * t + (r & 1) + 8 * (r >> 1);
            v[r] = *reinterpret_cast<const uint2*>(
                box + k * 128 + (((4 * (warp % 2) + g / 2) ^ (k % 8)) * 16) +
                8 * (g % 2));
          }
          // word q of a row holds columns 4g + 2q (low half) and + 1
          a[0][0] = __byte_perm(v[0].x, v[1].x, 0x5410);
          a[0][1] = __byte_perm(v[0].x, v[1].x, 0x7632);
          a[0][2] = __byte_perm(v[2].x, v[3].x, 0x5410);
          a[0][3] = __byte_perm(v[2].x, v[3].x, 0x7632);
          a[1][0] = __byte_perm(v[0].y, v[1].y, 0x5410);
          a[1][1] = __byte_perm(v[0].y, v[1].y, 0x7632);
          a[1][2] = __byte_perm(v[2].y, v[3].y, 0x5410);
          a[1][3] = __byte_perm(v[2].y, v[3].y, 0x7632);
        }
        // the token rows' k pairs (2t, 2t + 1) and (2t + 8, 2t + 9)
        const uint8_t* xk = xb + (kk / 4) * L::XBOX;
#pragma unroll
        for (int tt = 0; tt < TT; ++tt) {
          const int r = 8 * tt + g;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
              xk + r * 128 + ((2 * (kk % 4)) ^ (r % 8)) * 16 + 4 * t);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
              xk + r * 128 + ((2 * (kk % 4) + 1) ^ (r % 8)) * 16 + 4 * t);
#pragma unroll
          for (int q = 0; q < 2; ++q) hopper::mma16816(acc[q][tt], a[q], b0, b1);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
    // C tile q: (column 4g + 2q + h, token 2t + j) in acc[q][tt][2h + j]
    if (ncol < N) {
#pragma unroll
      for (int tt = 0; tt < TT; ++tt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = lo + c * 8 * TT + 8 * tt + 2 * t + j;
          if (m < hi) {
            TO* dst = out + size_t(m) * N + ncol;
            store2(dst, acc[0][tt][j], acc[0][tt][2 + j]);
            store2(dst + 2, acc[1][tt][j], acc[1][tt][2 + j]);
          }
        }
    }
  }
}

// ----------------------------------------------------------------- host

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <bool Q, typename TO>
int launch_extend(const void* xs, const void* w, const void* scale,
                  const void* offsets, void* out, int M, int K, int N, int E,
                  int blocks, cudaStream_t st) {
  CUtensorMap mx, mw;
  if (!hopper::map_stripes(&mx, xs, 2, K * 2, M, 1, 64, XM, true) ||
      !(Q ? hopper::map_stripes(&mw, w, 1, N, K, E, 128, XK, true)
          : hopper::map_stripes(&mw, w, 2, N * 2, K, E, 64, XK, true)))
    return int(cudaErrorInvalidValue);
  const size_t smem = XLayout<Q>::bytes(E);
  cudaError_t err = allow_smem(extend_kernel<Q, TO>, smem);
  if (err != cudaSuccess) return int(err);
  extend_kernel<Q, TO><<<blocks, XNT, smem, st>>>(
      mx, mw, static_cast<const float*>(scale),
      static_cast<const int*>(offsets), static_cast<TO*>(out), K, N, E);
  return int(cudaGetLastError());
}

template <bool Q, int TT, typename TO>
int launch_decode(const void* xs, const void* w, const void* scale,
                  const void* offsets, void* out, int M, int K, int N, int E,
                  cudaStream_t st) {
  typedef DLayout<Q, TT> L;
  CUtensorMap mx, mw;
  if (!hopper::map_stripes(&mx, xs, 2, K * 2, M, 1, 64, 8 * TT, true) ||
      !(Q ? hopper::map_stripes(&mw, w, 1, N, K, E, 128, L::SK, true)
          : hopper::map_stripes(&mw, w, 2, N * 2, K, E, 64, L::SK, true)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(decode_kernel<Q, TT, TO>, L::BYTES);
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + DN - 1) / DN, min(E, M));
  decode_kernel<Q, TT, TO><<<grid, DNT, L::BYTES, st>>>(
      mx, mw, static_cast<const float*>(scale),
      static_cast<const int*>(offsets), static_cast<TO*>(out), K, N, E);
  return int(cudaGetLastError());
}

template <bool Q, typename TO>
int launch(const void* xs, const void* w, const void* scale,
           const void* offsets, void* out, int M, int K, int N, int E,
           int decode, int tokens, int blocks, cudaStream_t st) {
  if (!decode)
    return launch_extend<Q, TO>(xs, w, scale, offsets, out, M, K, N, E,
                                blocks, st);
  return tokens == 8
             ? launch_decode<Q, 1, TO>(xs, w, scale, offsets, out, M, K, N,
                                       E, st)
             : launch_decode<Q, 2, TO>(xs, w, scale, offsets, out, M, K, N,
                                       E, st);
}

}  // namespace

// out [M, N] (bf16, or fp32 with out_f32) = the grouped product of xs
// [M, K] bf16 with w [E, K, N] (bf16, or int8 with w_int8 and its fp32
// scale [E, N]) over the groups of offsets [E + 1] int32 (on the device),
// by the plan of `moe_plan` (ops/moe.py): decode (token tiles of `tokens`,
// 8 or 16) or extend (`blocks` persistent blocks, an even number: clusters
// of 2). K % 32 == 0 (the stages' k past K read zeros), N % 16 == 0, 0 <
// E, 0 < M.
extern "C" int aurora_moe_grouped_mm(const void* xs, const void* w,
                                     const void* scale, const void* offsets,
                                     void* out, int M, int K, int N, int E,
                                     int w_int8, int out_f32, int decode,
                                     int tokens, int blocks, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || K % 32 != 0 || N % 16 != 0 ||
      (w_int8 && scale == nullptr) ||
      (decode && ((tokens != 8 && tokens != 16) || min(E, M) > 65535)) ||
      (!decode && (blocks <= 0 || blocks % 2 != 0 ||
                   XLayout<true>::bytes(E) > 232448 ||
                   XLayout<false>::bytes(E) > 232448)))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_int8)
    return out_f32 ? launch<true, float>(xs, w, scale, offsets, out, M, K, N,
                                         E, decode, tokens, blocks, st)
                   : launch<true, bf16>(xs, w, scale, offsets, out, M, K, N,
                                        E, decode, tokens, blocks, st);
  return out_f32 ? launch<false, float>(xs, w, scale, offsets, out, M, K, N,
                                        E, decode, tokens, blocks, st)
                 : launch<false, bf16>(xs, w, scale, offsets, out, M, K, N, E,
                                       decode, tokens, blocks, st);
}

// one kernel (bf16 out) and its dynamic shared bytes, for
// aurora_kernel_attrs: mode "extend_<bf16|int8>" (the shared bytes at E
// 128) or "decode_<bf16|int8>_t<8|16>"
extern "C" int aurora_moe_grouped_mm_kernel(const char* mode,
                                            const void** fn, int* smem) {
  if (strcmp(mode, "extend_bf16") == 0) {
    *fn = reinterpret_cast<const void*>(extend_kernel<false, bf16>);
    *smem = int(XLayout<false>::bytes(128));
  } else if (strcmp(mode, "extend_int8") == 0) {
    *fn = reinterpret_cast<const void*>(extend_kernel<true, bf16>);
    *smem = int(XLayout<true>::bytes(128));
  } else if (strcmp(mode, "decode_bf16_t8") == 0) {
    *fn = reinterpret_cast<const void*>(decode_kernel<false, 1, bf16>);
    *smem = int(DLayout<false, 1>::BYTES);
  } else if (strcmp(mode, "decode_bf16_t16") == 0) {
    *fn = reinterpret_cast<const void*>(decode_kernel<false, 2, bf16>);
    *smem = int(DLayout<false, 2>::BYTES);
  } else if (strcmp(mode, "decode_int8_t8") == 0) {
    *fn = reinterpret_cast<const void*>(decode_kernel<true, 1, bf16>);
    *smem = int(DLayout<true, 1>::BYTES);
  } else if (strcmp(mode, "decode_int8_t16") == 0) {
    *fn = reinterpret_cast<const void*>(decode_kernel<true, 2, bf16>);
    *smem = int(DLayout<true, 2>::BYTES);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return 0;
}
