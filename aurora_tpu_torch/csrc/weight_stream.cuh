// The tensor-core weight streamers of the decode matmuls, sm_90a: the
// block shape, the ring of stages that one producer warp fills by TMA,
// the mma.sync wrappers and the deterministic split-K ending. Used by
// w8a8_matmul.cu (`w8a8_kernel`) and w4_flat_matmul.cu (`w4a16_kernel`).
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
// copies); each stage completes on its `full` mbarrier, and is refilled
// once the 8 consumer warps have arrived on its `empty` mbarrier.
// Consumer warp w owns channels [64 * (w % CW), + 64) and the mma k-steps
// w / CW, w / CW + KW, ... of each stage. At the end the four k-slices'
// partial sums meet in shared memory (the ring's bytes, read no more) and
// are added in k-slice order. With one split the block then writes the
// output. With more, each block stores its partial to part[split][B][N]
// and takes a ticket on its column tile; the last block adds the
// partials in split order, writes the output and resets the ticket. The
// sums are thus taken in the same order whichever block comes last, and
// every run gives the same bits. part and the tickets are per device and
// reused by every launch (see quant_matmul.py), so launches of one kernel
// on one device must not overlap.

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

// The consumers' ending. red holds the k-slices' partial sums
// [KW][B][BN] (T: float or int) in shared memory, written by every
// consumer thread before the call. store(b, n, sum) writes output (b, n)
// of the column tile at n0; part and tickets serve nsplit > 1.
template <typename T, typename Store>
__device__ __forceinline__ void finish(Bars& bars, const T* red, T* part,
                                       int* tickets, int B, int N, int n0,
                                       int split, int nsplit, Store store) {
  consumers_sync();
  const int nv = min(BN, N - n0);
  const int tid = threadIdx.x;
  for (int e = tid; e < B * BN; e += CONSUMERS) {
    const int b = e / BN, c = e % BN;
    if (c >= nv) continue;
    T v = red[size_t(b) * BN + c];
#pragma unroll
    for (int k = 1; k < KW; ++k) v += red[(size_t(k) * B + b) * BN + c];
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
