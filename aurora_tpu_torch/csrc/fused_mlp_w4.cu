// The fused W4 MLP of one decode step: silu(h @ Wg) * (h @ Wu) @ Wd,
// sm_90a.
//
// Replaces: aurora_tpu/ops/pallas/quant_matmul.py `fused_mlp_w4` (Pallas
// kernel `_kernel_mlp_w4`). Contract, for h [B, D] (B <= 64), intermediate
// width I:
//   gate/up[b, i] = the W4A8 recipe of w4a8_matmul.cu (per-token int8
//                   activations, exact int32 group partials, each scaled
//                   with one fp32 rounding, s_a last), kept in fp32
//   act[b, i]     = bf16(gate / (1 + exp(-gate)) * up)          (fp32 math)
//   out[b, d]     = sum_i act[b, i] * bf16(bf16(q[i, d]) * bf16(s[g(i), d]))
//                   in fp32, cast to the output type last
// The reference's kernel runs these numerics in bf16 on the chip; the plain
// twin `fused_mlp_w4_plain(compute_dtype=torch.bfloat16)` is the same
// recipe, and `fused_mlp_w4_bound` (quant_matmul.py) bounds the
// difference from the two orders of summation described below.
//
// Layout (ops/pallas/quant_matmul.py `w4_mlp_tile_layout`, I-tiles of the
// reference's ti, 256 or 128): mgu [I/ti, 2 ti, D/2] int8, tile j's
// channels in rows of D/2 packed bytes (the stripe layout of w4a8_matmul.cu),
// in 16-row groups of 8 gate columns then the same 8 up columns; mgs
// [I/ti, G, 2 ti] fp32 in that channel order; the down stream flat: mdw
// [I/2, D] int8 (packed row p: I-rows 2p, 2p + 1), mds [Gd, D] fp32.
//
// What bounds it on the H100: the packed weight stream, 67.6 MB of weights
// plus 4.2 MB of scales per 7B layer (at B = 4 each byte feeds 8
// multiply-adds): 0.021 ms at 3.35 TB/s.
//
// Design. One cluster of C blocks per I-tile, C from the occupancy: 8 with
// blocks of 64 channels where all I/ti clusters of 8 fit on the card at
// once (3 blocks an SM: 344 blocks at the 7B at up to 8 rows), else the
// most of 4, 2, 1 with blocks of 128 that do (`plan_tile`); rank r of
// tile j:
//   1. streams 2 ti / C channels of the tile's gate/up (whole columns, all
//      of D) through weight_stream.cuh's ring and W4A8 units, CB channels
//      at a time; consumer warp (cw, tw, kw) of a block keeps the sums of
//      the groups g % KW == kw, and the KW slices are added in slice order
//      through shared memory, as in w4a8_matmul.cu. A 16-row
//      group of the layout holds 8 gate columns and their up columns, so
//      the block has whole (gate, up) pairs: it applies s_a, silu * up,
//      rounds to bf16 and stores its ti / C activation columns into every
//      rank's activation tile in shared memory (distributed shared memory),
//   2. waits on the cluster barrier, after which every rank holds the
//      tile's whole bf16 activation [B, ti] (the [B, I] intermediate never
//      leaves the cluster),
//   3. streams its D / C down columns over the tile's ti rows (a stage
//      holds a box of 128 columns over all ti rows, in TMA boxes of 64
//      packed rows x 128 columns; W4A16's magic-number
//      dequantization and bf16 mma, weight_stream.cuh `w4a16_frag`); a
//      warp owns 64 columns and runs the tile's k-steps in order, so its
//      fp32 sums need no exchange, and writes the tile's partial
//      part[j][B][D].
// One producer warp fills the ring with the phase-1 stages and then the
// phase-3 ones, so the down stream is in flight while phase 1 ends. A
// second launch (`mlp_reduce`) sums the I/ti partials in tile order. No
// float atomics: every run repeats bit for bit, whatever C. Three
// launches on the caller's stream: quantize_rows, the tile kernel, the
// reduction; the last two as programmatic dependents of the one before,
// so that the tile kernel's first weights are in flight while the
// quantizer runs, and the reduction is resident when the tiles end.

#include "weight_stream.cuh"

namespace {

constexpr int W3BOX = 64 * 128;        // phase-3 box: 64 packed rows x 128
constexpr int SRB = ws::BN * 4;        // a phase-3 scale row: 128 columns
constexpr int RED_NT = 256;
constexpr int RED_UNROLL = 16;

template <int TT>
__host__ __device__ constexpr int act_box() {
  return 8 * TT * 128;
}

__host__ __device__ inline size_t round1k(size_t b) {
  return (b + 1023) & ~size_t(1023);
}

// a stage of either phase: phase 1 holds the weight box of CB channel
// rows, the two planes' boxes and scr1 scale rows of CB channels; phase 3
// the ti / 128 down boxes of a column box and the tile's scr3 scale rows
template <int TT, int CB>
__host__ __device__ size_t stage_bytes(int ti, int scr1, int scr3) {
  const size_t s1 =
      size_t(CB) * 128 + 2 * act_box<TT>() + size_t(scr1) * CB * 4;
  const size_t s3 = size_t(ti / 128) * W3BOX + size_t(scr3) * SRB;
  return round1k(s1 > s3 ? s1 : s3);
}

// the ring, the bf16 activation tile (ti / 64 boxes of 8 * TT rows) and
// the gate/up sums of one CB-channel block [B][CB] fp32
template <int TT, int CB>
size_t smem_bytes(int B, int ti, int scr1, int scr3) {
  return ws::NS * stage_bytes<TT, CB>(ti, scr1, scr3) +
         round1k(size_t(ti / 64) * act_box<TT>()) +
         size_t(B) * CB * sizeof(float) + 1024;
}

// scale rows a stage of `k` rows touches, for groups of `group` rows and
// stages that start on a group boundary or `k` after one
int scale_rows(int group, int k) {
  if (group % k == 0) return 1;
  if (k % group == 0) return k / group;
  return (k + group - 1) / group + 1;
}

// blocks an SM the kernel is built for: 3 with 64-channel blocks at up
// to 8 rows (clusters of 8 fill the card in one wave), 2 at up to 16, else 1
template <int TT, int CB>
__host__ __device__ constexpr int mlp_min_blocks() {
  return TT == 1 && CB == 64 ? 3 : TT <= 2 ? 2 : 1;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// 4 bytes into the shared memory of cluster rank `rank` at the offset of
// the local address `local`
__device__ __forceinline__ void st_rank(uint32_t local, int rank,
                                        uint32_t v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(remote), "r"(v)
               : "memory");
}

// Phase 3 at TT token tiles: a warp owns 64 columns and TP3 token tiles;
// the 8 consumer warps are CS3 column slices x TW3 token slices (the
// tokens split at 8 tiles, so that the fp32 sums of a warp fit its
// registers), and a pass covers PW3 columns in boxes of 128
template <int TT>
struct Down {
  static constexpr int TW3 = TT == 8 ? 2 : 1;
  static constexpr int CS3 = 8 / TW3;
  static constexpr int TP3 = TT / TW3;
  static constexpr int PW3 = 64 * CS3;
  // the boxes of pass p among the rank's DC columns
  __device__ static int boxes(int DC, int p) {
    return min(CS3 / 2, (DC - PW3 * p + 127) / 128);
  }
};

template <int TT, int RW, int CB>
__global__ void __launch_bounds__(ws::NT, mlp_min_blocks<TT, CB>())
mlp_tile_kernel(const __grid_constant__ CUtensorMap tm_gu,
                const __grid_constant__ CUtensorMap tm_h,
                const __grid_constant__ CUtensorMap tm_d,
                const float* __restrict__ mgs, const float* __restrict__ mds,
                const float* __restrict__ s_a, float* __restrict__ part,
                int B, int D, int G, int lg, int ti, int gd, int scr1,
                int scr3) {
  using Geo = ws::A8<TT, CB>;
  using Dn = Down<TT>;
  constexpr int ABOX = act_box<TT>();
  constexpr int W1BOX = CB * 128;      // phase-1 weight box: CB channels
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  __shared__ ws::Bars bars;
  const int C = gridDim.x, rank = blockIdx.x, tile = blockIdx.y;
  const int R1 = 2 * ti / C, NCB = R1 / CB;
  const int DC = D / C, n3 = rank * DC;
  const int nk1 = (D / 2 + 127) / 128, nk3 = ti / 128;
  const int np3 = (DC + Dn::PW3 - 1) / Dn::PW3;
  const size_t stage = stage_bytes<TT, CB>(ti, scr1, scr3);
  uint8_t* act = smem + ws::NS * stage;
  float* red = reinterpret_cast<float*>(act + round1k(size_t(ti / 64) * ABOX));
  const int sb1 = W1BOX + 2 * ABOX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ws::init_bars(bars);
  cluster_arrive_relaxed();     // every rank has started: barrier 1
  hopper::grid_launch_dependents();     // mlp_reduce may launch behind

  if (warp == ws::PRODUCER) {
    cluster_wait();
    cluster_arrive_release();   // barrier 2: nothing of the producer's
    if (lane == 0) {
      // the first ring's weights and scales go out before the activation
      // planes, which the quantizer launched before this kernel is still
      // writing (programmatic dependent launch)
      const int pre = min(ws::NS, NCB * nk1);
      int i = 0;
      for (int cb = 0; cb < NCB; ++cb) {
        const int ch = rank * R1 + cb * CB;
        for (int kb = 0; kb < nk1; ++kb, ++i) {
          const int slot = ws::producer_acquire(bars, i);
          const int kc = kb * 256, len = min(256, D - kc);
          const int g0 = kc >> lg, ng = ((kc + len - 1) >> lg) - g0 + 1;
          uint8_t* st = smem + size_t(slot) * stage;
          uint64_t* full = &bars.full[slot];
          hopper::mbar_expect_tx(full, W1BOX + 2 * ABOX + ng * CB * 4);
          hopper::tma_load_3d(st, &tm_gu, full, kc / 2, ch, tile);
          for (int r = 0; r < ng; ++r)
            hopper::bulk_copy_1d(
                st + sb1 + r * CB * 4,
                mgs + (size_t(tile) * G + g0 + r) * 2 * ti + ch, CB * 4,
                full);
          if (i + 1 < pre) continue;
          if (i + 1 == pre) hopper::grid_wait();
          for (int a = i + 1 == pre ? 0 : i; a <= i; ++a) {
            const int ka = (a % nk1) * 128;
            uint8_t* sa = smem + size_t(a % ws::NS) * stage + W1BOX;
            uint64_t* fa = &bars.full[a % ws::NS];
            hopper::tma_load_3d(sa, &tm_h, fa, ka, 0, 0);
            hopper::tma_load_3d(sa + ABOX, &tm_h, fa, ka, 0, 1);
          }
        }
      }
      // a phase-3 stage: one column box over all ti rows of the tile
      const int g0 = tile * ti / gd, ng = ti / gd;
      for (int p = 0; p < np3; ++p) {
        const int nb = Dn::boxes(DC, p);
        for (int b = 0; b < nb; ++b, ++i) {
          const int slot = ws::producer_acquire(bars, i);
          const int n = n3 + Dn::PW3 * p + 128 * b, nv = min(128, D - n);
          uint8_t* st = smem + size_t(slot) * stage;
          uint64_t* full = &bars.full[slot];
          hopper::mbar_expect_tx(full, nk3 * W3BOX + ng * 4 * nv);
          for (int kb = 0; kb < nk3; ++kb)
            hopper::tma_load_3d(st + kb * W3BOX, &tm_d, full, n,
                                (tile * ti + kb * 128) / 2, 0);
          for (int r = 0; r < ng; ++r)
            hopper::bulk_copy_1d(st + nk3 * W3BOX + r * SRB,
                                 mds + size_t(g0 + r) * D + n, 4 * nv, full);
        }
      }
    }
    __syncwarp();
    cluster_wait();
    return;
  }

  const int tid = threadIdx.x;
  const int g = lane >> 2, q = lane & 3;
  int i = 0;

  // ---- 1. gate/up of the rank's channels, then its activation columns
  {
    const int c0 = Geo::cw(warp) * Geo::MT * 16, kw = Geo::kw(warp);
    for (int cb = 0; cb < NCB; ++cb) {
      ws::A8Warp<TT, RW, CB> acc;
      acc.clear(Geo::tw(warp) * Geo::TPW);
      for (int kb = 0; kb < nk1; ++kb, ++i) {
        const int slot = ws::consumer_wait(bars, i);
        const uint8_t* st = smem + size_t(slot) * stage;
        acc.stage(st, st + W1BOX, st + W1BOX + ABOX,
                  reinterpret_cast<const float*>(st + sb1), kb * 256,
                  min(256, D - kb * 256), lg, kw, c0, g, q);
        ws::consumer_release(bars, slot);
      }
      // the slices' sums in slice order: slice s adds its own
#pragma unroll 1
      for (int s = 0; s < Geo::KW; ++s) {
        if (kw == s)
          acc.each(c0, g, q, [&](int tok, int ch, float v) {
            if (tok < B) {
              float* r = red + tok * CB + ch;
              *r = s == 0 ? v : *r + v;
            }
          });
        ws::consumers_sync();
      }
      if (cb == 0) {
        cluster_wait();                 // barrier 1: every rank is running
        hopper::grid_wait();            // s_a from the quantizer
      }
      // activation pairs (p, p + 1) of the block's CB / 2 columns: gate
      // channel 16 m + c, up 16 m + 8 + c for column 8 m + c; the tile's
      // column i = chan0 / 2 + p lies in box i / 64 at column i % 64
      const int chan0 = rank * R1 + cb * CB;
      for (int e = tid; e < B * CB / 4; e += ws::CONSUMERS) {
        const int tok = e / (CB / 4), p = 2 * (e % (CB / 4));
        const float sa = s_a[tok];
        float a2[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int m = (p + u) >> 3, c = (p + u) & 7;
          const float gate = __fmul_rn(red[tok * CB + 16 * m + c], sa);
          const float up = __fmul_rn(red[tok * CB + 16 * m + 8 + c], sa);
          a2[u] = __fmul_rn(__fdiv_rn(gate, __fadd_rn(1.f, expf(-gate))), up);
        }
        const uint32_t v = hopper::pack_bf16(a2[0], a2[1]);
        const int col = chan0 / 2 + p;
        const uint32_t at = hopper::smem_u32(
            act + (col / 64) * ABOX + hopper::swz128(tok, (col % 64) >> 3) +
            2 * (col & 7));
        for (int r = 0; r < C; ++r) st_rank(at, r, v);
      }
      ws::consumers_sync();             // red is free for the next block
    }
  }
  cluster_arrive_release();             // barrier 2: the tile's activation
  cluster_wait();

  // ---- 3. the rank's down columns over the tile's ti rows
  {
    const int cs = warp % Dn::CS3, box = cs / 2;
    const int t0 = (warp / Dn::CS3) * Dn::TP3;  // this warp's token tiles
    const int colb = (cs & 1) * 64 + 8 * g;     // this thread's 8 columns
    const int w_off0 = hopper::swz128(2 * q, colb >> 4) + (colb & 8);
    const int w_off1 = hopper::swz128(2 * q + 1, colb >> 4) + (colb & 8);
    const int arow = ws::spread(g);
    for (int p = 0; p < np3; ++p) {
      const int nb = Dn::boxes(DC, p);
      const bool mine = box < nb;
      float acc[Dn::TP3][4][4] = {};
      uint32_t s2[8];
      int gcur = -1;
      for (int b = 0; b < nb; ++b, ++i) {
        const int slot = ws::consumer_wait(bars, i);
        if (b == box) {
          const uint8_t* stb = smem + size_t(slot) * stage;
          for (int kb = 0; kb < nk3; ++kb) {
            const uint8_t* st = stb + kb * W3BOX;
            const uint8_t* ab = act + 2 * kb * ABOX;
#pragma unroll 2
            for (int j = 0; j < 8; ++j) {
              const int grp = (kb * 128 + 16 * j) / gd;
              if (grp != gcur) {
                gcur = grp;
                const float4* sp = reinterpret_cast<const float4*>(
                    stb + nk3 * W3BOX + grp * SRB + colb * 4);
                const float4 sa = sp[0], sb = sp[1];
                const float sv[8] = {sa.x, sa.y, sa.z, sa.w,
                                     sb.x, sb.y, sb.z, sb.w};
#pragma unroll
                for (int jj = 0; jj < 8; ++jj)
                  s2[jj] = hopper::pack_bf16(sv[jj], sv[jj]);
              }
              uint32_t a[4][4];
              ws::w4a16_frag(st, w_off0, w_off1, j, s2, a);
#pragma unroll
              for (int t = 0; t < Dn::TP3; ++t) {
                uint32_t b0, b1;
                ws::act_pair_bf16(ab, ABOX, 8 * (t0 + t) + arow, j, q, b0,
                                  b1);
#pragma unroll
                for (int mt = 0; mt < 4; ++mt)
                  ws::mma_bf16(acc[t][mt], a[mt], b0, b1);
              }
            }
          }
        }
        ws::consumer_release(bars, slot);
      }
      if (!mine) continue;
      const int nbase = n3 + Dn::PW3 * p + 128 * box + colb;
      const int nend = min(n3 + DC, D);
#pragma unroll
      for (int t = 0; t < Dn::TP3; ++t)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tok = 8 * (t0 + t) + ws::spread(2 * q + (e & 1));
            const int n = nbase + 2 * mt + (e >> 1);
            if (tok < B && n < nend)
              part[(size_t(tile) * B + tok) * D + n] = acc[t][mt][e];
          }
    }
  }
}

// out[e] = sum over tiles j, in order, of part[j][e], e < B * D
template <typename TO>
__global__ void __launch_bounds__(RED_NT)
mlp_reduce(const float* __restrict__ part, TO* __restrict__ out, int Ib,
           int BD) {
  hopper::grid_wait();          // the tile kernel's partials
  const int e = blockIdx.x * RED_NT + threadIdx.x;
  if (e >= BD) return;
  float s = 0.f;
  int j = 0;
  for (; j + RED_UNROLL <= Ib; j += RED_UNROLL) {
    float v[RED_UNROLL];          // the loads in flight together
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u)
      v[u] = __ldg(part + size_t(j + u) * BD + e);
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u) s += v[u];
  }
  for (; j < Ib; ++j) s += __ldg(part + size_t(j) * BD + e);
  store_out(out + e, s);
}

// the cluster size of a launch of the kernel fn for CB-channel blocks:
// the most of 8, 4, 2, 1 that splits the tile's 2 ti gate/up channels
// into whole blocks (blocks of 128 but for the smallest cluster size
// that needs blocks of 64) and D into column ranges of a multiple of 4,
// and whose Ib clusters the card holds at once, or 0 where none of those
// that this CB serves fits; cached by (kernel, shared bytes, Ib, ti, D)
int cluster_size(const void* fn, int CB, size_t smem, int Ib, int ti,
                 int D) {
  struct Entry {
    const void* fn;
    size_t smem;
    int Ib, ti, D, C;
  };
  static Entry cache[64];
  static int used = 0;
  for (int k = 0; k < used; ++k)
    if (cache[k].fn == fn && cache[k].smem == smem && cache[k].Ib == Ib &&
        cache[k].ti == ti && cache[k].D == D)
      return cache[k].C;
  int C = 0;
  for (int c = 8; c >= 1; c /= 2) {
    const int r1 = 2 * ti / c;
    // 64-channel blocks only where 128 would not divide
    if (r1 % CB != 0 || (CB == 64 && r1 % 128 == 0) || D % (4 * c) != 0)
      continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c, Ib);
    cfg.blockDim = dim3(ws::NT);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) == cudaSuccess &&
        (n >= Ib || c == 1)) {
      C = c;
      break;
    }
    cudaGetLastError();
  }
  if (used < 64) cache[used++] = {fn, smem, Ib, ti, D, C};
  return C;
}

// the tile kernel's launch at TT token tiles: blocks of 64 channels in
// clusters that split a tile 2 ti / 64 ways where all I/ti of those
// clusters fit on the card at once, else blocks of 128 (cluster_size)
struct TilePlan {
  const void* fn;
  int CB;
  size_t smem;
  int C;
};

template <int TT, int RW, int CB>
int plan_cb(int B, int D, int ti, int Ib, int scr1, int scr3,
            TilePlan* pl) {
  pl->fn = reinterpret_cast<const void*>(mlp_tile_kernel<TT, RW, CB>);
  pl->CB = CB;
  pl->smem = smem_bytes<TT, CB>(B, ti, scr1, scr3);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_tile_kernel<TT, RW, CB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(pl->smem));
  if (err != cudaSuccess) return int(err);
  pl->C = cluster_size(pl->fn, CB, pl->smem, Ib, ti, D);
  return 0;
}

template <int TT, int RW>
int plan_tile(int B, int D, int ti, int Ib, int scr1, int scr3,
              TilePlan* pl) {
  int err = plan_cb<TT, RW, 64>(B, D, ti, Ib, scr1, scr3, pl);
  if (err != 0 || pl->C > 0) return err;
  return plan_cb<TT, RW, 128>(B, D, ti, Ib, scr1, scr3, pl);
}

template <int TT, int RW>
int launch_tile(const void* mgu, const void* mgs, const void* mdw,
                const void* mds, const void* he, const void* s_a, void* part,
                int B, int D, int I, int G, int Gd, int ti,
                cudaStream_t stream) {
  const int group = D / G, gd = I / Gd, Ib = I / ti;
  const int scr1 = scale_rows(group, 256), scr3 = ti / gd;
  TilePlan pl;
  int e = plan_tile<TT, RW>(B, D, ti, Ib, scr1, scr3, &pl);
  if (e != 0) return e;
  CUtensorMap tm_gu, tm_h, tm_d;
  if (!hopper::map_stripes(&tm_gu, mgu, 1, D / 2, 2 * ti, Ib, 128, pl.CB,
                           true) ||
      !hopper::map_stripes(&tm_h, he, 1, D / 2, B, 2, 128, 8 * TT, true) ||
      !hopper::map_stripes(&tm_d, mdw, 1, D, I / 2, 1, 128, 64, true))
    return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.C, Ib);
  cfg.blockDim = dim3(ws::NT);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const float* gs = static_cast<const float*>(mgs);
  const float* ds = static_cast<const float*>(mds);
  const float* sa = static_cast<const float*>(s_a);
  float* pt = static_cast<float*>(part);
  const int lg = __builtin_ctz(group);
  void* args[] = {&tm_gu, &tm_h, &tm_d, &gs, &ds, &sa, &pt, &B, &D, &G,
                  const_cast<int*>(&lg), &ti, const_cast<int*>(&gd),
                  const_cast<int*>(&scr1), const_cast<int*>(&scr3)};
  return int(cudaLaunchKernelExC(&cfg, pl.fn, args));
}

template <int RW>
int launch_tile_b(const void* mgu, const void* mgs, const void* mdw,
                  const void* mds, const void* he, const void* s_a,
                  void* part, int B, int D, int I, int G, int Gd, int ti,
                  cudaStream_t st) {
  switch (ws::token_tiles(B)) {
    case 1:
      return launch_tile<1, RW>(mgu, mgs, mdw, mds, he, s_a, part, B, D, I,
                                G, Gd, ti, st);
    case 2:
      return launch_tile<2, RW>(mgu, mgs, mdw, mds, he, s_a, part, B, D, I,
                                G, Gd, ti, st);
    case 4:
      return launch_tile<4, RW>(mgu, mgs, mdw, mds, he, s_a, part, B, D, I,
                                G, Gd, ti, st);
    default:
      return launch_tile<8, RW>(mgu, mgs, mdw, mds, he, s_a, part, B, D, I,
                                G, Gd, ti, st);
  }
}

}  // namespace

// h [B, D] (bf16 or fp32: h_f32); mgu, mgs, mdw, mds as above (I-tiles of
// ti = 128 or 256); he/ho [B, D/2] int8 (ho right after he), s_a [B] fp32
// and part [I/ti, B, D] fp32 caller-allocated scratch; out [B, D] (bf16 or
// fp32: out_f32). D % 32 == 0, gate/up groups of D/G = 32 * 2^i rows, down
// groups of I/Gd rows dividing ti, a multiple of 16.
extern "C" int aurora_fused_mlp_w4(const void* h, const void* mgu,
                                   const void* mgs, const void* mdw,
                                   const void* mds, void* he, void* ho,
                                   void* s_a, void* part, void* out, int B,
                                   int D, int I, int G, int Gd, int ti,
                                   int h_f32, int out_f32, void* stream) {
  if (B <= 0 || B > MAX_B || D <= 0 || D % 32 != 0 || G <= 0 ||
      D % G != 0 || (ti != 128 && ti != 256) || I <= 0 || I % ti != 0 ||
      Gd <= 0 || I % Gd != 0 || ti % (I / Gd) != 0 || (I / Gd) % 16 != 0 ||
      static_cast<int8_t*>(ho) != static_cast<int8_t*>(he) + size_t(B) * D / 2)
    return int(cudaErrorInvalidValue);
  const int group = D / G;
  if (group < 32 || (group & (group - 1)) != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_f32)
    quantize_rows<float><<<B, QNT, 0, st>>>(
        static_cast<const float*>(h), static_cast<int8_t*>(he),
        static_cast<int8_t*>(ho), static_cast<float*>(s_a), D);
  else
    quantize_rows<bf16><<<B, QNT, 0, st>>>(
        static_cast<const bf16*>(h), static_cast<int8_t*>(he),
        static_cast<int8_t*>(ho), static_cast<float*>(s_a), D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int e = group % 128 == 0
                    ? launch_tile_b<16>(mgu, mgs, mdw, mds, he, s_a, part, B,
                                        D, I, G, Gd, ti, st)
                    : launch_tile_b<4>(mgu, mgs, mdw, mds, he, s_a, part, B,
                                       D, I, G, Gd, ti, st);
  if (e != 0) return e;
  // the reduction behind the tile kernel, a programmatic dependent too
  int BD = B * D, Ib = I / ti;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((BD + RED_NT - 1) / RED_NT);
  cfg.blockDim = dim3(RED_NT);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const float* pt = static_cast<const float*>(part);
  void* args[] = {&pt, &out, &Ib, &BD};
  return int(cudaLaunchKernelExC(
      &cfg,
      out_f32 ? reinterpret_cast<const void*>(mlp_reduce<float>)
              : reinterpret_cast<const void*>(mlp_reduce<bf16>),
      args));
}

// the cluster size and channel block a launch of the tile kernel takes
// for B rows, an MLP of width D with I-tiles of ti (Ib of them), gate/up
// groups of `group` rows and down groups of gd
extern "C" int aurora_fused_mlp_cluster(int B, int D, int ti, int Ib,
                                        int group, int gd, int* C, int* CB) {
  if (B <= 0 || B > MAX_B || Ib <= 0 || (ti != 128 && ti != 256) ||
      group <= 0 || gd <= 0 || ti % gd != 0)
    return int(cudaErrorInvalidValue);
  const int scr1 = scale_rows(group, 256), scr3 = ti / gd;
  TilePlan pl;
  int err;
  const bool r16 = group % 128 == 0;
#define AURORA_MLP_PLAN(TT)                                                \
  err = r16 ? plan_tile<TT, 16>(B, D, ti, Ib, scr1, scr3, &pl)             \
            : plan_tile<TT, 4>(B, D, ti, Ib, scr1, scr3, &pl)
  switch (ws::token_tiles(B)) {
    case 1: AURORA_MLP_PLAN(1); break;
    case 2: AURORA_MLP_PLAN(2); break;
    case 4: AURORA_MLP_PLAN(4); break;
    default: AURORA_MLP_PLAN(8);
  }
#undef AURORA_MLP_PLAN
  *C = pl.C;
  *CB = pl.CB;
  return err;
}

// the tile kernel for up to `rows` token rows (1..64), groups of 128, in
// the channel blocks the 7B MLP's tiles (ti 256) take: 64 at up to 8
// rows, else 128; its dynamic shared bytes, for aurora_kernel_attrs
extern "C" int aurora_fused_mlp_kernel(int rows, const void** fn,
                                       int* smem) {
  if (rows <= 0 || rows > MAX_B) return int(cudaErrorInvalidValue);
#define AURORA_MLP_FN(TT, CB)                                              \
  do {                                                                     \
    *fn = reinterpret_cast<const void*>(mlp_tile_kernel<TT, 16, CB>);      \
    *smem = int(smem_bytes<TT, CB>(rows, 256, 2, 2));                      \
  } while (0)
  switch (ws::token_tiles(rows)) {
    case 1: AURORA_MLP_FN(1, 64); break;
    case 2: AURORA_MLP_FN(2, 128); break;
    case 4: AURORA_MLP_FN(4, 128); break;
    default: AURORA_MLP_FN(8, 128); break;
  }
#undef AURORA_MLP_FN
  return 0;
}
