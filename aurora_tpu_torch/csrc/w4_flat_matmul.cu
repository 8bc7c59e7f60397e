// W4A8 and W4A16 decode matmuls over the reference's flat W4 layout,
// sm_90a.
//
// Replaces: aurora_tpu/ops/pallas/quant_matmul.py `w4a8_matmul` (Pallas
// kernel `_kernel_w4a8`) and `w4a16_matmul` (Pallas kernel `_kernel4`).
// Layout (the reference's, kept as it is): packed [K/2, N] int8, K-major
// (byte (p, n) holds input rows 2p and 2p + 1 of output column n in its low
// and high nibble), scales [G, N] fp32 for G groups of K/G input rows.
//
// Contracts, for h [B, K] (B <= 64):
//   w4a8:  the W4A8 recipe of w4a8_matmul.cu (per-token int8 activations,
//          exact int32 group partials, group scales in fp32, s_a last);
//   w4a16: out[b, n] = sum_k bf16(h[b, k]) * bf16(bf16(q[k, n]) *
//          bf16(s[g(k), n])), fp32 accumulation (the reference's bf16
//          dequantization in VMEM, then a bf16 MXU dot into fp32).
// Only the fp32 order of the sums differs from the plain twins.
//
// What bounds them on the H100: at decode each weight byte feeds 2 * B
// multiply-adds, so both are bound by the packed weight stream from HBM.
//
// Design (W4A8): in this layout consecutive bytes are consecutive output
// columns, not consecutive K, so w4a8_matmul.cu's __dp4a over four packed
// K-bytes does not apply directly. A thread owns 4 columns (one 32-bit
// word per packed row) and walks whole scale groups, transposing 4 rows
// x 4 columns of bytes with __byte_perm to get four K-consecutive bytes
// per column and running __dp4a on them (w4_common.cuh `a8_group`). A
// block is 8 column threads (32 columns, one 32-byte sector per packed
// row) by 32 K-slices, slice s taking groups s, s + 32, ...; the slices'
// partials are summed through shared memory in slice order. No split
// across blocks and no atomics, so every run repeats bit for bit. Token
// rows run 4 at a time, more as further row tiles of the grid (each
// re-reads the weights). int8 mma tiles and deeper load pipelining are
// later speed work. W4A16 is a tensor-core weight streamer
// (weight_stream.cuh), described at its kernel below.

#include "weight_stream.cuh"

namespace {

constexpr int CT = 8;              // column threads per block
constexpr int KS = 32;             // K-slices per block
constexpr int NT = CT * KS;
constexpr int BN = CT * 4;         // output columns per block

// Sum the slices' partials in slice order and store times `mul(r)`.
template <typename TO, typename Mul>
__device__ __forceinline__ void reduce_store(float (&red)[KS][FR][BN],
                                             const float (&acc)[FR][4],
                                             int ks, int cx, TO* out, int r0,
                                             int nr, int N, Mul mul) {
#pragma unroll
  for (int r = 0; r < FR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ks][r][cx * 4 + c] = acc[r][c];
  __syncthreads();
  if (threadIdx.x < FR * BN) {
    const int r = threadIdx.x / BN, col = threadIdx.x % BN;
    const int n = blockIdx.x * BN + col;
    if (r < nr && n < N) {
      float s = 0.f;
      for (int k = 0; k < KS; ++k) s += red[k][r][col];
      store_out(out + size_t(r0 + r) * N + n, s * mul(r));
    }
  }
}

template <typename TO>
__global__ void __launch_bounds__(NT)
w4a8_flat_kernel(const int8_t* __restrict__ packed,
                 const float* __restrict__ scale,
                 const int8_t* __restrict__ he, const int8_t* __restrict__ ho,
                 const float* __restrict__ s_a, TO* __restrict__ out, int B,
                 int K, int N, int G) {
  __shared__ float red[KS][FR][BN];
  const int cx = threadIdx.x % CT, ks = threadIdx.x / CT;
  const int n = blockIdx.x * BN + cx * 4;
  const int r0 = blockIdx.y * FR, nr = min(FR, B - r0);
  const int K2 = K / 2, gh = K2 / G;
  float acc[FR][4] = {};
  if (n < N) {
    for (int g = ks; g < G; g += KS) {
      int part[FR][4];
      a8_group(part, packed + size_t(g) * gh * N + n, N,
               he + size_t(r0) * K2, ho + size_t(r0) * K2, K2, g * gh, gh,
               nr);
      const float4 sw =
          __ldg(reinterpret_cast<const float4*>(scale + size_t(g) * N + n));
      const float s4[4] = {sw.x, sw.y, sw.z, sw.w};
#pragma unroll
      for (int r = 0; r < FR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] += float(part[r][c] >> 4) * s4[c];   // >> 4: exact
    }
  }
  reduce_store(red, acc, ks, cx, out, r0, nr, N,
               [&](int r) { return s_a[r0 + r]; });
}

// ---------------------------------------------------------------- W4A16
// weight_stream.cuh's streamer over the flat layout. A stage holds one
// TMA box of the tile's 64 packed rows (128 k) x 128 columns, the B
// activation rows' 128 k as they lie (bf16 or fp32) in boxes of 128
// bytes a row, and the scale rows of the groups it touches; the boxes
// carry the 128-byte swizzle. Where N % 16 != 0 the packed rows do not
// start on 16-byte boundaries, which TMA needs: the producer's lanes then
// copy the weight box by 4-byte cp.async into the same swizzled places,
// and their completion joins the stage's mbarrier.
//
// A k-step is one mma.sync m16n8k16 (bf16 in, fp32 accumulation) per 16
// columns and 8 tokens, the weights as A. Thread (g, q) owns the 8
// consecutive columns 64 * cw + 8g .. + 7 and the packed rows p = 8j + 2q
// and p + 1 of step j: one 8-byte read of each row gives it, for each of
// its columns, the bytes (p, n) and (p + 1, n), whose low nibbles (k 2p,
// 2p + 2) and high nibbles (k 2p + 1, 2p + 3) are exactly one bf16x2
// register each of the A fragment, as k pairs q and q + 4. Column 8g + jj
// takes fragment row jj / 2 * 16 + jj % 2 * 8 + g. A nibble holding the
// signed value v becomes bf16 by (nibble & 0xF) ^ 0x4308, the bits of
// 128 + (v + 8), and a subtraction of 136 (exact), then one bf16 multiply
// by the bf16 scale pair, which rounds once: bf16(bf16(v) * bf16(s)),
// the reference's weight, since v * s is exact in fp32. The activations
// take the same permutation of k: the thread reads k 4q .. 4q + 3 of the
// step from token row 8t + spread(g) and pairs k 4q with 4q + 2 and
// 4q + 1 with 4q + 3. The products are exact in fp32 and the tensor core
// sums them in fp32: only the order of the sums differs from the plain
// twin.

constexpr int WBOX = 64 * 128;     // bytes of a stage's weight box
constexpr int SRB = ws::BN * 4;    // bytes of a scale row's slot

// an activation box: 128 bytes of each of 8 * TT rows, ws::SK / (128 /
// sizeof(TI)) boxes a stage
template <int TT, typename TI>
__host__ __device__ constexpr int act_bytes() {
  return 8 * TT * ws::SK * int(sizeof(TI));
}

template <int TT, typename TI>
__host__ __device__ size_t w4a16_stage_bytes(int scr) {
  const size_t b = size_t(WBOX) + act_bytes<TT, TI>() + size_t(scr) * SRB;
  return (b + 1023) & ~size_t(1023);
}

size_t w4a16_red_bytes(int B) {
  return size_t(ws::KW) * B * ws::BN * sizeof(float);
}

// bf16x2 of the two nibbles at bits 0-3 and 16-19 of t, times s2
__device__ __forceinline__ uint32_t dq_pair(uint32_t t, uint32_t s2) {
  const uint32_t v = (t & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const uint32_t k136 = 0x43084308u;
  x = __hsub2(x, *reinterpret_cast<const __nv_bfloat162*>(&k136));
  x = __hmul2(x, *reinterpret_cast<const __nv_bfloat162*>(&s2));
  return *reinterpret_cast<uint32_t*>(&x);
}

// the B fragment of token row `row` of the activation boxes at `act`
// (boxes of 8 * TT rows) for k 4q .. 4q + 3 of step j: (k 4q, 4q + 2),
// (k 4q + 1, 4q + 3), rounded to bf16
template <int TT>
__device__ __forceinline__ void act_pair(const uint8_t* act, const bf16*,
                                         int row, int j, int q, uint32_t& b0,
                                         uint32_t& b1) {
  const uint8_t* box = act + (j >> 2) * (8 * TT * 128);
  const uint2 u = *reinterpret_cast<const uint2*>(
      box + hopper::swz128(row, 2 * (j & 3) + (q >> 1)) + 8 * (q & 1));
  b0 = __byte_perm(u.x, u.y, 0x5410);
  b1 = __byte_perm(u.x, u.y, 0x7632);
}
template <int TT>
__device__ __forceinline__ void act_pair(const uint8_t* act, const float*,
                                         int row, int j, int q, uint32_t& b0,
                                         uint32_t& b1) {
  const uint8_t* box = act + (j >> 1) * (8 * TT * 128);
  const float4 f = *reinterpret_cast<const float4*>(
      box + hopper::swz128(row, 4 * (j & 1) + q));
  b0 = hopper::pack_bf16(f.x, f.z);
  b1 = hopper::pack_bf16(f.y, f.w);
}

// token rows a fragment column g reads: 8-byte reads (bf16) or 16-byte
__device__ __forceinline__ int act_row(const bf16*, int g) {
  return ws::spread(g);
}
__device__ __forceinline__ int act_row(const float*, int g) {
  return ws::spread4(g);
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

template <int TT, typename TI, typename TO>
__global__ void __launch_bounds__(ws::NT, ws::min_blocks(TT))
w4a16_kernel(const __grid_constant__ CUtensorMap tm_w,
             const __grid_constant__ CUtensorMap tm_h,
             const int8_t* __restrict__ packed,
             const float* __restrict__ scale, TO* __restrict__ out,
             float* __restrict__ part, int* __restrict__ tickets, int B,
             int K, int N, int group, int span, int nsplit, int scr,
             int tma_w) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  __shared__ ws::Bars bars;
  const int n0 = blockIdx.x * ws::BN;
  const int k0 = blockIdx.y * span, k1 = min(K, k0 + span);
  const int nst = (k1 - k0 + ws::SK - 1) / ws::SK;
  const size_t stage = w4a16_stage_bytes<TT, TI>(scr);
  constexpr int ABOX = 8 * TT * 128;          // bytes of one activation box
  constexpr int E = 128 / int(sizeof(TI));    // k values a box row holds
  const int sbase = WBOX + act_bytes<TT, TI>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ws::init_bars(bars);

  if (warp == ws::PRODUCER) {
    const int nv = min(ws::BN, N - n0);       // a multiple of 4
    for (int i = 0; i < nst; ++i) {
      const int slot = ws::producer_acquire(bars, i);
      const int kc = k0 + i * ws::SK, len = min(ws::SK, k1 - kc);
      const int g0 = kc / group;
      const int ng = (kc + len - 1) / group - g0 + 1;
      uint8_t* st = smem + size_t(slot) * stage;
      uint64_t* full = &bars.full[slot];
      if (!tma_w) {
        for (int e = lane; e < len / 2 * 32; e += 32) {
          const int p = e >> 5, w = e & 31;
          if (4 * w < nv)
            cp_async4(st + hopper::swz128(p, w >> 2) + 4 * (w & 3),
                      packed + size_t(kc / 2 + p) * N + n0 + 4 * w);
        }
        cp_async_mbar_arrive(full);
        __syncwarp();
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(
            full, (tma_w ? WBOX : 0) + act_bytes<TT, TI>() + ng * 4 * nv);
        if (tma_w) hopper::tma_load_3d(st, &tm_w, full, n0, kc / 2, 0);
        for (int b = 0; b < ws::SK / E; ++b)
          hopper::tma_load_3d(st + WBOX + b * ABOX, &tm_h, full,
                               (kc + b * E) * int(sizeof(TI)), 0, 0);
        for (int r = 0; r < ng; ++r)
          hopper::bulk_copy_1d(st + sbase + r * SRB,
                               scale + size_t(g0 + r) * N + n0, 4 * nv, full);
      }
    }
    return;
  }

  const int cw = warp % ws::CW, kw = warp / ws::CW;
  const int g = lane >> 2, q = lane & 3;
  const int col = cw * 64 + 8 * g;       // this thread's 8 columns
  const int arow = act_row(static_cast<const TI*>(nullptr), g);
  // packed rows 8j + 2q and 8j + 2q + 1 of a stage, this thread's bytes:
  // at these offsets plus 1024 j (the swizzle repeats every 8 rows)
  const int w_off0 = hopper::swz128(2 * q, col >> 4) + (col & 8);
  const int w_off1 = hopper::swz128(2 * q + 1, col >> 4) + (col & 8);
  const int lg = __ffs(group) - 1;       // group = 1 << lg, or -1: divide
  const bool pow2 = (group & (group - 1)) == 0;
  float acc[TT][4][4] = {};
  uint32_t s2[8];
  int gcur = -1;
  for (int i = 0; i < nst; ++i) {
    const int slot = ws::consumer_wait(bars, i);
    const int kc = k0 + i * ws::SK, len = min(ws::SK, k1 - kc);
    const int g0 = pow2 ? kc >> lg : kc / group;
    const uint8_t* st = smem + size_t(slot) * stage;
    for (int j = kw; j * 16 < len; j += ws::KW) {
      const int grp = pow2 ? (kc + 16 * j) >> lg : (kc + 16 * j) / group;
      if (grp != gcur) {
        gcur = grp;
        const float4* sp = reinterpret_cast<const float4*>(
            st + sbase + (grp - g0) * SRB + col * 4);
        const float4 sa = sp[0], sb = sp[1];
        const float sv[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s2[jj] = hopper::pack_bf16(sv[jj], sv[jj]);
      }
      const uint2 wa =
          *reinterpret_cast<const uint2*>(st + 1024 * j + w_off0);
      const uint2 wb =
          *reinterpret_cast<const uint2*>(st + 1024 * j + w_off1);
      uint32_t a[4][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const uint32_t t = __byte_perm(jj < 4 ? wa.x : wa.y,
                                       jj < 4 ? wb.x : wb.y,
                                       (jj & 3) | ((4 + (jj & 3)) << 8));
        a[jj >> 1][jj & 1] = dq_pair(t, s2[jj]);
        a[jj >> 1][2 + (jj & 1)] = dq_pair(t >> 4, s2[jj]);
      }
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        uint32_t b0, b1;
        act_pair<TT>(st + WBOX, static_cast<const TI*>(nullptr), 8 * t + arow,
                     j, q, b0, b1);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) ws::mma_bf16(acc[t][mt], a[mt], b0, b1);
      }
    }
    ws::consumer_release(bars, slot);
  }

  ws::consumers_sync();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * t + act_row(static_cast<const TI*>(nullptr),
                                        2 * q + (e & 1));
        if (tok < B)
          red[(size_t(kw) * B + tok) * ws::BN + col + 2 * mt + (e >> 1)] =
              acc[t][mt][e];
      }
  ws::finish(bars, red, part, tickets, B, N, n0, blockIdx.y, nsplit,
             [&](int b, int n, float v) {
               store_out(out + size_t(b) * N + n, v);
             });
}

bool flat_shapes_ok(int B, int K, int N, int G) {
  return B > 0 && B <= MAX_B && N > 0 && N % 4 == 0 && G > 0 && K % 8 == 0 &&
         (K / 2) % G == 0 && ((K / 2) / G) % 4 == 0;
}

template <typename TI, typename TO>
int launch_w4a8(const void* h, const void* packed, const void* scale,
                void* he, void* ho, void* s_a, void* out, int B, int K, int N,
                int G, cudaStream_t stream) {
  quantize_rows<TI><<<B, QNT, 0, stream>>>(
      static_cast<const TI*>(h), static_cast<int8_t*>(he),
      static_cast<int8_t*>(ho), static_cast<float*>(s_a), K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + BN - 1) / BN, (B + FR - 1) / FR);
  w4a8_flat_kernel<TO><<<grid, NT, 0, stream>>>(
      static_cast<const int8_t*>(packed), static_cast<const float*>(scale),
      static_cast<const int8_t*>(he), static_cast<const int8_t*>(ho),
      static_cast<const float*>(s_a), static_cast<TO*>(out), B, K, N, G);
  return int(cudaGetLastError());
}

template <int TT, typename TI, typename TO>
int launch_w4a16(const void* h, const void* packed, const void* scale,
                 void* out, void* part, void* tickets, int B, int K, int N,
                 int group, int span, int nsplit, int scr,
                 cudaStream_t stream) {
  // the weight box by TMA where the packed rows are 16-byte aligned
  const int tma_w = N % 16 == 0;
  // the activations as rows of bytes, boxes of 128 bytes
  CUtensorMap tm_w = {}, tm_h;
  if ((tma_w && !hopper::map_stripes(&tm_w, packed, 1, N, K / 2, 1, ws::BN,
                                     64, true)) ||
      !hopper::map_stripes(&tm_h, h, 1, K * int(sizeof(TI)), B, 1, 128,
                           8 * TT, true))
    return int(cudaErrorInvalidValue);
  const size_t stage = w4a16_stage_bytes<TT, TI>(scr);
  const size_t smem = ws::ring_smem(stage, w4a16_red_bytes(B));
  cudaError_t err = cudaFuncSetAttribute(
      w4a16_kernel<TT, TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + ws::BN - 1) / ws::BN, nsplit);
  w4a16_kernel<TT, TI, TO><<<grid, ws::NT, smem, stream>>>(
      tm_w, tm_h, static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<TO*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), B, K, N, group,
      span, nsplit, scr, tma_w);
  return int(cudaGetLastError());
}

template <typename TI, typename TO>
int launch_w4a16_b(const void* h, const void* packed, const void* scale,
                   void* out, void* part, void* tickets, int B, int K, int N,
                   int group, int span, int nsplit, int scr,
                   cudaStream_t st) {
  switch (ws::token_tiles(B)) {
    case 1:
      return launch_w4a16<1, TI, TO>(h, packed, scale, out, part, tickets, B,
                                     K, N, group, span, nsplit, scr, st);
    case 2:
      return launch_w4a16<2, TI, TO>(h, packed, scale, out, part, tickets, B,
                                     K, N, group, span, nsplit, scr, st);
    case 4:
      return launch_w4a16<4, TI, TO>(h, packed, scale, out, part, tickets, B,
                                     K, N, group, span, nsplit, scr, st);
    default:
      return launch_w4a16<8, TI, TO>(h, packed, scale, out, part, tickets, B,
                                     K, N, group, span, nsplit, scr, st);
  }
}

// scale rows a stage of SK k can touch, for groups of `group` k and
// stages that start SK apart from a group boundary
int scale_rows(int group) {
  if (group % ws::SK == 0) return 1;
  if (ws::SK % group == 0) return ws::SK / group;
  return (ws::SK + group - 1) / group + 1;
}

}  // namespace

// h [B, K] (bf16 or fp32: h_f32), packed [K/2, N] int8 and scale [G, N]
// fp32 (the flat layout), he/ho [B, K/2] int8 and s_a [B] fp32
// caller-allocated scratch, out [B, N] (bf16 or fp32: out_f32). N % 4 == 0,
// groups of a multiple of 8 input rows.
extern "C" int aurora_w4a8_flat_matmul(const void* h, const void* packed,
                                       const void* scale, void* he, void* ho,
                                       void* s_a, void* out, int B, int K,
                                       int N, int G, int h_f32, int out_f32,
                                       void* stream) {
  if (!flat_shapes_ok(B, K, N, G)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_f32) {
    return out_f32 ? launch_w4a8<float, float>(h, packed, scale, he, ho, s_a,
                                               out, B, K, N, G, st)
                   : launch_w4a8<float, bf16>(h, packed, scale, he, ho, s_a,
                                              out, B, K, N, G, st);
  }
  return out_f32 ? launch_w4a8<bf16, float>(h, packed, scale, he, ho, s_a,
                                            out, B, K, N, G, st)
                 : launch_w4a8<bf16, bf16>(h, packed, scale, he, ho, s_a, out,
                                           B, K, N, G, st);
}

// The same operands without the quantizer's scratch: h is rounded to bf16
// as it is read. The grid: column tiles of 128 x nsplit splits of `span`
// k (a multiple of the group: weight_plan); with nsplit > 1, part holds
// nsplit * B * N fp32 and tickets one zero int32 per column tile (left
// zero). Groups of a multiple of 16 rows.
extern "C" int aurora_w4a16_matmul(const void* h, const void* packed,
                                   const void* scale, void* out, void* part,
                                   void* tickets, int B, int K, int N, int G,
                                   int span, int nsplit, int h_f32,
                                   int out_f32, void* stream) {
  if (!flat_shapes_ok(B, K, N, G) || (K / G) % 16 != 0 || span <= 0 ||
      span % (K / G) != 0 || nsplit <= 0 || nsplit > 65535 ||
      size_t(nsplit - 1) * span >= size_t(K) ||
      (nsplit > 1 && (part == nullptr || tickets == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = K / G, scr = scale_rows(group);
  if (h_f32) {
    return out_f32 ? launch_w4a16_b<float, float>(h, packed, scale, out, part,
                                                  tickets, B, K, N, group,
                                                  span, nsplit, scr, st)
                   : launch_w4a16_b<float, bf16>(h, packed, scale, out, part,
                                                 tickets, B, K, N, group,
                                                 span, nsplit, scr, st);
  }
  return out_f32 ? launch_w4a16_b<bf16, float>(h, packed, scale, out, part,
                                               tickets, B, K, N, group, span,
                                               nsplit, scr, st)
                 : launch_w4a16_b<bf16, bf16>(h, packed, scale, out, part,
                                              tickets, B, K, N, group, span,
                                              nsplit, scr, st);
}

// the W4A16 kernel for up to `rows` token rows (1..64), bf16 in and out,
// its dynamic shared bytes at that many rows with groups of `group` and
// the blocks of it one SM holds, for aurora_kernel_attrs and weight_plan
template <int TT>
int w4a16_attrs(int rows, int group, const void** fn, int* smem,
                int* blocks) {
  const size_t stage = w4a16_stage_bytes<TT, bf16>(scale_rows(group));
  *fn = reinterpret_cast<const void*>(w4a16_kernel<TT, bf16, bf16>);
  *smem = int(ws::ring_smem(stage, w4a16_red_bytes(rows)));
  cudaError_t err = cudaFuncSetAttribute(
      w4a16_kernel<TT, bf16, bf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, w4a16_kernel<TT, bf16, bf16>, ws::NT, *smem);
  return int(err);
}

extern "C" int aurora_w4a16_kernel(int rows, int group, const void** fn,
                                   int* smem, int* blocks) {
  if (rows <= 0 || rows > MAX_B || group <= 0 || group % 16 != 0)
    return int(cudaErrorInvalidValue);
  switch (ws::token_tiles(rows)) {
    case 1: return w4a16_attrs<1>(rows, group, fn, smem, blocks);
    case 2: return w4a16_attrs<2>(rows, group, fn, smem, blocks);
    case 4: return w4a16_attrs<4>(rows, group, fn, smem, blocks);
    default: return w4a16_attrs<8>(rows, group, fn, smem, blocks);
  }
}
