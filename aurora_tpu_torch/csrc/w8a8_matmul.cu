// W8A8 decode matmul: per-token int8 activations x int8 weights with one
// fp32 scale per output channel, sm_90a; and the activation quantizer
// that feeds it.
//
// Replaces: aurora_tpu/ops/pallas/quant_matmul.py `w8a8_matmul` (Pallas
// kernel `_kernel`). Contract, for h8 [B, K] int8 (B <= 64) with scales
// s_a [B] fp32 and a W8 stream w8 [N, K] int8 with scales s_w [N] fp32:
//   acc[b, n] = sum_k h8[b, k] * w8[n, k]                      (int32)
//   out[b, n] = float(acc[b, n]) * s_a[b] * s_w[n]
// in that order, rounded to the output type. |acc| <= 127^2 K, exact in
// int32 for every K the model has, so the result is the plain twin's and
// the reference's bit for bit, whatever the order of the sums.
//
// Layout: the nn.Linear one, row n of w8 holding output channel n, so
// every output channel's weights are one contiguous K-byte stripe.
//
// What bounds it on the H100: at decode each weight byte feeds 2 * B
// int8 operations (B <= 64), so the kernel is bound by the int8 weight
// stream from HBM (6.5 GB per 7B decode step), never by arithmetic.
//
// Design: weight_stream.cuh's streamer. Each stage holds one TMA box
// of the weights (128 channel rows x 128 k-bytes, 16 KB) and one of the
// activations (8 * TT token rows x 128 k-bytes, rows past B and k past K
// zero-filled), both with the 128-byte swizzle. A k-step is one mma.sync
// m16n8k32 (s8 x s8 -> s32) per 16 channels and 8 tokens: the weights
// are A (row-major, as they lie), the activation rows B (their k runs
// along the rows: the "col" operand as it stands). Thread (g, q) reads
// the 8 bytes [8q, 8q + 8) of the step from its rows, which the fragments
// take as k 4q.. and 16 + 4q..: a permutation of k shared by A and B,
// which the exact int32 sum does not see. Fragment row g (and column g)
// reads tile row 8i + ws::spread(g), so that a half-warp's rows differ in
// their swizzle and its reads hit distinct banks.

#include "weight_stream.cuh"

namespace {

constexpr int WBOX = ws::BN * ws::SK;      // bytes of a stage's weight box

__host__ __device__ constexpr int stage_bytes(int TT) {
  return WBOX + 8 * TT * ws::SK;
}

size_t red_bytes(int B) { return size_t(ws::KW) * B * ws::BN * sizeof(int); }

template <int TT, typename TO>
__global__ void __launch_bounds__(ws::NT, ws::min_blocks(TT))
w8a8_kernel(const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_h,
            const float* __restrict__ s_a, const float* __restrict__ s_w,
            TO* __restrict__ out, int* __restrict__ part,
            int* __restrict__ tickets, int B, int K, int N, int span,
            int nsplit) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  __shared__ ws::Bars bars;
  const int n0 = blockIdx.x * ws::BN;
  const int k0 = blockIdx.y * span, k1 = min(K, k0 + span);
  const int nst = (k1 - k0 + ws::SK - 1) / ws::SK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ws::init_bars(bars);

  if (warp == ws::PRODUCER) {
    if (lane == 0) {
      for (int i = 0; i < nst; ++i) {
        const int slot = ws::producer_acquire(bars, i);
        const int kc = k0 + i * ws::SK;
        uint8_t* st = smem + size_t(slot) * stage_bytes(TT);
        uint64_t* full = &bars.full[slot];
        hopper::mbar_expect_tx(full, stage_bytes(TT));
        hopper::tma_load_3d(st, &tm_w, full, kc, n0, 0);
        hopper::tma_load_3d(st + WBOX, &tm_h, full, kc, 0, 0);
      }
    }
    return;
  }

  const int cw = warp % ws::CW, kw = warp / ws::CW;
  const int g = lane >> 2, q = lane & 3, sg = ws::spread(g);
  int acc[TT][4][4] = {};
  for (int i = 0; i < nst; ++i) {
    const int slot = ws::consumer_wait(bars, i);
    const int len = min(ws::SK, k1 - (k0 + i * ws::SK));
    const uint8_t* st = smem + size_t(slot) * stage_bytes(TT);
    for (int j = kw; j * 32 < len; j += ws::KW) {
      // bytes [8q, 8q + 8) of the step: half of 16-byte chunk 2j + q / 2
      const int chunk = 2 * j + (q >> 1), half = 8 * (q & 1);
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              st + hopper::swz128(cw * 64 + 16 * mt + 8 * h + sg, chunk) +
              half);
          a[mt][h] = v.x;
          a[mt][2 + h] = v.y;
        }
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const uint2 x = *reinterpret_cast<const uint2*>(
            st + WBOX + hopper::swz128(8 * t + sg, chunk) + half);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) ws::mma_s8(acc[t][mt], a[mt], x.x, x.y);
      }
    }
    ws::consumer_release(bars, slot);
  }

  // the k-slices' partials [KW][B][BN] over the ring, then the ending
  ws::consumers_sync();
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * t + ws::spread(2 * q + (e & 1));
        const int ch = cw * 64 + 16 * mt + 8 * (e >> 1) + sg;
        if (tok < B) red[(size_t(kw) * B + tok) * ws::BN + ch] = acc[t][mt][e];
      }
  ws::finish(bars, red, part, tickets, B, N, n0, blockIdx.y, nsplit,
             [&](int b, int n, int v) {
               store_out(out + size_t(b) * N + n,
                         float(v) * __ldg(s_a + b) * __ldg(s_w + n));
             });
}

template <int TT, typename TO>
int launch(const void* h8, const void* s_a, const void* w8, const void* s_w,
           void* out, void* part, void* tickets, int B, int K, int N,
           int span, int nsplit, cudaStream_t stream) {
  CUtensorMap tm_w, tm_h;
  if (!hopper::map_stripes(&tm_w, w8, 1, K, N, 1, ws::SK, ws::BN, true) ||
      !hopper::map_stripes(&tm_h, h8, 1, K, B, 1, ws::SK, 8 * TT, true))
    return int(cudaErrorInvalidValue);
  const size_t smem = ws::ring_smem(stage_bytes(TT), red_bytes(B));
  cudaError_t err = cudaFuncSetAttribute(
      w8a8_kernel<TT, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + ws::BN - 1) / ws::BN, nsplit);
  w8a8_kernel<TT, TO><<<grid, ws::NT, smem, stream>>>(
      tm_w, tm_h, static_cast<const float*>(s_a),
      static_cast<const float*>(s_w), static_cast<TO*>(out),
      static_cast<int*>(part), static_cast<int*>(tickets), B, K, N, span,
      nsplit);
  return int(cudaGetLastError());
}

template <typename TO>
int launch_b(const void* h8, const void* s_a, const void* w8,
             const void* s_w, void* out, void* part, void* tickets, int B,
             int K, int N, int span, int nsplit, cudaStream_t st) {
  switch (ws::token_tiles(B)) {
    case 1:
      return launch<1, TO>(h8, s_a, w8, s_w, out, part, tickets, B, K, N,
                           span, nsplit, st);
    case 2:
      return launch<2, TO>(h8, s_a, w8, s_w, out, part, tickets, B, K, N,
                           span, nsplit, st);
    case 4:
      return launch<4, TO>(h8, s_a, w8, s_w, out, part, tickets, B, K, N,
                           span, nsplit, st);
    default:
      return launch<8, TO>(h8, s_a, w8, s_w, out, part, tickets, B, K, N,
                           span, nsplit, st);
  }
}

}  // namespace

// h8 [B, K] int8 with s_a [B] fp32 (per-token scales), w8 [N, K] int8 with
// s_w [N] fp32; out [B, N] bf16 or fp32 (out_f32). The grid: column tiles
// of 128 x nsplit splits of `span` k (a multiple of 128: weight_plan);
// with nsplit > 1, part holds nsplit * B * N int32 and tickets one zero
// int32 per column tile (left zero). h8 and w8 16-byte aligned,
// K % 16 == 0.
extern "C" int aurora_w8a8_matmul(const void* h8, const void* s_a,
                                  const void* w8, const void* s_w, void* out,
                                  void* part, void* tickets, int B, int K,
                                  int N, int span, int nsplit, int out_f32,
                                  void* stream) {
  if (B <= 0 || B > MAX_B || N <= 0 || K <= 0 || K % 16 != 0 || span <= 0 ||
      span % ws::SK != 0 || nsplit <= 0 || nsplit > 65535 ||
      size_t(nsplit - 1) * span >= size_t(K) ||
      (nsplit > 1 && (part == nullptr || tickets == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_b<float>(h8, s_a, w8, s_w, out, part, tickets, B,
                                   K, N, span, nsplit, st)
                 : launch_b<bf16>(h8, s_a, w8, s_w, out, part, tickets, B, K,
                                  N, span, nsplit, st);
}

// quantize_activations in one launch: h [B, K] (bf16, or fp32 with h_f32)
// → h8 [B, K] int8 and s_a [B] fp32, bit for bit (w4_common.cuh
// `quantize_rows`, contiguous layout)
extern "C" int aurora_quantize_rows(const void* h, void* h8, void* s_a, int B,
                                    int K, int h_f32, void* stream) {
  if (B <= 0 || K <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_f32)
    quantize_rows<float, false><<<B, QNT, 0, st>>>(
        static_cast<const float*>(h), static_cast<int8_t*>(h8), nullptr,
        static_cast<float*>(s_a), K);
  else
    quantize_rows<bf16, false><<<B, QNT, 0, st>>>(
        static_cast<const bf16*>(h), static_cast<int8_t*>(h8), nullptr,
        static_cast<float*>(s_a), K);
  return int(cudaGetLastError());
}

// the W8A8 kernel for up to `rows` token rows (1..64), bf16 out, its
// dynamic shared bytes at that many rows and the blocks of it one SM
// holds, for aurora_kernel_attrs and weight_plan
template <int TT>
int w8a8_attrs(int rows, const void** fn, int* smem, int* blocks) {
  *fn = reinterpret_cast<const void*>(w8a8_kernel<TT, bf16>);
  *smem = int(ws::ring_smem(stage_bytes(TT), red_bytes(rows)));
  cudaError_t err = cudaFuncSetAttribute(
      w8a8_kernel<TT, bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      *smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, w8a8_kernel<TT, bf16>, ws::NT, *smem);
  return int(err);
}

extern "C" int aurora_w8a8_kernel(int rows, const void** fn, int* smem,
                                  int* blocks) {
  if (rows <= 0 || rows > MAX_B) return int(cudaErrorInvalidValue);
  switch (ws::token_tiles(rows)) {
    case 1: return w8a8_attrs<1>(rows, fn, smem, blocks);
    case 2: return w8a8_attrs<2>(rows, fn, smem, blocks);
    case 4: return w8a8_attrs<4>(rows, fn, smem, blocks);
    default: return w8a8_attrs<8>(rows, fn, smem, blocks);
  }
}
