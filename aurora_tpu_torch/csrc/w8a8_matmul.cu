// W8A8 decode matmul: per-token int8 activations x int8 weights with one
// fp32 scale per output channel, sm_90a.
//
// Replaces: aurora_tpu/ops/pallas/quant_matmul.py `w8a8_matmul` (Pallas
// kernel `_kernel`). Contract, for h8 [B, K] int8 (B <= 64) with scales
// s_a [B] fp32 and a W8 stream w8 [N, K] int8 with scales s_w [N] fp32:
//   acc[b, n] = sum_k h8[b, k] * w8[n, k]                      (int32)
//   out[b, n] = float(acc[b, n]) * s_a[b] * s_w[n]
// in that order, rounded to the output type. |acc| <= 127^2 K, exact in
// int32 for every K the model has, so the result is the plain twin's and
// the reference's bit for bit.
//
// Layout: the nn.Linear one, row n of w8 holding output channel n, so
// every output channel's weights are one contiguous K-byte stripe.
//
// What bounds it on the H100: at decode (B = 4) each weight byte feeds
// 2 * B operations, so the kernel is bound by the int8 weight stream from
// HBM (6.5 GB per 7B decode step), never by arithmetic.
//
// Design: the W4A8 kernel's stripe stream (csrc/w4a8_matmul.cu) without
// the unpack. Each warp owns one output channel: a lane reads 16 weight
// bytes per step with one 16-byte load (a warp reads 512 contiguous
// bytes) and accumulates int32 partials with __dp4a against the 16
// activation bytes at the same offset of each token row (read through the
// L1, shared by the block's eight warps). A warp shuffle sums the lanes'
// int32 partials (exact), and lane 0 scales and writes. A warp covers the
// whole K of its channel: no split-K, no atomics, the same bits on every
// run. Eight channels per block and up to eight token rows per pass; more
// rows run as further row tiles of the grid. int8 mma/wgmma tiles are
// later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;            // 8 warps
constexpr int WARPS = NT / 32;     // output channels per block
constexpr int RB = 8;              // token rows per pass
constexpr int MAX_B = 64;

template <typename TO>
__device__ __forceinline__ void store_out(TO* p, float v);
template <>
__device__ __forceinline__ void store_out<float>(float* p, float v) {
  *p = v;
}
template <>
__device__ __forceinline__ void store_out<bf16>(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ int dot16(const uint4& w, const uint4& a,
                                     int acc) {
  acc = __dp4a(int(w.x), int(a.x), acc);
  acc = __dp4a(int(w.y), int(a.y), acc);
  acc = __dp4a(int(w.z), int(a.z), acc);
  return __dp4a(int(w.w), int(a.w), acc);
}

template <typename TO>
__global__ void __launch_bounds__(NT)
w8a8_kernel(const int8_t* __restrict__ h8, const float* __restrict__ s_a,
            const int8_t* __restrict__ w8, const float* __restrict__ s_w,
            TO* __restrict__ out, int B, int K, int N) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  const int r0 = blockIdx.y * RB;
  if (n >= N) return;
  const int nchunks = K / 16;             // 16-byte chunks of the stripe
  const uint4* wrow = reinterpret_cast<const uint4*>(w8 + size_t(n) * K);
  const int nr = min(RB, B - r0);

  int acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0;
#pragma unroll 2
  for (int c = lane; c < nchunks; c += 32) {
    const uint4 w = __ldg(wrow + c);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < nr) {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(
            h8 + size_t(r0 + r) * K) + c);
        acc[r] = dot16(w, a, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  }
  if (lane == 0) {
    const float sw = __ldg(s_w + n);
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < nr)
        store_out(out + size_t(r0 + r) * N + n,
                  float(acc[r]) * __ldg(s_a + r0 + r) * sw);
  }
}

template <typename TO>
int launch(const void* h8, const void* s_a, const void* w8, const void* s_w,
           void* out, int B, int K, int N, cudaStream_t stream) {
  dim3 grid((N + WARPS - 1) / WARPS, (B + RB - 1) / RB);
  w8a8_kernel<TO><<<grid, NT, 0, stream>>>(
      static_cast<const int8_t*>(h8), static_cast<const float*>(s_a),
      static_cast<const int8_t*>(w8), static_cast<const float*>(s_w),
      static_cast<TO*>(out), B, K, N);
  return int(cudaGetLastError());
}

}  // namespace

// h8 [B, K] int8 with s_a [B] fp32 (per-token scales), w8 [N, K] int8 with
// s_w [N] fp32; out [B, N] bf16 or fp32 (out_f32). h8 and w8 16-byte
// aligned; K % 16 == 0.
extern "C" int aurora_w8a8_matmul(const void* h8, const void* s_a,
                                  const void* w8, const void* s_w, void* out,
                                  int B, int K, int N, int out_f32,
                                  void* stream) {
  if (B <= 0 || B > MAX_B || N <= 0 || K <= 0 || K % 16 != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<float>(h8, s_a, w8, s_w, out, B, K, N, st)
                 : launch<bf16>(h8, s_a, w8, s_w, out, B, K, N, st);
}
