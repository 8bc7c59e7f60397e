// Device code shared by the W4 and W8 kernels (w4a8_matmul.cu,
// w4_flat_matmul.cu, fused_mlp_w4.cu, w8a8_matmul.cu): the per-token int8
// activation quantizer and element conversions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int QNT = 1024;           // quantize_rows threads
constexpr int QPER = 12;            // row values a thread keeps in registers
constexpr int MAX_B = 64;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

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

// x rounded to bf16 (to nearest even) and back
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Per-token absmax int8 quantization, one block per token row:
//   s_a[b] = max(max_k |h[b, k]| * (1/127), 1e-12)
//   h8[b, k] = clamp(rint(h[b, k] / s_a[b]), -127, 127)
// written as even and odd planes he/ho [B, K/2] (he[b, j] = h8[b, 2j]),
// or with PLANES false as one contiguous [B, K] array at he (the W8A8
// path; ho unused). A row of up to QPER * QNT values is read once and
// kept in registers; longer rows are read twice.
template <typename T, bool PLANES>
__device__ __forceinline__ void quantize_put(int8_t* he, int8_t* ho, int b,
                                             int K, int k, float x,
                                             float s) {
  const int8_t v = int8_t(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
  if (!PLANES)
    he[size_t(b) * K + k] = v;
  else
    ((k & 1) ? ho : he)[size_t(b) * (K / 2) + k / 2] = v;
}

template <typename T, bool PLANES = true>
__global__ void __launch_bounds__(QNT)
quantize_rows(const T* __restrict__ h, int8_t* __restrict__ he,
              int8_t* __restrict__ ho, float* __restrict__ s_a, int K) {
  __shared__ float red[QNT / 32];
  __shared__ float s_sh;
  // the weight streamer launched behind this kernel (programmatic
  // dependent launch) may start its weight loads now
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int b = blockIdx.x;
  const T* row = h + size_t(b) * K;
  const bool kept = K <= QPER * QNT;
  float v[QPER];
  float m = 0.f;
  if (kept) {
#pragma unroll
    for (int u = 0; u < QPER; ++u) {
      const int k = threadIdx.x + u * QNT;
      v[u] = k < K ? to_f(row[k]) : 0.f;
      m = fmaxf(m, fabsf(v[u]));
    }
  } else {
    for (int k = threadIdx.x; k < K; k += QNT)
      m = fmaxf(m, fabsf(to_f(row[k])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    float mx = red[threadIdx.x];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (threadIdx.x == 0) {
      // the reference divides by the constant 127 as XLA compiles it: a
      // multiply by the fp32 reciprocal
      const float s = fmaxf(mx * (1.0f / 127.0f), 1e-12f);
      s_sh = s;
      s_a[b] = s;
    }
  }
  __syncthreads();
  const float s = s_sh;
  if (kept) {
#pragma unroll
    for (int u = 0; u < QPER; ++u) {
      const int k = threadIdx.x + u * QNT;
      if (k < K) quantize_put<T, PLANES>(he, ho, b, K, k, v[u], s);
    }
  } else {
    for (int k = threadIdx.x; k < K; k += QNT)
      quantize_put<T, PLANES>(he, ho, b, K, k, to_f(row[k]), s);
  }
}

}  // namespace
