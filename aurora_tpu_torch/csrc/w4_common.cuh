// Device code shared by the W4 and W8 kernels (w4a8_matmul.cu,
// w4_flat_matmul.cu, fused_mlp_w4.cu, w8a8_matmul.cu): the per-token int8
// activation quantizer, element conversions, and the flat W4A8 kernel's
// inner routine over the reference's flat W4 layout (packed [K/2, N] int8,
// K-major: byte (p, n) holds input rows 2p in its low and 2p + 1 in its
// high nibble for output column n; scales [G, N] fp32 for G groups of K/G
// input rows).
//
// That routine is run by one thread for 4 consecutive output columns (one
// 32-bit word of every packed row) and up to FR token rows; the caller
// picks the packed rows it walks and sums the threads' partial results in
// a fixed order, so no kernel uses atomics and every run repeats bit for
// bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int QNT = 1024;           // quantize_rows threads
constexpr int QPER = 12;            // row values a thread keeps in registers
constexpr int FR = 4;               // token rows per pass of the flat routines
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

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

// W4A8 over one group of the flat layout: packed rows [p0, p0 + gh) (gh a
// multiple of 4), this thread's 4 columns at `w` (the group's first row,
// row stride `ld` bytes), token rows r < nr of the int8 planes he/ho (row
// stride K2, the group's first packed row at p0). Four packed rows x four
// columns are transposed with __byte_perm so that each column's word holds
// four consecutive rows; (x << 4) & 0xF0F0F0F0 and x & 0xF0F0F0F0 are then
// 16 * the low and high nibbles as signed bytes, and __dp4a takes them
// against four even and four odd activations. Returns 16 * the exact int32
// group partials in part[r][c].
__device__ __forceinline__ void a8_group(int (&part)[FR][4], const int8_t* w,
                                         int ld, const int8_t* he,
                                         const int8_t* ho, int K2, int p0,
                                         int gh, int nr) {
#pragma unroll
  for (int r = 0; r < FR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[r][c] = 0;
#pragma unroll 2
  for (int p = 0; p < gh; p += 4) {
    const int8_t* wp = w + size_t(p) * ld;
    const unsigned w0 = ld32(wp), w1 = ld32(wp + ld), w2 = ld32(wp + 2 * ld),
                   w3 = ld32(wp + 3 * ld);
    const unsigned t01l = __byte_perm(w0, w1, 0x5140);
    const unsigned t01h = __byte_perm(w0, w1, 0x7362);
    const unsigned t23l = __byte_perm(w2, w3, 0x5140);
    const unsigned t23h = __byte_perm(w2, w3, 0x7362);
    const unsigned x[4] = {__byte_perm(t01l, t23l, 0x5410),
                           __byte_perm(t01l, t23l, 0x7632),
                           __byte_perm(t01h, t23h, 0x5410),
                           __byte_perm(t01h, t23h, 0x7632)};
#pragma unroll
    for (int r = 0; r < FR; ++r) {
      if (r < nr) {
        const size_t off = size_t(r) * K2 + p0 + p;
        const int e = int(ld32(he + off));
        const int o = int(ld32(ho + off));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          part[r][c] = __dp4a(int((x[c] << 4) & 0xF0F0F0F0u), e, part[r][c]);
          part[r][c] = __dp4a(int(x[c] & 0xF0F0F0F0u), o, part[r][c]);
        }
      }
    }
  }
}

}  // namespace
