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
// Design: in this layout consecutive bytes are consecutive output
// columns, not consecutive K, so w4a8_matmul.cu's __dp4a over four packed
// K-bytes does not apply directly. A thread owns 4 columns (one 32-bit
// word per packed row) and walks whole scale groups; W4A8 transposes 4
// rows x 4 columns of bytes with __byte_perm to get four K-consecutive
// bytes per column and runs __dp4a on them (w4_common.cuh `a8_group`),
// W4A16 dequantizes each nibble to its bf16 weight in registers and runs
// fp32 fmas (`a16_rows`, shared with the fused MLP's down half). A block
// is 8 column threads (32 columns, one 32-byte sector per packed row) by
// 32 K-slices, slice s taking groups s, s + 32, ...; the slices' partials
// are summed through shared memory in slice order. No split across
// blocks and no atomics, so every run repeats bit for bit. Token rows run
// 4 at a time, more as further row tiles of the grid (each re-reads the
// weights). Tensor-core tiles (int8 mma for W4A8, bf16 mma for W4A16) and
// deeper load pipelining are later speed work.

#include "w4_common.cuh"

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

template <typename TI, typename TO>
__global__ void __launch_bounds__(NT)
w4a16_kernel(const TI* __restrict__ h, const int8_t* __restrict__ packed,
             const float* __restrict__ scale, TO* __restrict__ out, int B,
             int K, int N, int G) {
  __shared__ float red[KS][FR][BN];
  const int cx = threadIdx.x % CT, ks = threadIdx.x / CT;
  const int n = blockIdx.x * BN + cx * 4;
  const int r0 = blockIdx.y * FR, nr = min(FR, B - r0);
  const int gh = K / 2 / G;
  const TI* hr = h + size_t(r0) * K;
  float acc[FR][4] = {};
  if (n < N) {
    for (int g = ks; g < G; g += KS) {
      const float4 sw =
          __ldg(reinterpret_cast<const float4*>(scale + size_t(g) * N + n));
      const float sbf[4] = {bf16_round(sw.x), bf16_round(sw.y),
                            bf16_round(sw.z), bf16_round(sw.w)};
      const TI* hg = hr + size_t(g) * 2 * gh;
      a16_rows(acc, packed + size_t(g) * gh * N + n, N, gh, sbf, nr,
               [&](int r, int k) {
                 return bf16_round(to_f(hg[size_t(r) * K + k]));
               });
    }
  }
  reduce_store(red, acc, ks, cx, out, r0, nr, N, [](int) { return 1.f; });
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

template <typename TI, typename TO>
int launch_w4a16(const void* h, const void* packed, const void* scale,
                 void* out, int B, int K, int N, int G, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (B + FR - 1) / FR);
  w4a16_kernel<TI, TO><<<grid, NT, 0, stream>>>(
      static_cast<const TI*>(h), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<TO*>(out), B, K, N, G);
  return int(cudaGetLastError());
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
// as it is read.
extern "C" int aurora_w4a16_matmul(const void* h, const void* packed,
                                   const void* scale, void* out, int B, int K,
                                   int N, int G, int h_f32, int out_f32,
                                   void* stream) {
  if (!flat_shapes_ok(B, K, N, G)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_f32) {
    return out_f32 ? launch_w4a16<float, float>(h, packed, scale, out, B, K,
                                                N, G, st)
                   : launch_w4a16<float, bf16>(h, packed, scale, out, B, K, N,
                                               G, st);
  }
  return out_f32 ? launch_w4a16<bf16, float>(h, packed, scale, out, B, K, N,
                                             G, st)
                 : launch_w4a16<bf16, bf16>(h, packed, scale, out, B, K, N, G,
                                            st);
}
