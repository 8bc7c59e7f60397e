// W4A8 decode matmul: per-token int8 activations x nibble-packed int4
// weights with per-(output channel, K-group) fp32 scales, sm_90a.
//
// Replaces: aurora_tpu/ops/pallas/quant_matmul.py `w4a8_matmul_tiled`
// (Pallas kernel `_kernel_w4a8`). Contract, for h [B, K] (B <= 64) and a
// W4 stream of N output channels in groups of `group` input rows:
//   s_a[b] = max(max_k |h[b, k]| * (1/127), 1e-12)
//   h8[b, k] = clamp(rint(h[b, k] / s_a[b]), -127, 127)
//   part[b, g, n] = sum_{k in group g} h8[b, k] * w4[k, n]       (int32)
//   out[b, n] = (sum_g part[b, g, n] * scale[n, g]) * s_a[b]
// The int32 group partials are exact; only the fp32 order of the group
// sum differs from the plain twin.
//
// Layout (the port's own, converted once at load): packed [N, K/2] int8,
// row n holding output channel n; byte j carries input row 2j in its low
// nibble and row 2j+1 in its high nibble, each a signed 4-bit value.
// scale [N, G] fp32. Every output channel's weights are one contiguous
// K/2-byte stripe.
//
// What bounds it on the H100: at decode (B = 4) each weight byte feeds
// 2 * B multiply-adds, so the kernel is bound by the packed weight stream
// from HBM (3.4 GB per 7B decode step), never by arithmetic.
//
// Design: two launches on the caller's stream. `quantize_rows` (one block
// per token row) computes s_a and writes the int8 activations split into
// even and odd planes he/ho [B, K/2], so that four consecutive bytes of a
// plane line up with four consecutive packed weight bytes. `w4a8_kernel`
// gives each warp one output channel: a lane reads 16 weight bytes per
// step with one 16-byte load (a warp reads 512 contiguous bytes), turns
// each 4-byte word into 16*lo and 16*hi planes with one shift and two
// masks (each byte then holds nibble << 4, a signed int8), and accumulates
// 16*partial with __dp4a against the activation planes. The lanes of one
// group add their partials by shuffles, shift out the factor 16 (exact),
// scale by scale[n, g] and add into an fp32 accumulator; a warp shuffle
// sums the lanes, and lane 0 multiplies by s_a and writes. A warp covers
// the whole K of its channel, so there is no split-K and no atomics: the
// result is the same on every run. Eight channels per block and up to
// eight token rows per pass; more rows run as further row tiles of the
// grid. int8 mma/wgmma tiles and a shared-memory activation stage are
// later speed work.

#include "w4_common.cuh"

namespace {

constexpr int NT = 256;            // 8 warps
constexpr int WARPS = NT / 32;     // output channels per block
constexpr int RB = 8;              // token rows per pass

__device__ __forceinline__ int dot16(const uint4& w, const uint4& a_even,
                                     const uint4& a_odd, int acc) {
  // each weight byte -> (lo << 4) and (hi << 4) as signed bytes
  const unsigned ws[4] = {w.x, w.y, w.z, w.w};
  const int ae[4] = {int(a_even.x), int(a_even.y), int(a_even.z),
                     int(a_even.w)};
  const int ao[4] = {int(a_odd.x), int(a_odd.y), int(a_odd.z),
                     int(a_odd.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lo16 = int((ws[i] << 4) & 0xF0F0F0F0u);
    const int hi16 = int(ws[i] & 0xF0F0F0F0u);
    acc = __dp4a(lo16, ae[i], acc);
    acc = __dp4a(hi16, ao[i], acc);
  }
  return acc;
}

template <typename TO>
__global__ void __launch_bounds__(NT)
w4a8_kernel(const int8_t* __restrict__ packed,
            const float* __restrict__ scale, const int8_t* __restrict__ he,
            const int8_t* __restrict__ ho, const float* __restrict__ s_a,
            TO* __restrict__ out, int B, int K, int N, int G) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  const int r0 = blockIdx.y * RB;
  if (n >= N) return;
  const int K2 = K / 2;
  const int nchunks = K2 / 16;            // 16-byte chunks of the stripe
  const int cpg = nchunks / G;            // chunks per group (power of 2)
  const uint4* wrow = reinterpret_cast<const uint4*>(packed + size_t(n) * K2);
  const float* srow = scale + size_t(n) * G;
  const int nr = min(RB, B - r0);

  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < nchunks; c0 += 32) {
    const int c = c0 + lane;
    int part[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) part[r] = 0;
    if (c < nchunks) {
      const uint4 w = __ldg(wrow + c);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
          const size_t off = size_t(r0 + r) * K2 + size_t(c) * 16;
          const uint4 e = __ldg(reinterpret_cast<const uint4*>(he + off));
          const uint4 o = __ldg(reinterpret_cast<const uint4*>(ho + off));
          part[r] = dot16(w, e, o, 0);
        }
      }
    }
    // the cpg lanes of one group sum their partials (16 * exact int32)
    for (int off = 1; off < cpg; off <<= 1) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
    }
    if (c < nchunks && (lane & (cpg - 1)) == 0) {
      const float sw = __ldg(srow + c / cpg);
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] += float(part[r] >> 4) * sw;
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r)
      if (r < nr)
        store_out(out + size_t(r0 + r) * N + n, acc[r] * s_a[r0 + r]);
  }
}

template <typename TI, typename TO>
int launch(const void* h, const void* packed, const void* scale, void* he,
           void* ho, void* s_a, void* out, int B, int K, int N, int G,
           cudaStream_t stream) {
  quantize_rows<TI><<<B, NT, 0, stream>>>(
      static_cast<const TI*>(h), static_cast<int8_t*>(he),
      static_cast<int8_t*>(ho), static_cast<float*>(s_a), K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + WARPS - 1) / WARPS, (B + RB - 1) / RB);
  w4a8_kernel<TO><<<grid, NT, 0, stream>>>(
      static_cast<const int8_t*>(packed), static_cast<const float*>(scale),
      static_cast<const int8_t*>(he), static_cast<const int8_t*>(ho),
      static_cast<const float*>(s_a), static_cast<TO*>(out), B, K, N, G);
  return int(cudaGetLastError());
}

}  // namespace

// h [B, K] (bf16 or fp32: h_f32), packed [N, K/2] int8, scale [N, G]
// fp32; he/ho [B, K/2] int8 and s_a [B] fp32 are caller-allocated
// scratch; out [B, N] (bf16 or fp32: out_f32). K/2 must split into G
// groups of 16-byte chunks whose count per group is a power of two <= 32.
extern "C" int aurora_w4a8_matmul(const void* h, const void* packed,
                                  const void* scale, void* he, void* ho,
                                  void* s_a, void* out, int B, int K, int N,
                                  int G, int h_f32, int out_f32,
                                  void* stream) {
  if (B <= 0 || B > MAX_B || N <= 0 || G <= 0 || K % 32 != 0 ||
      (K / 32) % G != 0)
    return int(cudaErrorInvalidValue);
  const int cpg = (K / 32) / G;
  if (cpg > 32 || (cpg & (cpg - 1)) != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_f32) {
    return out_f32 ? launch<float, float>(h, packed, scale, he, ho, s_a, out,
                                          B, K, N, G, st)
                   : launch<float, bf16>(h, packed, scale, he, ho, s_a, out,
                                         B, K, N, G, st);
  }
  return out_f32 ? launch<bf16, float>(h, packed, scale, he, ho, s_a, out, B,
                                       K, N, G, st)
                 : launch<bf16, bf16>(h, packed, scale, he, ho, s_a, out, B,
                                      K, N, G, st);
}
