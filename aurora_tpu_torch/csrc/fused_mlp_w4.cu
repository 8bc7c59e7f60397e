// The fused W4 MLP of one decode step: silu(h @ Wg) * (h @ Wu) @ Wd,
// sm_90a.
//
// Replaces: aurora_tpu/ops/pallas/quant_matmul.py `fused_mlp_w4` (Pallas
// kernel `_kernel_mlp_w4`). Contract, for h [B, D] (B <= 64), intermediate
// width I:
//   gate/up[b, i] = the W4A8 recipe of w4a8_matmul.cu (per-token int8
//                   activations, exact int32 group partials, group scales
//                   and s_a in fp32), kept in fp32
//   act[b, i]     = bf16(gate / (1 + exp(-gate)) * up)          (fp32 math)
//   out[b, d]     = sum_i act[b, i] * bf16(bf16(q[i, d]) * bf16(s[g(i), d]))
//                   in fp32, cast to the output type last
// The reference's kernel runs these numerics in bf16 on the chip; the plain
// twin `fused_mlp_w4_plain(compute_dtype=torch.bfloat16)` is the same
// recipe.
//
// Layout (ops/pallas/quant_matmul.py `w4_mlp_tile_layout`, I-tiles of
// TI = 64): mgu [I/TI, D/2, 2 TI] int8 (tile j: its 64 gate columns, then
// its 64 up columns, flat K-major bytes), mgs [I/TI, G, 2 TI] fp32, and the
// down stream flat: mdw [I/2, D] int8, mds [Gd, D] fp32, the down group a
// multiple of TI so that a tile's rows share one scale row.
//
// What bounds it on the H100: the packed weight stream, 67.6 MB of weights
// plus 4.2 MB of scales per 7B layer (at B = 4 each byte feeds 8
// multiply-adds): 0.021 ms at 3.35 TB/s.
//
// Design. The reference walks its I-tiles in order into one VMEM
// accumulator; here the tiles are parallel blocks (I/TI = 172 at the 7B,
// over 132 SMs), and nothing carries between blocks. Block j
//   1. computes gate/up for its 128 columns over all of D (32 column
//      threads x 8 K-slices, w4_common.cuh `a8_group`; the slices' sums
//      meet in shared memory in slice order),
//   2. applies silu * up and rounds to bf16 into shared memory (the [B, I]
//      intermediate never leaves the SM),
//   3. multiplies it by its 64 rows of the down stream (`a16_rows`, the
//      routine of w4_flat_matmul.cu's W4A16 kernel) and writes its [B, D]
//      fp32 partial to a scratch [I/TI, B, D].
// The partials are then summed by a second small launch, in tile order.
// Why not a last-block-done reduction (a counter and __threadfence): the
// last block would read all 172 partials alone, one SM pulling 11 MB at B
// = 4, while the second launch spreads the same sum over B * D threads; a
// float atomicAdd into the output would make the result change from run
// to run. So every run repeats bit for bit. Three launches in all on the
// caller's stream: quantize_rows, the tile kernel, the reduction.

#include "w4_common.cuh"

namespace {

constexpr int TI = 64;             // intermediate columns per block
constexpr int NT = 256;
constexpr int BN1 = 2 * TI;        // gate + up columns of a tile
constexpr int CT1 = BN1 / 4;       // phase-1 column threads (4 columns each)
constexpr int KS1 = NT / CT1;      // phase-1 K-slices
static_assert(NT == FR * TI, "one thread per (token row, column) of act");
constexpr int RED_NT = 256;
constexpr int RED_UNROLL = 16;

__global__ void __launch_bounds__(NT)
mlp_tile_kernel(const int8_t* __restrict__ mgu, const float* __restrict__ mgs,
                const int8_t* __restrict__ mdw, const float* __restrict__ mds,
                const int8_t* __restrict__ he, const int8_t* __restrict__ ho,
                const float* __restrict__ s_a, float* __restrict__ part, int B,
                int D, int I, int G, int Gd) {
  __shared__ float red[KS1][FR][BN1];
  __shared__ float act[FR][TI];
  const int j = blockIdx.x;
  const int r0 = blockIdx.y * FR, nr = min(FR, B - r0);
  const int D2 = D / 2, gh = D2 / G;

  // 1. gate/up, W4A8
  {
    const int cx = threadIdx.x % CT1, ks = threadIdx.x / CT1;
    const int n = cx * 4;
    const int8_t* tile = mgu + size_t(j) * D2 * BN1;
    const float* ts = mgs + size_t(j) * G * BN1;
    float acc[FR][4] = {};
    for (int g = ks; g < G; g += KS1) {
      int p[FR][4];
      a8_group(p, tile + size_t(g) * gh * BN1 + n, BN1, he + size_t(r0) * D2,
               ho + size_t(r0) * D2, D2, g * gh, gh, nr);
      const float4 sw =
          __ldg(reinterpret_cast<const float4*>(ts + size_t(g) * BN1 + n));
      const float s4[4] = {sw.x, sw.y, sw.z, sw.w};
#pragma unroll
      for (int r = 0; r < FR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += float(p[r][c] >> 4) * s4[c];
    }
#pragma unroll
    for (int r = 0; r < FR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[ks][r][n + c] = acc[r][c];
  }
  __syncthreads();

  // 2. silu(gate) * up in fp32, rounded to bf16
  {
    const int r = threadIdx.x / TI, i = threadIdx.x % TI;
    float a = 0.f;
    if (r < nr) {
      float gate = 0.f, up = 0.f;
      for (int k = 0; k < KS1; ++k) {
        gate += red[k][r][i];
        up += red[k][r][TI + i];
      }
      const float sa = s_a[r0 + r];
      gate *= sa;
      up *= sa;
      a = bf16_round(gate / (1.f + expf(-gate)) * up);
    }
    act[r][i] = a;
  }
  __syncthreads();

  // 3. the tile's down partial, W4A16
  const int g = j * TI / (I / Gd);
  const int8_t* rows = mdw + size_t(j) * (TI / 2) * D;
  for (int n = threadIdx.x * 4; n < D; n += NT * 4) {
    const float4 sw =
        __ldg(reinterpret_cast<const float4*>(mds + size_t(g) * D + n));
    const float sbf[4] = {bf16_round(sw.x), bf16_round(sw.y),
                          bf16_round(sw.z), bf16_round(sw.w)};
    float acc[FR][4] = {};
    a16_rows(acc, rows + n, D, TI / 2, sbf, nr,
             [&](int r, int k) { return act[r][k]; });
#pragma unroll
    for (int r = 0; r < FR; ++r)
      if (r < nr)
        *reinterpret_cast<float4*>(part + (size_t(j) * B + r0 + r) * D + n) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// out[e] = sum over tiles j, in order, of part[j][e], e < B * D
template <typename TO>
__global__ void __launch_bounds__(RED_NT)
mlp_reduce(const float* __restrict__ part, TO* __restrict__ out, int Ib,
           int BD) {
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

template <typename TIn, typename TO>
int launch(const void* h, const void* mgu, const void* mgs, const void* mdw,
           const void* mds, void* he, void* ho, void* s_a, void* part,
           void* out, int B, int D, int I, int G, int Gd,
           cudaStream_t stream) {
  quantize_rows<TIn><<<B, QNT, 0, stream>>>(
      static_cast<const TIn*>(h), static_cast<int8_t*>(he),
      static_cast<int8_t*>(ho), static_cast<float*>(s_a), D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  dim3 grid(I / TI, (B + FR - 1) / FR);
  mlp_tile_kernel<<<grid, NT, 0, stream>>>(
      static_cast<const int8_t*>(mgu), static_cast<const float*>(mgs),
      static_cast<const int8_t*>(mdw), static_cast<const float*>(mds),
      static_cast<const int8_t*>(he), static_cast<const int8_t*>(ho),
      static_cast<const float*>(s_a), static_cast<float*>(part), B, D, I, G,
      Gd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int BD = B * D;
  mlp_reduce<TO><<<(BD + RED_NT - 1) / RED_NT, RED_NT, 0, stream>>>(
      static_cast<const float*>(part), static_cast<TO*>(out), I / TI, BD);
  return int(cudaGetLastError());
}

}  // namespace

// h [B, D] (bf16 or fp32: h_f32); mgu, mgs, mdw, mds as above; he/ho
// [B, D/2] int8, s_a [B] fp32 and part [I/64, B, D] fp32 caller-allocated
// scratch; out [B, D] (bf16 or fp32: out_f32). G gate/up groups of a
// multiple of 8 rows, Gd down groups of a multiple of 64 rows.
extern "C" int aurora_fused_mlp_w4(const void* h, const void* mgu,
                                   const void* mgs, const void* mdw,
                                   const void* mds, void* he, void* ho,
                                   void* s_a, void* part, void* out, int B,
                                   int D, int I, int G, int Gd, int h_f32,
                                   int out_f32, void* stream) {
  if (B <= 0 || B > MAX_B || D <= 0 || D % 8 != 0 || G <= 0 ||
      (D / 2) % G != 0 || ((D / 2) / G) % 4 != 0 || I <= 0 || I % TI != 0 ||
      Gd <= 0 || I % Gd != 0 || (I / Gd) % TI != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_f32) {
    return out_f32 ? launch<float, float>(h, mgu, mgs, mdw, mds, he, ho, s_a,
                                          part, out, B, D, I, G, Gd, st)
                   : launch<float, bf16>(h, mgu, mgs, mdw, mds, he, ho, s_a,
                                         part, out, B, D, I, G, Gd, st);
  }
  return out_f32 ? launch<bf16, float>(h, mgu, mgs, mdw, mds, he, ho, s_a,
                                       part, out, B, D, I, G, Gd, st)
                 : launch<bf16, bf16>(h, mgu, mgs, mdw, mds, he, ho, s_a,
                                      part, out, B, D, I, G, Gd, st);
}
