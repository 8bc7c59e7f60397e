// Grouped-expert matmul of the MoE layers: rows sorted by expert times
// that expert's weight stack, with bf16 or int8 experts, sm_90a.
//
// Replaces: no Pallas kernel. The reference's MoE (aurora_tpu/ops/moe.py
// `moe_mlp_grouped`) calls `lax.ragged_dot`, which XLA lowers to the TPU's
// grouped-matmul kernel; this is its counterpart. Contract, for xs [M, K]
// bf16 (token copies sorted by expert), w [E, K, N] (bf16, or int8 with an
// fp32 scale [E, N] per expert and output channel) and offsets [E + 1]
// int32 on the device (expert e owns rows [offsets[e], offsets[e + 1])):
//   out[m, n] = sum_k xs[m, k] * W_e[k, n]   for m in expert e's rows,
// products exact in fp32 and summed in fp32, rounded to the output type
// (bf16 for gate and up, fp32 for down, as the reference's
// preferred_element_type and casts give them). Int8 experts dequantize as
// the reference's `_deq` rounds them: W_e[k, n] = bf16(bf16(q) *
// bf16(scale[e, n])), a bf16 product of two bf16 values, before the
// product; the fp32 scale is never applied after the sum. Rows outside
// [offsets[0], offsets[E]) are not written.
//
// What bounds it on the H100: at decode (a few rows an expert) each
// weight byte feeds a few operations, so the kernel is bound by the
// weight stream of the experts the rows touch (1.41 GB of int8 a
// Mixtral layer at most); at extend (thousands of rows an expert) by the
// tensor cores (2 M K N operations).
//
// Design, a first simple kernel: a block owns one 64-row tile of one
// expert and 64 output columns. The grid is (N / 64 column blocks,
// ceil(M / 64) + E row tiles), the most row tiles any split of M rows
// over E experts can need; block y walks the offsets on the device to
// find its expert and tile, and a block past the last tile exits. No
// count crosses to the host, so the kernel can sit in a CUDA graph and a
// layer never waits on the device. K runs in steps of 32 through a ring
// of 4 cp.async stages (the rows of xs past the tile's last row are
// zero-filled); int8 weight tiles are dequantized once per stage into a
// bf16 tile in shared memory (registers in between), then four warps, one
// per 16 rows, run mma.sync m16n8k16 over the 64 columns with fp32
// accumulators, A and B fragments from ldmatrix. A warp whose 16 rows
// all lie past the tile's end skips its products. wgmma, TMA and a
// persistent scheduler are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;       // rows of a tile
constexpr int BN = 64;       // output columns of a block
constexpr int BK = 32;       // reduction step
constexpr int STAGES = 4;
constexpr int NT = 128;      // four warps
constexpr int XP = BK + 8;   // xs tile pitch (bf16): 80 bytes a row
constexpr int WP = BN + 8;   // bf16 weight tile pitch: 144 bytes a row
constexpr int QP = BN + 16;  // int8 weight tile pitch: 80 bytes a row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, zero-filled when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// shared memory of a block, as bytes (16-byte aligned parts): the xs ring;
// the weight ring (bf16 tiles, or int8 raw tiles); for int8 weights the
// one dequantized bf16 tile the products read and the block's scales
template <bool Q>
struct Smem {
  static constexpr int X = BM * XP * 2;             // bytes of an xs stage
  static constexpr int W = BK * (Q ? QP : WP * 2);  // of a weight stage
  __align__(16) uint8_t x[STAGES][X];
  __align__(16) uint8_t w[STAGES][W];
  __align__(16) uint8_t wq[Q ? BK * WP * 2 : 16];
  float scale[Q ? BN : 1];
};

__device__ __forceinline__ void store2(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* out, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
}

template <bool Q, typename TO>
__global__ void __launch_bounds__(NT)
moe_gmm_kernel(const bf16* __restrict__ xs, const void* __restrict__ wv,
               const float* __restrict__ scale,
               const int* __restrict__ offsets, TO* __restrict__ out, int K,
               int N, int E) {
  typedef typename std::conditional<Q, int8_t, bf16>::type TW;
  __shared__ __align__(128) Smem<Q> sm;
  const TW* w = static_cast<const TW*>(wv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // which expert and which of its row tiles: walk the groups in order
  int e = -1, r0 = 0, r1 = 0;
  {
    int t = blockIdx.y, base = 0;
    for (int g = 0; g < E; ++g) {
      const int lo = __ldg(offsets + g), hi = __ldg(offsets + g + 1);
      const int tiles = hi > lo ? (hi - lo + BM - 1) / BM : 0;
      if (t < base + tiles) {
        e = g;
        r0 = lo + (t - base) * BM;
        r1 = min(hi, r0 + BM);
        break;
      }
      base += tiles;
    }
  }
  if (e < 0) return;
  const int n0 = blockIdx.x * BN;
  const int nrows = r1 - r0;
  const TW* we = w + size_t(e) * K * N;
  if constexpr (Q) {
    // the expert's scales of this block's columns, rounded to bf16 as the
    // reference rounds them
    if (tid < BN) {
      const int n = n0 + tid;
      sm.scale[tid] = n < N ? __bfloat162float(__float2bfloat16_rn(
                                  __ldg(scale + size_t(e) * N + n)))
                            : 0.f;
    }
  }

  auto load = [&](int slot, int kt) {
    const int k0 = kt * BK;
    // xs: 64 rows x 32 columns = 256 chunks of 8 bf16
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * NT, r = c >> 2, cc = (c & 3) * 8;
      const bool ok = r < nrows;
      const bf16* src = xs + size_t(ok ? r0 + r : r0) * K + k0 + cc;
      cp16(reinterpret_cast<bf16*>(sm.x[slot]) + r * XP + cc, src, ok);
    }
    if constexpr (Q) {
      // 32 rows x 64 int8 columns = 128 chunks of 16
      const int r = tid >> 2, cc = (tid & 3) * 16;
      const bool ok = n0 + cc < N;
      const TW* src = we + size_t(k0 + r) * N + (ok ? n0 + cc : 0);
      cp16(sm.w[slot] + r * QP + cc, src, ok);
    } else {
      // 32 rows x 64 bf16 columns = 256 chunks of 8
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * NT, r = c >> 3, cc = (c & 7) * 8;
        const bool ok = n0 + cc < N;
        const TW* src = we + size_t(k0 + r) * N + (ok ? n0 + cc : 0);
        cp16(reinterpret_cast<bf16*>(sm.w[slot]) + r * WP + cc, src, ok);
      }
    }
  };

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_commit();
  }
  const bool active = warp * 16 < nrows;
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nk = kt + STAGES - 1;
      if (nk < KT) load(nk % STAGES, nk);
      cp_commit();
    }
    const int slot = kt % STAGES;
    const bf16* wt;
    if constexpr (Q) {
      // dequantize this stage's int8 tile once: thread t takes 16
      // consecutive columns of one row
      const int r = tid >> 2, cc = (tid & 3) * 16;
      const int4 raw =
          *reinterpret_cast<const int4*>(sm.w[slot] + r * QP + cc);
      const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
      __align__(16) bf16 v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        v[i] = __float2bfloat16_rn(float(q[i]) * sm.scale[cc + i]);
      bf16* wq = reinterpret_cast<bf16*>(sm.wq);
      *reinterpret_cast<int4*>(wq + r * WP + cc) =
          *reinterpret_cast<const int4*>(&v[0]);
      *reinterpret_cast<int4*>(wq + r * WP + cc + 8) =
          *reinterpret_cast<const int4*>(&v[8]);
      __syncthreads();
      wt = wq;
    } else {
      wt = reinterpret_cast<const bf16*>(sm.w[slot]);
    }
    if (active) {
      const bf16* xt = reinterpret_cast<const bf16*>(sm.x[slot]);
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t a[4];
        ldsm_x4(a, &xt[(warp * 16 + (lane & 15)) * XP + ks + (lane >> 4) * 8]);
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          uint32_t b[4];
          const int m = lane >> 3;
          ldsm_x4_t(b, &wt[(ks + (m & 1) * 8 + (lane & 7)) * WP + j * 8 +
                           (m >> 1) * 8]);
          mma16816(acc[j], a, b[0], b[1]);
          mma16816(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();

  if (!active) return;
  const int ra = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + 2 * (lane & 3);
    if (n >= N) continue;
    if (ra < nrows)
      store2(out + size_t(r0 + ra) * N + n, acc[j][0], acc[j][1]);
    if (ra + 8 < nrows)
      store2(out + size_t(r0 + ra + 8) * N + n, acc[j][2], acc[j][3]);
  }
}

template <bool Q, typename TO>
int launch(const void* xs, const void* w, const void* scale,
           const void* offsets, void* out, int M, int K, int N, int E,
           cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM + E);
  moe_gmm_kernel<Q, TO><<<grid, NT, 0, st>>>(
      static_cast<const bf16*>(xs), w, static_cast<const float*>(scale),
      static_cast<const int*>(offsets), static_cast<TO*>(out), K, N, E);
  return int(cudaGetLastError());
}

}  // namespace

// out [M, N] (bf16, or fp32 with out_f32) = the grouped product of xs
// [M, K] bf16 with w [E, K, N] (bf16, or int8 with w_int8 and its fp32
// scale [E, N]) over the groups of offsets [E + 1] int32 (on the device);
// K % 32 == 0, N % 16 == 0, 0 < E, 0 < M, M / 64 + E < 65535
extern "C" int aurora_moe_grouped_mm(const void* xs, const void* w,
                                     const void* scale, const void* offsets,
                                     void* out, int M, int K, int N, int E,
                                     int w_int8, int out_f32, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || E <= 0 || K % BK != 0 || N % 16 != 0 ||
      (M + BM - 1) / BM + E > 65535 || (w_int8 && scale == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_int8)
    return out_f32 ? launch<true, float>(xs, w, scale, offsets, out, M, K, N,
                                         E, st)
                   : launch<true, bf16>(xs, w, scale, offsets, out, M, K, N,
                                        E, st);
  return out_f32 ? launch<false, float>(xs, w, scale, offsets, out, M, K, N,
                                        E, st)
                 : launch<false, bf16>(xs, w, scale, offsets, out, M, K, N, E,
                                       st);
}

// the kernel of one mode ("bf16" or "int8" weights, bf16 out) and its
// dynamic shared bytes (none), for aurora_kernel_attrs
extern "C" int aurora_moe_grouped_mm_kernel(const char* mode,
                                            const void** fn, int* smem) {
  *smem = 0;
  if (mode[0] == 'b')
    *fn = reinterpret_cast<const void*>(moe_gmm_kernel<false, bf16>);
  else if (mode[0] == 'i')
    *fn = reinterpret_cast<const void*>(moe_gmm_kernel<true, bf16>);
  else
    return int(cudaErrorInvalidValue);
  return 0;
}
