// Hopper (sm_90a) building blocks shared by the port's kernels: TMA tensor
// maps and loads, 1-D bulk copies, mbarriers, and wgmma with shared-memory
// descriptors for the 128-byte swizzle.
//
// Tiles: a [rows][64] bf16 box of 128-byte rows, as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B (the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8)); every box starts on a 1024-byte boundary. A head of 128
// columns is two such boxes, one after the other. The same box is read by
// wgmma two ways:
//   K-major (the reduction runs along the 64 columns): desc_k(), SBO =
//     1024 bytes between groups of 8 rows; a k16 step adds 32 bytes, the
//     next box the box's size;
//   MN-major (the reduction runs along the rows, the 64 columns are the
//     output's N): desc_mn(box bytes), LBO = the box's size (the next 64
//     columns), SBO = 1024; a k16 step adds 16 rows = 2048 bytes.
// Accumulators of m64nN (fp32, per warpgroup of 128 threads): thread
// (warp w, lane l) holds d[4j + 2h + e] = D[16w + l/4 + 8h][8j + 2(l%4) + e]
// for j < N/8, h, e in {0, 1}; that is also the layout of a register A
// operand of 16 columns (4 x bf16x2), so a bf16 copy of the accumulator
// feeds the next product without leaving registers. A tile that threads
// write themselves (a dequantized K/V tile) takes the same layout through
// swz128(), and fence_proxy_async() before a wgmma reads it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up at run time by the CUDA runtime, so the
// library links without libcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 [B, L, H, D] tensor as the 4-D map (D, H, L, B), boxes of 64
// columns x 1 head x `rows` positions x 1 batch, 128-byte swizzle; rows
// past L and columns past D read as zeros. D % 8 == 0 (16-byte strides).
inline bool map_blhd(CUtensorMap* map, const void* base, int B, int L, int H,
                     int D, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(L),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(H) * D * 2,
                                 cuuint64_t(L) * H * D * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// stripes of `rows` rows of `row_bytes` bytes each ([stripes][rows][row],
// one stripe after the other) as the 3-D map (row, rows, stripes) of
// `elem_bytes`-byte elements (2: bf16, 1: bytes), boxes of `box_cols`
// elements x `box_rows` rows x 1 stripe; rows past `rows` read as zeros
// within each stripe. row_bytes % 16 == 0.
inline bool map_stripes(CUtensorMap* map, const void* base, int elem_bytes,
                        int row_bytes, int rows, long long stripes,
                        int box_cols, int box_rows, bool swizzle128) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(row_bytes / elem_bytes),
                              cuuint64_t(rows), cuuint64_t(stripes)};
  const cuuint64_t strides[2] = {cuuint64_t(row_bytes),
                                 cuuint64_t(row_bytes) * cuuint64_t(rows)};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map,
            elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            3, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` (< 8) of row r in a [rows][64] bf16
// box with the 128-byte swizzle
__device__ __forceinline__ uint32_t swz128(int r, int chunk) {
  return uint32_t(r) * 128u + uint32_t((chunk ^ (r & 7)) * 16);
}

// the first 1024-byte boundary at or after p, in shared memory
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arrive once and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed; a phase that
// never completes (a lost arrival) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1u << 28)) __trap();
  }
}

// programmatic dependent launch: a kernel launched with the
// programmatic stream serialization attribute may start while the kernel
// before it on the stream still runs, once every block of that one has
// called launch_dependents() or exited; wait() blocks this thread until
// that kernel has completed and its writes are visible
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// order this thread's earlier generic-proxy accesses to shared memory
// before later async-proxy ones (a bulk copy or TMA load into it, a wgmma
// reading it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) of global
// memory at src into shared memory at dst; completes on bar
__device__ __forceinline__ void bulk_copy_1d(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one box of `map` at (c0, c1, c2) into dst; completes on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// one box of `map` at (c0, c1, c2, c3) into dst; completes on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products (call after wgmma_wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(const void* tile, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((smem_u32(tile) & 0x3FFFFu) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFFu) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFFu) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ uint64_t desc_k(const void* tile) {
  return make_desc(tile, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mn(const void* tile,
                                            uint32_t box_bytes) {
  return make_desc(tile, box_bytes, 1024);
}

// a descriptor moved by `bytes` (the address field counts 16-byte units)
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// columns [16k, 16k + 16) of an m64nN accumulator as a bf16 register A
// operand
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N], int k,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
}

#define HOPPER_ACC8(d, i)                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_ACC32(d)                                                   \
  HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8), HOPPER_ACC8(d, 16),               \
      HOPPER_ACC8(d, 24)
#define HOPPER_ACC64(d)                                                   \
  HOPPER_ACC32(d), HOPPER_ACC8(d, 32), HOPPER_ACC8(d, 40),                \
      HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56)

#define HOPPER_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31}"
#define HOPPER_D64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64][64] (+)= A[64][16] . B[16][64], both K-major in shared memory;
// accumulate = 0 overwrites D
__device__ __forceinline__ void mma_64x64_ss(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64][128] (+)= A[64][16] . B[16][128], both K-major in shared memory
__device__ __forceinline__ void mma_64x128_ss(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64][128] += A[64][16] (registers) . B[16][128] (MN-major in shared
// memory)
__device__ __forceinline__ void mma_64x128_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace hopper
