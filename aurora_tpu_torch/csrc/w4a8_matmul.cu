// W4A8 decode matmul: per-token int8 activations x nibble-packed int4
// weights with per-(output channel, K-group) fp32 scales, sm_90a, over
// either W4 layout.
//
// Replaces: aurora_tpu/ops/pallas/quant_matmul.py `w4a8_matmul_tiled`
// and `w4a8_matmul` (the Pallas kernel `_kernel_w4a8` of each).
// Contract, for h [B, K] (B <= 64) and a W4 stream of N output channels
// in groups of `group` input rows:
//   s_a[b] = max(max_k |h[b, k]| * (1/127), 1e-12)
//   h8[b, k] = clamp(rint(h[b, k] / s_a[b]), -127, 127)
//   part[b, g, n] = sum_{k in group g} h8[b, k] * w4[k, n]       (int32)
//   out[b, n] = (sum_g part[b, g, n] * scale[n, g]) * s_a[b]
// The int32 group partials are exact and each is scaled with one fp32
// rounding, as in the plain twins; only the fp32 order of the group sum
// differs from them.
//
// Layouts. Stripes (the port's own, converted once at load): packed
// [N, K/2] int8, row n holding output channel n; byte j carries input
// row 2j in its low nibble and row 2j+1 in its high nibble, each a
// signed 4-bit value; scale [N, G] fp32. Every output channel's weights
// are one contiguous K/2-byte stripe. Flat (the reference's, FLAT):
// packed [K/2, N], K-major (byte (j, n) holds input rows 2j and 2j + 1
// of channel n), scale [G, N].
//
// What bounds it on the H100: at decode each weight byte feeds 4 * B
// int8 operations (B <= 64), so the kernel is bound by the packed weight
// stream from HBM (3.4 GB per 7B decode step), never by arithmetic.
//
// Design: two launches on the caller's stream. `quantize_rows` (one block
// per token row) computes s_a and writes the int8 activations split into
// even and odd planes he/ho [B, K/2], so that byte p of a plane lines up
// with packed byte p; the streamer is launched behind it as a
// programmatic dependent, so its producer has the first ring of weights
// in flight before the planes are ready. `w4a8_kernel` is
// weight_stream.cuh's streamer with the nibble unpack of its `A8Warp`: a
// block owns 128 channels and a K split from `weight_plan` (splits on
// group boundaries); each stage holds one TMA box of the weights (256 k,
// 16 KB: 128 channel rows x 128 packed bytes, or flat 128 packed rows x
// 128 channels), one box of each activation plane (8 * TT token rows x
// 128 bytes) and the scales of the groups the stage touches as
// [group][channel] rows. Stripe scales [N, G] lie strided by channel:
// the producer's lanes copy them by 4-byte cp.async, joined to the
// stage's mbarrier. Flat scales [G, N] lie in rows: one 1-D bulk copy a
// group. Where N % 16 != 0 the flat packed rows do not start on the
// 16-byte boundaries TMA needs: the producer's lanes then copy the weight
// box by 4-byte cp.async into the same swizzled places (as W4A16 does).
// Consumer warp (cw, tw, kw) owns MT m-tiles of channels, TPW token
// tiles and the groups g with g % KW == kw (weight_stream.cuh `A8`); it
// keeps each group's int32 partial in registers until the group ends and
// its fp32 sums across its groups. A flat fragment takes a 4 x 4 byte
// transpose per 4 channels and 4 packed rows on top of the stripe's
// unpack (`A8Warp`'s FLAT policy). The k-slices' sums meet in shared
// memory, are added in k-slice order, then the splits in split order
// (ws::finish), and s_a multiplies last. No float atomics: every run
// gives the same bits.

#include "weight_stream.cuh"

namespace {

constexpr int WBOX = ws::BN * 128;     // bytes of a stage's weight box
constexpr int SKW = 256;               // k a stage (128 packed bytes)

template <int TT>
__host__ __device__ constexpr int act_box() {
  return 8 * TT * 128;
}

// bytes of a stage: the weight box, both activation boxes, scr scale rows
template <int TT>
__host__ __device__ size_t stage_bytes(int scr) {
  const size_t b = size_t(WBOX) + 2 * act_box<TT>() + size_t(scr) * ws::BN * 4;
  return (b + 1023) & ~size_t(1023);
}

template <int TT>
size_t red_bytes(int B) {
  return size_t(ws::A8<TT>::KW) * B * ws::BN * sizeof(float);
}

// scale rows a stage of SKW k touches, groups of `group` k (a power of
// two)
int scale_rows(int group) { return group >= SKW ? 1 : SKW / group; }

template <int TT>
__host__ __device__ constexpr int w4a8_min_blocks() {
  return TT <= 2 ? 2 : 1;
}

template <int TT, int RW, bool FLAT, typename TO>
__global__ void __launch_bounds__(ws::NT, w4a8_min_blocks<TT>())
w4a8_kernel(const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_h,
            const int8_t* __restrict__ packed,
            const float* __restrict__ scale, const float* __restrict__ s_a,
            TO* __restrict__ out, float* __restrict__ part,
            int* __restrict__ tickets, int B, int K, int N, int G, int lg,
            int span, int nsplit, int scr, int tma_w) {
  using Geo = ws::A8<TT>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = hopper::align1024(smem_raw);
  __shared__ ws::Bars bars;
  const int n0 = blockIdx.x * ws::BN;
  const int k0 = blockIdx.y * span, k1 = min(K, k0 + span);
  const int nst = (k1 - k0 + SKW - 1) / SKW;
  const size_t stage = stage_bytes<TT>(scr);
  const int sbase = WBOX + 2 * act_box<TT>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ws::init_bars(bars);

  if (warp == ws::PRODUCER) {
    // the first ring's weights and scales go out before the activations,
    // which the quantizer launched before this kernel is still writing
    // (programmatic dependent launch); then stage by stage
    const int nv = min(ws::BN, N - n0), pre = min(ws::NS, nst);
    for (int i = 0; i < nst; ++i) {
      const int slot = ws::producer_acquire(bars, i);
      const int kc = k0 + i * SKW, len = min(SKW, k1 - kc);
      const int g0 = kc >> lg, ng = ((kc + len - 1) >> lg) - g0 + 1;
      uint8_t* st = smem + size_t(slot) * stage;
      uint64_t* full = &bars.full[slot];
      if constexpr (FLAT) {
        if (!tma_w) {
          for (int e = lane; e < len / 2 * 32; e += 32) {
            const int p = e >> 5, w = e & 31;
            if (4 * w < nv)
              ws::cp_async4(st + hopper::swz128(p, w >> 2) + 4 * (w & 3),
                            packed + size_t(kc / 2 + p) * N + n0 + 4 * w);
          }
          ws::cp_async_mbar_arrive(full);
          __syncwarp();
        }
        if (lane == 0) {
          hopper::mbar_expect_tx(
              full, (tma_w ? WBOX : 0) + 2 * act_box<TT>() + ng * 4 * nv);
          if (tma_w) hopper::tma_load_3d(st, &tm_w, full, n0, kc / 2, 0);
          for (int r = 0; r < ng; ++r)
            hopper::bulk_copy_1d(st + sbase + r * ws::BN * 4,
                                 scale + size_t(g0 + r) * N + n0, 4 * nv,
                                 full);
        }
      } else {
        for (int e = lane; e < ng * ws::BN; e += 32) {
          const int r = e / ws::BN, c = e % ws::BN;
          if (c < nv)
            ws::cp_async4(st + sbase + 4 * e,
                          scale + size_t(n0 + c) * G + g0 + r);
        }
        ws::cp_async_mbar_arrive(full);
        __syncwarp();
        if (lane == 0) {
          hopper::mbar_expect_tx(full, WBOX + 2 * act_box<TT>());
          hopper::tma_load_3d(st, &tm_w, full, kc / 2, n0, 0);
        }
      }
      if (i + 1 < pre) continue;
      if (i + 1 == pre) hopper::grid_wait();
      if (lane == 0)
        for (int a = i + 1 == pre ? 0 : i; a <= i; ++a) {
          const int ka = (k0 + a * SKW) / 2;
          uint8_t* sa = smem + size_t(a % ws::NS) * stage + WBOX;
          uint64_t* fa = &bars.full[a % ws::NS];
          hopper::tma_load_3d(sa, &tm_h, fa, ka, 0, 0);
          hopper::tma_load_3d(sa + act_box<TT>(), &tm_h, fa, ka, 0, 1);
        }
    }
    return;
  }

  const int g = lane >> 2, q = lane & 3;
  const int c0 = Geo::cw(warp) * Geo::MT * 16, kw = Geo::kw(warp);
  ws::A8Warp<TT, RW, ws::BN, FLAT> acc;
  acc.clear(Geo::tw(warp) * Geo::TPW);
  for (int i = 0; i < nst; ++i) {
    const int slot = ws::consumer_wait(bars, i);
    const int kc = k0 + i * SKW;
    const uint8_t* st = smem + size_t(slot) * stage;
    acc.stage(st, st + WBOX, st + WBOX + act_box<TT>(),
              reinterpret_cast<const float*>(st + sbase), kc,
              min(SKW, k1 - kc), lg, kw, c0, g, q);
    ws::consumer_release(bars, slot);
  }

  // the k-slices' sums [KW][B][BN] over the ring, then the ending (s_a
  // from the quantizer, complete once the activations have landed)
  hopper::grid_wait();
  ws::consumers_sync();
  float* red = reinterpret_cast<float*>(smem);
  acc.each(c0, g, q, [&](int tok, int ch, float v) {
    if (tok < B) red[(size_t(kw) * B + tok) * ws::BN + ch] = v;
  });
  ws::finish(bars, red, part, tickets, B, N, n0, blockIdx.y, nsplit,
             [&](int b, int n, float v) {
               store_out(out + size_t(b) * N + n, __fmul_rn(v, s_a[b]));
             },
             Geo::KW);
}

// the launch behind the quantizer: FLAT picks the layout of packed and
// scale
template <int TT, int RW, bool FLAT, typename TO>
int launch(const void* packed, const void* scale, const void* he,
           const void* s_a, void* out, void* part, void* tickets, int B,
           int K, int N, int G, int span, int nsplit, cudaStream_t stream) {
  const int group = K / G, scr = scale_rows(group);
  // flat weights by TMA where the packed rows are 16-byte aligned
  int tma_w = !FLAT || N % 16 == 0;
  CUtensorMap tm_w = {}, tm_h;
  // the weights as boxes of 128 rows of 128 bytes (channels of K/2 bytes,
  // or flat packed rows of N bytes); the planes he/ho [2][B][K/2] as two
  // stripes of B rows
  if ((tma_w && !(FLAT ? hopper::map_stripes(&tm_w, packed, 1, N, K / 2, 1,
                                             ws::BN, 128, true)
                       : hopper::map_stripes(&tm_w, packed, 1, K / 2, N, 1,
                                             128, ws::BN, true))) ||
      !hopper::map_stripes(&tm_h, he, 1, K / 2, B, 2, 128, 8 * TT, true))
    return int(cudaErrorInvalidValue);
  auto kernel = w4a8_kernel<TT, RW, FLAT, TO>;
  const size_t smem = ws::ring_smem(stage_bytes<TT>(scr), red_bytes<TT>(B));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  // launched behind the quantizer with programmatic stream serialization:
  // the weight loads start while it runs
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + ws::BN - 1) / ws::BN, nsplit);
  cfg.blockDim = dim3(ws::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int8_t* pk = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  const float* sa = static_cast<const float*>(s_a);
  TO* o = static_cast<TO*>(out);
  float* pt = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  int lg = __builtin_ctz(group);
  void* args[] = {&tm_w, &tm_h, &pk, &sc, &sa, &o, &pt, &tk, &B, &K, &N,
                  &G, &lg, &span, &nsplit, const_cast<int*>(&scr), &tma_w};
  return int(cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(kernel), args));
}

template <int RW, bool FLAT, typename TO>
int launch_b(const void* packed, const void* scale, const void* he,
             const void* s_a, void* out, void* part, void* tickets, int B,
             int K, int N, int G, int span, int nsplit, cudaStream_t st) {
  switch (ws::token_tiles(B)) {
    case 1:
      return launch<1, RW, FLAT, TO>(packed, scale, he, s_a, out, part,
                                     tickets, B, K, N, G, span, nsplit, st);
    case 2:
      return launch<2, RW, FLAT, TO>(packed, scale, he, s_a, out, part,
                                     tickets, B, K, N, G, span, nsplit, st);
    case 4:
      return launch<4, RW, FLAT, TO>(packed, scale, he, s_a, out, part,
                                     tickets, B, K, N, G, span, nsplit, st);
    default:
      return launch<8, RW, FLAT, TO>(packed, scale, he, s_a, out, part,
                                     tickets, B, K, N, G, span, nsplit, st);
  }
}

template <bool FLAT, typename TO>
int launch_rw(const void* packed, const void* scale, const void* he,
              const void* s_a, void* out, void* part, void* tickets, int B,
              int K, int N, int G, int span, int nsplit, cudaStream_t st) {
  return (K / G) % 128 == 0
             ? launch_b<16, FLAT, TO>(packed, scale, he, s_a, out, part,
                                      tickets, B, K, N, G, span, nsplit, st)
             : launch_b<4, FLAT, TO>(packed, scale, he, s_a, out, part,
                                     tickets, B, K, N, G, span, nsplit, st);
}

// both entry points: check, quantize, then the streamer
template <bool FLAT>
int w4a8_matmul(const void* h, const void* packed, const void* scale,
                void* he, void* ho, void* s_a, void* out, void* part,
                void* tickets, int B, int K, int N, int G, int span,
                int nsplit, int h_f32, int out_f32, void* stream) {
  if (B <= 0 || B > MAX_B || N <= 0 || G <= 0 || K % 32 != 0 ||
      K % G != 0 || (FLAT && N % 4 != 0))
    return int(cudaErrorInvalidValue);
  const int group = K / G;
  if (group < 32 || (group & (group - 1)) != 0 || span <= 0 ||
      span % group != 0 || nsplit <= 0 || nsplit > 65535 ||
      size_t(nsplit - 1) * span >= size_t(K) ||
      static_cast<int8_t*>(ho) !=
          static_cast<int8_t*>(he) + size_t(B) * K / 2 ||
      (nsplit > 1 && (part == nullptr || tickets == nullptr)))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_f32)
    quantize_rows<float><<<B, QNT, 0, st>>>(
        static_cast<const float*>(h), static_cast<int8_t*>(he),
        static_cast<int8_t*>(ho), static_cast<float*>(s_a), K);
  else
    quantize_rows<bf16><<<B, QNT, 0, st>>>(
        static_cast<const bf16*>(h), static_cast<int8_t*>(he),
        static_cast<int8_t*>(ho), static_cast<float*>(s_a), K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return out_f32
             ? launch_rw<FLAT, float>(packed, scale, he, s_a, out, part,
                                      tickets, B, K, N, G, span, nsplit, st)
             : launch_rw<FLAT, bf16>(packed, scale, he, s_a, out, part,
                                     tickets, B, K, N, G, span, nsplit, st);
}

// the W4A8 kernel for up to `rows` token rows (1..64) with groups of
// `group` k, bf16 out, its dynamic shared bytes and the blocks of it one
// SM holds, for aurora_kernel_attrs and weight_plan
template <int TT, int RW, bool FLAT>
int w4a8_attrs(int rows, int group, const void** fn, int* smem,
               int* blocks) {
  auto kernel = w4a8_kernel<TT, RW, FLAT, bf16>;
  *fn = reinterpret_cast<const void*>(kernel);
  *smem = int(ws::ring_smem(stage_bytes<TT>(scale_rows(group)),
                            red_bytes<TT>(rows)));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        ws::NT, *smem);
  return int(err);
}

template <int RW, bool FLAT>
int w4a8_attrs_b(int rows, int group, const void** fn, int* smem,
                 int* blocks) {
  switch (ws::token_tiles(rows)) {
    case 1: return w4a8_attrs<1, RW, FLAT>(rows, group, fn, smem, blocks);
    case 2: return w4a8_attrs<2, RW, FLAT>(rows, group, fn, smem, blocks);
    case 4: return w4a8_attrs<4, RW, FLAT>(rows, group, fn, smem, blocks);
    default: return w4a8_attrs<8, RW, FLAT>(rows, group, fn, smem, blocks);
  }
}

template <bool FLAT>
int w4a8_kernel_attrs(int rows, int group, const void** fn, int* smem,
                      int* blocks) {
  if (rows <= 0 || rows > MAX_B || group < 32 || (group & (group - 1)) != 0)
    return int(cudaErrorInvalidValue);
  return group % 128 == 0
             ? w4a8_attrs_b<16, FLAT>(rows, group, fn, smem, blocks)
             : w4a8_attrs_b<4, FLAT>(rows, group, fn, smem, blocks);
}

}  // namespace

// h [B, K] (bf16 or fp32: h_f32), packed [N, K/2] int8, scale [N, G]
// fp32; he/ho [B, K/2] int8 (ho right after he) and s_a [B] fp32 are
// caller-allocated scratch; out [B, N] (bf16 or fp32: out_f32). Groups of
// K/G = 32 * 2^i input rows. The grid: column tiles of 128 x nsplit
// splits of `span` k (a multiple of the group: weight_plan); with
// nsplit > 1, part holds nsplit * B * N fp32 and tickets one zero int32
// per column tile (left zero). packed and he 16-byte aligned.
extern "C" int aurora_w4a8_matmul(const void* h, const void* packed,
                                  const void* scale, void* he, void* ho,
                                  void* s_a, void* out, void* part,
                                  void* tickets, int B, int K, int N, int G,
                                  int span, int nsplit, int h_f32,
                                  int out_f32, void* stream) {
  return w4a8_matmul<false>(h, packed, scale, he, ho, s_a, out, part,
                            tickets, B, K, N, G, span, nsplit, h_f32,
                            out_f32, stream);
}

// The same over the flat layout: packed [K/2, N] int8 and scale [G, N]
// fp32 (the reference's [G, g/2, N] and [G, 1, N]); N % 4 == 0, scale
// 16-byte aligned.
extern "C" int aurora_w4a8_flat_matmul(const void* h, const void* packed,
                                       const void* scale, void* he, void* ho,
                                       void* s_a, void* out, void* part,
                                       void* tickets, int B, int K, int N,
                                       int G, int span, int nsplit,
                                       int h_f32, int out_f32,
                                       void* stream) {
  return w4a8_matmul<true>(h, packed, scale, he, ho, s_a, out, part,
                           tickets, B, K, N, G, span, nsplit, h_f32, out_f32,
                           stream);
}

extern "C" int aurora_w4a8_kernel(int rows, int group, const void** fn,
                                  int* smem, int* blocks) {
  return w4a8_kernel_attrs<false>(rows, group, fn, smem, blocks);
}

extern "C" int aurora_w4a8_flat_kernel(int rows, int group, const void** fn,
                                       int* smem, int* blocks) {
  return w4a8_kernel_attrs<true>(rows, group, fn, smem, blocks);
}
