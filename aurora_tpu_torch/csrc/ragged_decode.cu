// Fused decode step over row-contiguous KV buffers, sm_90a: bf16 KV, int8
// KV with per-token fp32 scales, or nibble-packed int4 KV with the same
// scales.
//
// Replaces: aurora_tpu/ops/pallas/ragged_attention.py
// `ragged_decode_attention` (Pallas kernel `_decode_kernel`, its bf16,
// int8 `quant` and packed int4 `kv_pack` modes). Contract: write each
// lane's new K/V token at
// position kv_lens[b] - 1 of its row (in place; no write when
// kv_lens[b] == 0), then attend the lane's single query (all G heads of
// the KV head) over positions [0, kv_lens[b]). In int8 mode the new token
// is quantized in the kernel onto the reference's per-token grid,
//   s = max(max_d |x_d|, 1e-8) * (1 / kv_maxq),
//   x8 = clamp(rint(x / s), -kv_maxq, kv_maxq),
// (the multiply by the fp32 reciprocal is what XLA compiles the
// reference's division by the constant kv_maxq to; x / s is an IEEE
// division and rint rounds half to even, so the written row and scale are
// bitwise the plain twin's), and the logits are scaled by the key's scale
// after `scale`, the probabilities by the value's scale before P·V. In
// int4 mode (kv_maxq 7) the rows are [L, B, Hkv, S/2, hd] bytes, token
// seg*256 + j (j < 128) in the low nibble and seg*256 + 128 + j in the
// high nibble of packed row seg*128 + j; the new token's nibbles replace
// those of its plane and its mate token's nibbles stay as they were (the
// reference's `merged_packed`), and its scales go to the token-space
// planes. Options of every mode, the reference's `window=` and
// `logit_cap=`: with window w > 0 the query (at pos = kv_lens[b] - 1)
// sees only the keys in (pos - w, pos], and the new token, at pos, always
// lies inside; with cap c > 0 each logit x becomes c * tanhf(x * inv_c)
// (inv_c = fp32(1 / c), the multiply XLA makes of the reference's
// division by a constant) after the scale and the int8 key scale, before
// the mask. tanhf, not tanh.approx.f32, whose ~2^-11 relative error is
// larger than the twins' bounds.
//
// What bounds it on the H100: each step reads every live K/V byte of the
// batch once and does 2 FLOP per byte per query head, far below the
// ~295 FLOP/byte where bf16 tensor cores become the limit, so it is bound
// by KV bytes from HBM, and, at a few lanes, by having enough bytes in
// flight on every SM. int8 KV halves those bytes (plus 4 scale bytes per
// token and head), int4 KV halves them again.
//
// Design: a split-KV (flash-decoding) grid of (split, KV head, lane)
// blocks of 256 threads. Split sp of a lane owns the keys
// [base0 + sp * split, base0 + (sp + 1) * split), where split is a multiple
// of the 256-token packing segment (so an int4 segment and its mate tokens
// never straddle two blocks) and base0 = 0, or with a window the segment
// that holds the lane's first visible key, max(0, kv_len - w): the host
// picks split and the number of splits from S, the window, the lane and
// head count and the SM count (`decode_plan` in ops/pallas/
// ragged_attention.py mirrors the rule), never from kv_lens, which only
// the device reads. A block walks the live part of its range in chunks
// (128 bf16 keys, 256 int8 or int4 keys: 32 KB of K and 32 KB of V, or
// 16 + 16 KB packed) that arrive by 1-D bulk asynchronous copies
// (cp.async.bulk), K and its scales on one mbarrier and V and its scales
// on another, only the live rows of the chunk: the scores start while V is
// still arriving. Each half-warp takes two keys at a time (int4: one packed
// row, the two tokens of its planes) with 16-byte (bf16) or 8-byte reads
// of the shared rows, reduces the dot products of all G query heads by
// shuffles and keeps its own online softmax (m, l and 8 output dims a
// lane in registers): no block barrier per key tile. The 16 half-warps
// merge once at the end. The block that holds the new token writes it to
// global memory once its chunk has landed, and patches the same row (and
// scale; int4: the merged byte, its mate nibble taken from the landed
// copy) into shared memory, so the copy needs no ordering against the
// write. A block with more than one split per (lane, KV head) writes its
// partial (m, l, acc[G][128], fp32) to a scratch; the last block of the
// (lane, KV head) to finish (an atomic ticket after a __threadfence)
// merges the partials in split order and resets the ticket, so results
// are bitwise repeatable whichever block merges. A lane's single split
// writes its output directly. Only the block that holds the new token
// writes its (lane, head) stripe, so the read-modify-write of its bytes
// needs no atomics. Row ids must be distinct per lane (each lane owns its
// row). The kernel is templated on GM, the query heads per KV head rounded
// up to 1, 2, 4 or 8, which sizes the registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 128;
constexpr int SEG = 256;  // the packing segment; splits are its multiples
constexpr int NT = 256;
constexpr int WARPS = NT / 32;
constexpr int HALVES = NT / 16;
constexpr float LOG2E = 1.4426950408889634f;

// keys a chunk covers, bytes of one shared K (or V) row, rows a chunk
template <typename KV, bool PACK>
struct Mode {
  static constexpr int CH = 128, ROWB = 256, ROWS = 128;  // bf16
};
template <>
struct Mode<int8_t, false> {
  static constexpr int CH = 256, ROWB = 128, ROWS = 256;
};
template <>
struct Mode<int8_t, true> {
  static constexpr int CH = 256, ROWB = 128, ROWS = 128;  // packed rows
};

template <typename KV, bool PACK>
constexpr size_t smem_bytes() {
  return 2 * size_t(Mode<KV, PACK>::ROWS) * Mode<KV, PACK>::ROWB +
         (sizeof(KV) == 1 ? 2 * Mode<KV, PACK>::CH * sizeof(float) : 0);
}

// int8 → float without a conversion instruction: the byte, biased to
// b + 128 (xor 0x80), goes into the low mantissa bits of 2^23 and
// 2^23 + 128 is subtracted; exact for every int8
__device__ __forceinline__ float s8_to_f(unsigned biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + i)) -
         8388736.f;
}
// int4: the nibbles of one plane of a packed word. (w << 4) & 0xF0F0F0F0
// holds 16 * each low nibble as a signed byte, w & 0xF0F0F0F0 16 * each
// high one; the 1/16 is exact.
__device__ __forceinline__ unsigned plane16(unsigned w, bool hi) {
  return (hi ? (w & 0xF0F0F0F0u) : ((w << 4) & 0xF0F0F0F0u)) ^ 0x80808080u;
}
// 8 consecutive values of a shared row as floats
__device__ __forceinline__ void row8(const uint8_t* p, float* f, bf16*) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void row8(const uint8_t* p, float* f, int8_t*) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const unsigned lo = u.x ^ 0x80808080u, hi = u.y ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = s8_to_f(lo, i);
    f[4 + i] = s8_to_f(hi, i);
  }
}
// both planes of 8 consecutive bytes of a packed row
__device__ __forceinline__ void row8_int4(const uint8_t* p, float* lo,
                                          float* hi) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const unsigned a0 = plane16(u.x, false), a1 = plane16(u.y, false);
  const unsigned b0 = plane16(u.x, true), b1 = plane16(u.y, true);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = s8_to_f(a0, i) * 0.0625f;
    lo[4 + i] = s8_to_f(a1, i) * 0.0625f;
    hi[i] = s8_to_f(b0, i) * 0.0625f;
    hi[4 + i] = s8_to_f(b1, i) * 0.0625f;
  }
}
__device__ __forceinline__ void load_q8(const bf16* p, float* f) {
  row8(reinterpret_cast<const uint8_t*>(p), f, static_cast<bf16*>(nullptr));
}

// int8 / int4 mode: one warp quantizes one new hd = 128 vector (4 values
// a lane) and writes it and its scale to global memory (dst, dst_scale)
// and to the chunk's shared copy (sdst, sdst_scale): whole bytes
// (plane < 0), or the low (plane 0) or high (plane 1) nibbles of the
// packed row, the other nibbles taken from the shared copy (the row as the
// bulk copy brought it, before this write)
__device__ __forceinline__ void write_quantized(const bf16* src, int8_t* dst,
                                                float* dst_scale,
                                                uint8_t* sdst,
                                                float* sdst_scale, int lane,
                                                float kv_maxq,
                                                float inv_maxq, int plane) {
  float x[4];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = __bfloat162float(src[lane * 4 + i]);
    m = fmaxf(m, fabsf(x[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = fmaxf(m, 1e-8f) * inv_maxq;
  char4 q;
  q.x = int8_t(fminf(fmaxf(rintf(x[0] / s), -kv_maxq), kv_maxq));
  q.y = int8_t(fminf(fmaxf(rintf(x[1] / s), -kv_maxq), kv_maxq));
  q.z = int8_t(fminf(fmaxf(rintf(x[2] / s), -kv_maxq), kv_maxq));
  q.w = int8_t(fminf(fmaxf(rintf(x[3] / s), -kv_maxq), kv_maxq));
  if (plane >= 0) {
    const char4 old = reinterpret_cast<const char4*>(sdst)[lane];
    const int keep = plane ? 0x0F : 0xF0, sh = plane ? 4 : 0;
    q.x = int8_t((old.x & keep) | ((q.x & 0xF) << sh));
    q.y = int8_t((old.y & keep) | ((q.y & 0xF) << sh));
    q.z = int8_t((old.z & keep) | ((q.z & 0xF) << sh));
    q.w = int8_t((old.w & keep) | ((q.w & 0xF) << sh));
  }
  reinterpret_cast<char4*>(dst)[lane] = q;
  reinterpret_cast<char4*>(sdst)[lane] = q;
  if (lane == 0) {
    *dst_scale = s;
    *sdst_scale = s;
  }
}

// the first packed (or plain) row and the row after the last one that a
// chunk must bring for its live tokens [clo, chi) (chunk-relative): in
// int4 mode token j < 128 sits in packed row j, token 128 + j in row j too
__device__ __forceinline__ int2 chunk_rows(int clo, int chi, bool pack) {
  if (!pack) return make_int2(clo, chi);
  if (chi <= 128) return make_int2(clo, chi);
  if (clo >= 128) return make_int2(clo - 128, chi - 128);
  return make_int2(0, 128);
}

template <typename KV, bool PACK, int GM>
__global__ void __launch_bounds__(NT, GM <= 4 ? 2 : 1)
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
              const bf16* __restrict__ v_new, KV* k_rows, KV* v_rows,
              float* k_scales, float* v_scales, bf16* __restrict__ out,
              float* __restrict__ part, int* __restrict__ tickets,
              const int* __restrict__ kv_lens,
              const int* __restrict__ row_ids,
              const int* __restrict__ layer_ptr, int Hq, int Hkv, int B,
              int S, int split, float scale, int window, float cap,
              float inv_cap, float kv_maxq, float inv_maxq) {
  using M = Mode<KV, PACK>;
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int CH = M::CH, ROWB = M::ROWB;
  constexpr uint32_t TILEB = uint32_t(M::ROWS) * ROWB;
  static_assert(!PACK || CH == SEG, "an int4 chunk is one segment");
  static_assert(WARPS * GM * HD * 4 <= 2 * TILEB, "merge area");
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sK = smem;
  uint8_t* sV = smem + TILEB;
  float* sKs = reinterpret_cast<float*>(smem + 2 * TILEB);
  float* sVs = sKs + CH;
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float sM[WARPS][GM], sL[WARPS][GM];
  __shared__ int s_last;

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int l16 = lane & 15;

  // this split's live keys [lo, hi): the window's first key and kv_len
  // clip the split's range (decode_plan's rule)
  const int kv_len_raw = kv_lens[b];
  const int kv_len = min(kv_len_raw, S);
  const int kstart = window > 0 ? max(0, kv_len_raw - window) : 0;
  const int base0 = window > 0 ? kstart / SEG * SEG : 0;
  const int lo = max(base0 + sp * split, kstart);
  const int hi = min(base0 + (sp + 1) * split, kv_len);
  const int pos = kv_len_raw - 1;  // the new token, written iff pos < S
  const int row = row_ids[b];
  const int layer = *layer_ptr;
  const size_t stripe = (size_t(layer) * B + row) * Hkv + kvh;
  const size_t row_elems = size_t(PACK ? S / 2 : S) * HD;
  KV* Kp = k_rows + stripe * row_elems;
  KV* Vp = v_rows + stripe * row_elems;
  float* Ks = QUANT ? k_scales + stripe * size_t(S) : nullptr;
  float* Vs = QUANT ? v_scales + stripe * size_t(S) : nullptr;

  if (tid == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the live rows of chunk [cb, cb + CH), K and its scales on bar[0], V and
  // its scales on bar[1]; one thread
  auto issue = [&](int cb) {
    const int clo = max(lo, cb) - cb, chi = min(hi, cb + CH) - cb;
    const int2 r = chunk_rows(clo, chi, PACK);
    const size_t grow = PACK ? size_t(cb / SEG) * (SEG / 2) : size_t(cb);
    const uint32_t rb = uint32_t(r.y - r.x) * ROWB;
    // scales in 16-byte units: [clo & ~3, (chi + 3) & ~3), S % 4 == 0
    const int s0 = clo & ~3, s1 = (chi + 3) & ~3;
    const uint32_t sb = QUANT ? uint32_t(s1 - s0) * 4u : 0u;
    hopper::mbar_expect_tx(&bar[0], rb + sb);
    hopper::bulk_copy_1d(sK + size_t(r.x) * ROWB, Kp + (grow + r.x) * HD, rb,
                         &bar[0]);
    if (QUANT) hopper::bulk_copy_1d(sKs + s0, Ks + cb + s0, sb, &bar[0]);
    hopper::mbar_expect_tx(&bar[1], rb + sb);
    hopper::bulk_copy_1d(sV + size_t(r.x) * ROWB, Vp + (grow + r.x) * HD, rb,
                         &bar[1]);
    if (QUANT) hopper::bulk_copy_1d(sVs + s0, Vs + cb + s0, sb, &bar[1]);
  };
  const int c_first = lo / CH, c_last = (hi - 1) / CH;
  if (tid == 0 && lo < hi) issue(c_first * CH);

  // this lane's 8 query dims for every head of the group
  float qf[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      load_q8(q + (size_t(b) * Hq + kvh * G + g) * HD + l16 * 8, qf[g]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[g][i] = 0.f;
    }
  }
  float m[GM], l[GM], acc[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }
  const float c2 = QUANT || cap > 0.f ? scale : scale * LOG2E;

  for (int c = c_first, ph = 0; lo < hi && c <= c_last; ++c, ph ^= 1) {
    const int cb = c * CH;
    const int clo = max(lo, cb) - cb, chi = min(hi, cb + CH) - cb;
    hopper::mbar_wait(&bar[0], ph);
    if (pos >= cb + clo && pos < cb + chi) {  // block-uniform
      // the new token: to global memory and into the landed chunk
      hopper::mbar_wait(&bar[1], ph);
      const int t = pos - cb;
      const size_t src = (size_t(b) * Hkv + kvh) * HD;
      const int srow = PACK ? (t & 127) : t;
      const size_t grow =
          PACK ? size_t(cb / SEG) * (SEG / 2) + srow : size_t(pos);
      if constexpr (QUANT) {
        const int plane = PACK ? int(t >= 128) : -1;
        if (warp == 0)
          write_quantized(k_new + src,
                          reinterpret_cast<int8_t*>(Kp + grow * HD), Ks + pos,
                          sK + srow * ROWB, sKs + t, lane, kv_maxq, inv_maxq,
                          plane);
        else if (warp == 1)
          write_quantized(v_new + src,
                          reinterpret_cast<int8_t*>(Vp + grow * HD), Vs + pos,
                          sV + srow * ROWB, sVs + t, lane, kv_maxq, inv_maxq,
                          plane);
      } else {
        if (warp < 2 && lane < HD / 8) {
          const uint4 x = reinterpret_cast<const uint4*>(
              (warp == 0 ? k_new : v_new) + src)[lane];
          reinterpret_cast<uint4*>((warp == 0 ? Kp : Vp) + grow * HD)[lane] =
              x;
          reinterpret_cast<uint4*>((warp == 0 ? sK : sV) + srow * ROWB)[lane] =
              x;
        }
      }
      __syncthreads();
    }

    // the half-warps take key pairs (int4: packed rows) j, j + 16, ...:
    // keys 2j, 2j + 1 (int4: j and 128 + j) of the chunk; the two halves
    // of a warp run the same iterations (their shuffles are warp-wide)
    const int2 rr = chunk_rows(clo, chi, PACK);
    const int j0 = PACK ? rr.x : clo / 2;
    const int j1 = PACK ? rr.y : (chi + 1) / 2;
    for (int jw = j0 + 2 * warp; jw < j1; jw += HALVES) {
      const int j = jw + (lane >> 4);
      const bool ok = j < j1;
      int kl[2];
      bool live[2];
      float kf[2][8] = {};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        kl[u] = PACK ? j + 128 * u : 2 * j + u;
        live[u] = ok && kl[u] >= clo && kl[u] < chi;
      }
      if (ok) {
        if constexpr (PACK) {
          row8_int4(sK + j * ROWB + l16 * 8, kf[0], kf[1]);
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u)
            row8(sK + kl[u] * ROWB + l16 * 8 * sizeof(KV), kf[u],
                 static_cast<KV*>(nullptr));
        }
      }
      float s[GM][2];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float x = 0.f;
          if (g < G) {
#pragma unroll
            for (int i = 0; i < 8; ++i) x += qf[g][i] * kf[u][i];
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
              x += __shfl_xor_sync(0xffffffffu, x, off);
          }
          x *= c2;
          if (QUANT) x *= live[u] ? sKs[kl[u]] : 0.f;
          if (cap > 0.f) x = cap * tanhf(x * inv_cap);
          if (QUANT || cap > 0.f) x *= LOG2E;
          s[g][u] = live[u] ? x : -INFINITY;
        }
      }

      // P·V: the same keys' V rows (dead keys read as zeros)
      hopper::mbar_wait(&bar[1], ph);
      float vf[2][8] = {};
      if (ok) {
        if constexpr (PACK) {
          row8_int4(sV + j * ROWB + l16 * 8, vf[0], vf[1]);
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u)
            row8(sV + kl[u] * ROWB + l16 * 8 * sizeof(KV), vf[u],
                 static_cast<KV*>(nullptr));
        }
      }
      float vs[2] = {1.f, 1.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (QUANT) vs[u] = live[u] ? sVs[kl[u]] : 0.f;
        if (!live[u]) {
#pragma unroll
          for (int i = 0; i < 8; ++i) vf[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float mn = fmaxf(m[g], fmaxf(s[g][0], s[g][1]));
          const float mr = mn == -INFINITY ? 0.f : mn;
          const float alpha = exp2f(m[g] - mr);
          const float p0 = exp2f(s[g][0] - mr), p1 = exp2f(s[g][1] - mr);
          l[g] = l[g] * alpha + p0 + p1;
          m[g] = mn;
          const float w0 = p0 * vs[0], w1 = p1 * vs[1];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[g][i] = acc[g][i] * alpha + w0 * vf[0][i] + w1 * vf[1][i];
        }
      }
    }
    if (c < c_last) {  // every warp is done with the chunk: bring the next
      hopper::fence_proxy_async();
      __syncthreads();
      if (tid == 0) issue(cb + CH);
    }
  }

  // merge the two half-warps of each warp (lanes l and l ^ 16 hold the
  // same dims), then the warps, in order
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], 16);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], 16);
      const float mn = fmaxf(m[g], mo);
      const float mr = mn == -INFINITY ? 0.f : mn;
      const float a = exp2f(m[g] - mr), o = exp2f(mo - mr);
      l[g] = l[g] * a + lo_ * o;
      m[g] = mn;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float other = __shfl_xor_sync(0xffffffffu, acc[g][i], 16);
        acc[g][i] = acc[g][i] * a + other * o;
      }
    }
  }
  __syncthreads();  // the chunk area becomes the merge area
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][GM][HD]
  if (lane < 16) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          red[(warp * GM + g) * HD + l16 * 8 + i] = acc[g][i];
        if (l16 == 0) {
          sM[warp][g] = m[g];
          sL[warp][g] = l[g];
        }
      }
    }
  }
  __syncthreads();

  const size_t pair = size_t(b) * Hkv + kvh;
  float* part_acc = part;                                   // [.][ns][G][HD]
  float* part_ml = part + size_t(gridDim.y) * gridDim.z * nsplit * G * HD;
  for (int e = tid; e < G * HD; e += NT) {
    const int g = e / HD, d = e % HD;
    float mx = -INFINITY;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sM[w][g]);
    const float mr = mx == -INFINITY ? 0.f : mx;
    float L = 0.f, A = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(sM[w][g] - mr);
      L += sL[w][g] * f;
      A += red[(w * GM + g) * HD + d] * f;
    }
    if (nsplit == 1) {
      out[(size_t(b) * Hq + kvh * G + g) * HD + d] =
          __float2bfloat16(A / fmaxf(L, 1e-30f));
    } else {
      const size_t at = (pair * nsplit + sp) * G + g;
      part_acc[at * HD + d] = A;
      if (d == 0) {
        part_ml[2 * at] = mx;
        part_ml[2 * at + 1] = L;
      }
    }
  }
  if (nsplit == 1) return;

  // the last block of this (lane, KV head) merges the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[pair], 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = tid; e < G * HD; e += NT) {
    const int g = e / HD, d = e % HD;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s)
      mx = fmaxf(mx, __ldcg(part_ml + 2 * ((pair * nsplit + s) * G + g)));
    const float mr = mx == -INFINITY ? 0.f : mx;
    float L = 0.f, A = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t at = (pair * nsplit + s) * G + g;
      const float f = exp2f(__ldcg(part_ml + 2 * at) - mr);
      L += __ldcg(part_ml + 2 * at + 1) * f;
      A += __ldcg(part_acc + at * HD + d) * f;
    }
    out[(size_t(b) * Hq + kvh * G + g) * HD + d] =
        __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
  if (tid == 0) tickets[pair] = 0;
}

// S % 4: a quantized row's scale planes are copied in 16-byte units
bool bad_shape(bool quant, int Bq, int Hq, int Hkv, int S, int head_dim,
               int split, int nsplit, float cap, const void* part,
               const void* tickets) {
  return head_dim != HD || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 8 ||
         Bq <= 0 || cap < 0.f || (quant && S % 4 != 0) || split <= 0 ||
         split % SEG != 0 || nsplit <= 0 || nsplit > 65535 ||
         (nsplit > 1 && (part == nullptr || tickets == nullptr));
}

template <typename KV, bool PACK, int GM>
int launch_g(const void* q, const void* k_new, const void* v_new,
             void* k_rows, void* v_rows, void* k_scales, void* v_scales,
             void* out, void* part, void* tickets, const void* kv_lens,
             const void* row_ids, const void* layer, int Bq, int Hq, int Hkv,
             int B, int S, int split, int nsplit, float scale, int window,
             float cap, float inv_cap, float kv_maxq, float inv_maxq,
             void* stream) {
  constexpr size_t SMEM = smem_bytes<KV, PACK>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<KV, PACK, GM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  dim3 grid(nsplit, Hkv, Bq);
  decode_kernel<KV, PACK, GM>
      <<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
          static_cast<const bf16*>(v_new), static_cast<KV*>(k_rows),
          static_cast<KV*>(v_rows), static_cast<float*>(k_scales),
          static_cast<float*>(v_scales), static_cast<bf16*>(out),
          static_cast<float*>(part), static_cast<int*>(tickets),
          static_cast<const int*>(kv_lens), static_cast<const int*>(row_ids),
          static_cast<const int*>(layer), Hq, Hkv, B, S, split, scale,
          window, cap, inv_cap, kv_maxq, inv_maxq);
  return int(cudaGetLastError());
}

template <typename KV, bool PACK>
int launch(const void* q, const void* k_new, const void* v_new, void* k_rows,
           void* v_rows, void* k_scales, void* v_scales, void* out,
           void* part, void* tickets, const void* kv_lens,
           const void* row_ids, const void* layer, int Bq, int Hq, int Hkv,
           int B, int S, int head_dim, int split, int nsplit, float scale,
           int window, float cap, float inv_cap, float kv_maxq,
           float inv_maxq, void* stream) {
  if (bad_shape(sizeof(KV) == 1, Bq, Hq, Hkv, S, head_dim, split, nsplit,
                cap, part, tickets) ||
      (PACK && S % SEG != 0))
    return int(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
#define AURORA_DECODE_G(GM)                                                  \
  return launch_g<KV, PACK, GM>(q, k_new, v_new, k_rows, v_rows, k_scales,   \
                                v_scales, out, part, tickets, kv_lens,       \
                                row_ids, layer, Bq, Hq, Hkv, B, S, split,    \
                                nsplit, scale, window, cap, inv_cap,         \
                                kv_maxq, inv_maxq, stream)
  if (G <= 1) AURORA_DECODE_G(1);
  if (G <= 2) AURORA_DECODE_G(2);
  if (G <= 4) AURORA_DECODE_G(4);
  AURORA_DECODE_G(8);
#undef AURORA_DECODE_G
}

}  // namespace

// bf16 rows [L, B, Hkv, S, hd]; part: fp32 scratch of Bq * Hkv * nsplit *
// G * (hd + 2) floats and tickets: Bq * Hkv int32 zeros (both may be null
// with nsplit 1); split, nsplit: decode_plan's
extern "C" int aurora_ragged_decode_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_rows,
    void* v_rows, void* out, void* part, void* tickets, const void* kv_lens,
    const void* row_ids, const void* layer, int Bq, int Hq, int Hkv, int B,
    int S, int head_dim, int split, int nsplit, float scale, int window,
    float cap, float inv_cap, void* stream) {
  return launch<bf16, false>(q, k_new, v_new, k_rows, v_rows, nullptr,
                             nullptr, out, part, tickets, kv_lens, row_ids,
                             layer, Bq, Hq, Hkv, B, S, head_dim, split,
                             nsplit, scale, window, cap, inv_cap, 0.f, 0.f,
                             stream);
}

// int8 rows [L, B, Hkv, S, hd] with fp32 scale planes [L, B, Hkv, S]
// (S % 4 == 0: the planes are copied in 16-byte units); q, k_new, v_new
// and out stay bf16. inv_maxq is fp32(1) / fp32(kv_maxq).
extern "C" int aurora_ragged_decode_int8(
    const void* q, const void* k_new, const void* v_new, void* k_rows,
    void* v_rows, void* k_scales, void* v_scales, void* out, void* part,
    void* tickets, const void* kv_lens, const void* row_ids,
    const void* layer, int Bq, int Hq, int Hkv, int B, int S, int head_dim,
    int split, int nsplit, float scale, int window, float cap, float inv_cap,
    float kv_maxq, float inv_maxq, void* stream) {
  return launch<int8_t, false>(q, k_new, v_new, k_rows, v_rows, k_scales,
                               v_scales, out, part, tickets, kv_lens,
                               row_ids, layer, Bq, Hq, Hkv, B, S, head_dim,
                               split, nsplit, scale, window, cap, inv_cap,
                               kv_maxq, inv_maxq, stream);
}

// packed int4 rows [L, B, Hkv, S/2, hd] with fp32 scale planes
// [L, B, Hkv, S] (S, the token count, a multiple of 256); kv_maxq <= 7
extern "C" int aurora_ragged_decode_int4(
    const void* q, const void* k_new, const void* v_new, void* k_rows,
    void* v_rows, void* k_scales, void* v_scales, void* out, void* part,
    void* tickets, const void* kv_lens, const void* row_ids,
    const void* layer, int Bq, int Hq, int Hkv, int B, int S, int head_dim,
    int split, int nsplit, float scale, int window, float cap, float inv_cap,
    float kv_maxq, float inv_maxq, void* stream) {
  if (kv_maxq > 7.f) return int(cudaErrorInvalidValue);
  return launch<int8_t, true>(q, k_new, v_new, k_rows, v_rows, k_scales,
                              v_scales, out, part, tickets, kv_lens, row_ids,
                              layer, Bq, Hq, Hkv, B, S, head_dim, split,
                              nsplit, scale, window, cap, inv_cap, kv_maxq,
                              inv_maxq, stream);
}

// the kernel of a mode ("bf16", "int8", "int4") for GM query heads a KV
// head (1, 2, 4, 8) and its dynamic shared bytes, for aurora_kernel_attrs
extern "C" int aurora_ragged_decode_kernel(const char* mode, int gm,
                                           const void** fn, int* smem) {
#define AURORA_DECODE_FN(KV, PACK)                                     \
  do {                                                                 \
    *smem = int(smem_bytes<KV, PACK>());                               \
    if (gm == 1) *fn = reinterpret_cast<const void*>(                  \
        decode_kernel<KV, PACK, 1>);                                   \
    else if (gm == 2) *fn = reinterpret_cast<const void*>(             \
        decode_kernel<KV, PACK, 2>);                                   \
    else if (gm == 4) *fn = reinterpret_cast<const void*>(             \
        decode_kernel<KV, PACK, 4>);                                   \
    else if (gm == 8) *fn = reinterpret_cast<const void*>(             \
        decode_kernel<KV, PACK, 8>);                                   \
    else return int(cudaErrorInvalidValue);                            \
    return 0;                                                          \
  } while (0)
  if (strcmp(mode, "bf16") == 0) AURORA_DECODE_FN(bf16, false);
  if (strcmp(mode, "int8") == 0) AURORA_DECODE_FN(int8_t, false);
  if (strcmp(mode, "int4") == 0) AURORA_DECODE_FN(int8_t, true);
#undef AURORA_DECODE_FN
  return int(cudaErrorInvalidValue);
}
