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
// by KV bytes from HBM (and, at batch 4, by having enough loads in flight).
// int8 KV halves those bytes (plus 4 scale bytes per token and head),
// int4 KV halves them again.
//
// Design: one block (256 threads) per (KV head, lane); the block first
// writes the new token of its own (lane, head) stripe (int8: one warp each
// for K and V, a warp max over hd = 128), then, after a block barrier,
// streams the stripe in 256-key tiles: a half-warp reads one key row with
// one 16-byte (bf16) or 8-byte (int8) load per lane and reduces the dot
// products for all G query heads by shuffles; the tile's softmax runs one
// warp per head; the PV pass reads V rows as pairs with four key groups
// per block and an fp32 online softmax carries across tiles. In int4 mode
// a 256-key tile is one packing segment: keys 0-127 read the low nibbles
// of the segment's 128 packed rows and keys 128-255 the high ones (a row's
// bytes are read twice, the second time from the L1). Only this block
// writes its (lane, head) stripe, so the read-modify-write of the new
// token's bytes needs no atomics. Row ids must be distinct per lane (each
// lane owns its row). With a window the tile loop starts at the tile that
// holds the first visible key (a 256-key tile is one packing segment, so
// the int4 plane walk starts at a segment boundary) and masks the keys
// below it per element; the PV pass skips them. A split-KV
// (flash-decoding) grid that fills all SMs is later speed work: with GQA
// 32/8 at 4 lanes the grid is 32 blocks on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 128;
constexpr int TILE = 256;
constexpr int NT = 256;
constexpr int MAXG = 8;
constexpr int KGROUPS = NT / (HD / 2);  // 4 key groups in the PV pass
static_assert(NT == TILE, "one thread per tile key stages the int8 scales");
constexpr float NEG = -1e30f;

// 8 consecutive values of a row as floats: one 16-byte load for bf16, one
// 8-byte load for int8
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
// int8 → float without a conversion instruction: the byte, biased to
// b + 128 (xor 0x80), goes into the low mantissa bits of 2^23 and
// 2^23 + 128 is subtracted; exact for every int8
__device__ __forceinline__ float s8_to_f(unsigned biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + i)) -
         8388736.f;
}
__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const unsigned lo = u.x ^ 0x80808080u, hi = u.y ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = s8_to_f(lo, i);
    f[4 + i] = s8_to_f(hi, i);
  }
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const unsigned b =
      unsigned(*reinterpret_cast<const unsigned short*>(p)) ^ 0x8080u;
  return make_float2(s8_to_f(b, 0), s8_to_f(b, 1));
}
// int4: the nibbles of one plane of a packed row. (w << 4) & 0xF0F0F0F0
// holds 16 * each low nibble as a signed byte, w & 0xF0F0F0F0 16 * each
// high one; the 1/16 is exact.
__device__ __forceinline__ unsigned plane16(unsigned w, bool hi) {
  return (hi ? (w & 0xF0F0F0F0u) : ((w << 4) & 0xF0F0F0F0u)) ^ 0x80808080u;
}
__device__ __forceinline__ void load8_int4(const int8_t* p, bool hi,
                                           float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const unsigned lo = plane16(u.x, hi), up = plane16(u.y, hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = s8_to_f(lo, i) * 0.0625f;
    f[4 + i] = s8_to_f(up, i) * 0.0625f;
  }
}
__device__ __forceinline__ float2 load2_int4(const int8_t* p, bool hi) {
  const unsigned b = plane16(
      unsigned(*reinterpret_cast<const unsigned short*>(p)), hi);
  return make_float2(s8_to_f(b, 0) * 0.0625f, s8_to_f(b, 1) * 0.0625f);
}
// packed row of token position s, and whether s is in its high plane
__device__ __forceinline__ int packed_row(int s) {
  return (s >> 8) * 128 + (s & 127);
}
__device__ __forceinline__ bool high_plane(int s) { return (s & 255) >= 128; }

// int8 / int4 mode: one warp quantizes one new hd = 128 vector (4 values
// a lane) and writes it and its scale at the write position: whole bytes
// (plane < 0), or the low (plane 0) or high (plane 1) nibbles of the
// packed row, the other nibbles kept
__device__ __forceinline__ void write_quantized(const bf16* src, int8_t* dst,
                                                float* dst_scale, int lane,
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
    const char4 old = reinterpret_cast<const char4*>(dst)[lane];
    const int keep = plane ? 0x0F : 0xF0, sh = plane ? 4 : 0;
    q.x = int8_t((old.x & keep) | ((q.x & 0xF) << sh));
    q.y = int8_t((old.y & keep) | ((q.y & 0xF) << sh));
    q.z = int8_t((old.z & keep) | ((q.z & 0xF) << sh));
    q.w = int8_t((old.w & keep) | ((q.w & 0xF) << sh));
  }
  reinterpret_cast<char4*>(dst)[lane] = q;
  if (lane == 0) *dst_scale = s;
}

// k_rows/v_rows (and the int8 scale planes) are written and then read by
// the same block: they are deliberately not declared const __restrict__
// (no read-only-cache loads)
template <typename KV, bool PACK>
__global__ void __launch_bounds__(NT)
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
              const bf16* __restrict__ v_new, KV* k_rows, KV* v_rows,
              float* k_scales, float* v_scales, bf16* __restrict__ out,
              const int* __restrict__ kv_lens,
              const int* __restrict__ row_ids,
              const int* __restrict__ layer_ptr, int Hq, int Hkv, int B,
              int S, float scale, int window, float cap, float inv_cap,
              float kv_maxq, float inv_maxq) {
  constexpr bool QUANT = sizeof(KV) == 1;
  static_assert(!PACK || QUANT, "packed rows are int8 bytes");
  static_assert(!PACK || TILE == 256, "an int4 tile is one segment");
  __shared__ float sP[MAXG][TILE];
  __shared__ float sRed[KGROUPS][MAXG][HD];
  __shared__ float sM[MAXG], sL[MAXG], sA[MAXG];
  __shared__ float sKs[TILE], sVs[TILE];  // int8/int4: tile scales

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lane16 = lane & 15;

  const int kv_len_raw = kv_lens[b];
  const int kv_len = min(kv_len_raw, S);
  // the first key the query (at kv_len_raw - 1) sees
  const int kstart = window > 0 ? max(0, kv_len_raw - window) : 0;
  const int row = row_ids[b];
  const int layer = *layer_ptr;
  const size_t stripe = (size_t(layer) * B + row) * Hkv + kvh;
  const size_t row_elems = size_t(PACK ? S / 2 : S) * HD;
  KV* Kp = k_rows + stripe * row_elems;
  KV* Vp = v_rows + stripe * row_elems;
  float* Ks = QUANT ? k_scales + stripe * size_t(S) : nullptr;
  float* Vs = QUANT ? v_scales + stripe * size_t(S) : nullptr;

  // 1. write the new token first (position kv_len - 1)
  if (kv_len_raw > 0 && kv_len_raw <= S) {
    const size_t src = (size_t(b) * Hkv + kvh) * HD;
    const int pos = kv_len_raw - 1;
    const size_t dst = size_t(PACK ? packed_row(pos) : pos) * HD;
    const int plane = PACK ? int(high_plane(pos)) : -1;
    if constexpr (QUANT) {
      if (warp == 0)
        write_quantized(k_new + src, reinterpret_cast<int8_t*>(Kp + dst),
                        Ks + pos, lane, kv_maxq, inv_maxq, plane);
      else if (warp == 1)
        write_quantized(v_new + src, reinterpret_cast<int8_t*>(Vp + dst),
                        Vs + pos, lane, kv_maxq, inv_maxq, plane);
    } else {
      if (tid < HD / 8) {
        reinterpret_cast<uint4*>(Kp + dst)[tid] =
            reinterpret_cast<const uint4*>(k_new + src)[tid];
      } else if (tid < 2 * (HD / 8)) {
        const int c = tid - HD / 8;
        reinterpret_cast<uint4*>(Vp + dst)[c] =
            reinterpret_cast<const uint4*>(v_new + src)[c];
      }
    }
  }
  if (tid < MAXG) {
    sM[tid] = NEG;
    sL[tid] = 0.f;
  }

  // this thread's 8 query dims for every head of the group
  float qf[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      load8(q + (size_t(b) * Hq + kvh * G + g) * HD + lane16 * 8, qf[g]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[g][i] = 0.f;
    }
  }
  float acc[MAXG][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g][0] = acc[g][1] = 0.f;
  const int dp = tid & (HD / 2 - 1);  // dims 2dp, 2dp+1 in the PV pass
  const int kg = tid / (HD / 2);
  __syncthreads();  // the written token is visible to the whole block

  for (int base = kstart / TILE * TILE; base < kv_len; base += TILE) {
    if constexpr (QUANT) {  // one coalesced read of the tile's scales
      const bool live = base + tid < kv_len;
      sKs[tid] = live ? Ks[base + tid] : 0.f;
      sVs[tid] = live ? Vs[base + tid] : 0.f;
      __syncthreads();
    }
    // scores: warp w covers tile keys [32w, 32w + 32), two per iteration
#pragma unroll 4
    for (int it = 0; it < 16; ++it) {
      const int kl = warp * 32 + it * 2 + (lane >> 4);
      const int s = base + kl;
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
      const bool live = s >= kstart && s < kv_len;
      if (live) {
        float kf[8];
        if constexpr (PACK)
          load8_int4(Kp + size_t(packed_row(s)) * HD + lane16 * 8,
                     high_plane(s), kf);
        else
          load8(Kp + size_t(s) * HD + lane16 * 8, kf);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
#pragma unroll
            for (int i = 0; i < 8; ++i) part[g] += qf[g][i] * kf[i];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
        }
      }
      if (lane16 == 0) {
        const float ks = QUANT ? sKs[kl] : 1.f;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            float x = part[g] * scale;
            if (QUANT) x *= ks;
            if (cap > 0.f) x = cap * tanhf(x * inv_cap);
            sP[g][kl] = live ? x : NEG;
          }
        }
      }
    }
    __syncthreads();

    // softmax of the tile: one warp per query head; int8 mode folds the
    // value scales into p after the row sum
    if (warp < G) {
      const int g = warp;
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        const int kl = lane * (TILE / 32) + i;
        if (base + kl >= kstart && base + kl < kv_len)
          mx = fmaxf(mx, sP[g][kl]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        const int kl = lane * (TILE / 32) + i;
        const bool live = base + kl >= kstart && base + kl < kv_len;
        const float p = live ? expf(sP[g][kl] - m_new) : 0.f;
        sum += p;
        sP[g][kl] = QUANT ? p * sVs[kl] : p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // PV: this thread accumulates dims (2dp, 2dp+1) over keys kg, kg+4, ...
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        acc[g][0] *= sA[g];
        acc[g][1] *= sA[g];
      }
    }
    const int nk = min(TILE, kv_len - base);
    // keys below the window have p = 0: start at the first group of
    // KGROUPS that holds a live one
    const int k0 = max(0, kstart - base) / KGROUPS * KGROUPS;
    for (int kl = k0 + kg; kl < nk; kl += KGROUPS) {
      const int s = base + kl;
      float2 vf;
      if constexpr (PACK)
        vf = load2_int4(Vp + size_t(packed_row(s)) * HD + 2 * dp,
                        high_plane(s));
      else
        vf = load2(Vp + size_t(s) * HD + 2 * dp);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float p = sP[g][kl];
          acc[g][0] += p * vf.x;
          acc[g][1] += p * vf.y;
        }
      }
    }
    __syncthreads();  // sP is rewritten by the next tile
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      sRed[kg][g][2 * dp] = acc[g][0];
      sRed[kg][g][2 * dp + 1] = acc[g][1];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float o = 0.f;
#pragma unroll
    for (int k = 0; k < KGROUPS; ++k) o += sRed[k][g][d];
    out[(size_t(b) * Hq + kvh * G + g) * HD + d] =
        __float2bfloat16(o / fmaxf(sL[g], 1e-30f));
  }
}

bool bad_shape(int Bq, int Hq, int Hkv, int head_dim, float cap) {
  return head_dim != HD || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG ||
         Bq <= 0 || cap < 0.f;
}

template <bool PACK>
int launch_quant(const void* q, const void* k_new, const void* v_new,
                 void* k_rows, void* v_rows, void* k_scales, void* v_scales,
                 void* out, const void* kv_lens, const void* row_ids,
                 const void* layer, int Bq, int Hq, int Hkv, int B, int S,
                 int head_dim, float scale, int window, float cap,
                 float inv_cap, float kv_maxq, float inv_maxq,
                 void* stream) {
  if (bad_shape(Bq, Hq, Hkv, head_dim, cap) || (PACK && S % TILE != 0))
    return int(cudaErrorInvalidValue);
  dim3 grid(Hkv, Bq);
  decode_kernel<int8_t, PACK>
      <<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
          static_cast<const bf16*>(v_new), static_cast<int8_t*>(k_rows),
          static_cast<int8_t*>(v_rows), static_cast<float*>(k_scales),
          static_cast<float*>(v_scales), static_cast<bf16*>(out),
          static_cast<const int*>(kv_lens), static_cast<const int*>(row_ids),
          static_cast<const int*>(layer), Hq, Hkv, B, S, scale, window, cap,
          inv_cap, kv_maxq, inv_maxq);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int aurora_ragged_decode_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_rows,
    void* v_rows, void* out, const void* kv_lens, const void* row_ids,
    const void* layer, int Bq, int Hq, int Hkv, int B, int S, int head_dim,
    float scale, int window, float cap, float inv_cap, void* stream) {
  if (bad_shape(Bq, Hq, Hkv, head_dim, cap))
    return int(cudaErrorInvalidValue);
  dim3 grid(Hkv, Bq);
  decode_kernel<bf16, false>
      <<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
          static_cast<const bf16*>(v_new), static_cast<bf16*>(k_rows),
          static_cast<bf16*>(v_rows), nullptr, nullptr,
          static_cast<bf16*>(out), static_cast<const int*>(kv_lens),
          static_cast<const int*>(row_ids), static_cast<const int*>(layer),
          Hq, Hkv, B, S, scale, window, cap, inv_cap, 0.f, 0.f);
  return int(cudaGetLastError());
}

// int8 rows [L, B, Hkv, S, hd] with fp32 scale planes [L, B, Hkv, S];
// q, k_new, v_new and out stay bf16. inv_maxq is fp32(1) / fp32(kv_maxq).
extern "C" int aurora_ragged_decode_int8(
    const void* q, const void* k_new, const void* v_new, void* k_rows,
    void* v_rows, void* k_scales, void* v_scales, void* out,
    const void* kv_lens, const void* row_ids, const void* layer, int Bq,
    int Hq, int Hkv, int B, int S, int head_dim, float scale, int window,
    float cap, float inv_cap, float kv_maxq, float inv_maxq, void* stream) {
  return launch_quant<false>(q, k_new, v_new, k_rows, v_rows, k_scales,
                             v_scales, out, kv_lens, row_ids, layer, Bq, Hq,
                             Hkv, B, S, head_dim, scale, window, cap, inv_cap,
                             kv_maxq, inv_maxq, stream);
}

// packed int4 rows [L, B, Hkv, S/2, hd] with fp32 scale planes
// [L, B, Hkv, S] (S, the token count, a multiple of 256); kv_maxq <= 7
extern "C" int aurora_ragged_decode_int4(
    const void* q, const void* k_new, const void* v_new, void* k_rows,
    void* v_rows, void* k_scales, void* v_scales, void* out,
    const void* kv_lens, const void* row_ids, const void* layer, int Bq,
    int Hq, int Hkv, int B, int S, int head_dim, float scale, int window,
    float cap, float inv_cap, float kv_maxq, float inv_maxq, void* stream) {
  if (kv_maxq > 7.f) return int(cudaErrorInvalidValue);
  return launch_quant<true>(q, k_new, v_new, k_rows, v_rows, k_scales,
                            v_scales, out, kv_lens, row_ids, layer, Bq, Hq,
                            Hkv, B, S, head_dim, scale, window, cap, inv_cap,
                            kv_maxq, inv_maxq, stream);
}
