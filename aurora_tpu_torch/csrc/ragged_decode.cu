// Fused decode step over row-contiguous KV buffers, bf16, sm_90a.
//
// Replaces: aurora_tpu/ops/pallas/ragged_attention.py
// `ragged_decode_attention` (Pallas kernel `_decode_kernel`). Contract:
// write each lane's new K/V token at position kv_lens[b] - 1 of its row
// (in place; no write when kv_lens[b] == 0), then attend the lane's single
// query (all G heads of the KV head) over positions [0, kv_lens[b]).
//
// What bounds it on the H100: each step reads every live K/V byte of the
// batch once and does 2 FLOP per byte per query head, far below the
// ~295 FLOP/byte where bf16 tensor cores become the limit, so it is bound
// by KV bytes from HBM (and, at batch 4, by having enough loads in flight).
//
// Design: one block (256 threads) per (KV head, lane); the block first
// writes the new token of its own (lane, head) stripe, then, after a
// block barrier, streams the stripe in 256-key tiles: a half-warp reads one
// 256-byte key row with 16-byte loads and reduces the dot products for all
// G query heads by shuffles; the tile's softmax runs one warp per head; the
// PV pass reads V rows as bf16 pairs with four key groups per block and an
// fp32 online softmax carries across tiles. Row ids must be distinct per
// lane (each lane owns its row). A split-KV (flash-decoding) grid that
// fills all SMs is later speed work.

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
constexpr float NEG = -1e30f;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// k_rows/v_rows are written and then read by the same block: they are
// deliberately not declared const __restrict__ (no read-only-cache loads)
__global__ void __launch_bounds__(NT)
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
              const bf16* __restrict__ v_new, bf16* k_rows, bf16* v_rows,
              bf16* __restrict__ out, const int* __restrict__ kv_lens,
              const int* __restrict__ row_ids,
              const int* __restrict__ layer_ptr, int Hq, int Hkv, int B,
              int S, float scale) {
  __shared__ float sP[MAXG][TILE];
  __shared__ float sRed[KGROUPS][MAXG][HD];
  __shared__ float sM[MAXG], sL[MAXG], sA[MAXG];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lane16 = lane & 15;

  const int kv_len_raw = kv_lens[b];
  const int kv_len = min(kv_len_raw, S);
  const int row = row_ids[b];
  const int layer = *layer_ptr;
  const size_t slab =
      ((size_t(layer) * B + row) * Hkv + kvh) * size_t(S) * HD;
  bf16* Kp = k_rows + slab;
  bf16* Vp = v_rows + slab;

  // 1. write the new token first (position kv_len - 1)
  if (kv_len_raw > 0 && kv_len_raw <= S) {
    const size_t src = (size_t(b) * Hkv + kvh) * HD;
    const size_t dst = size_t(kv_len_raw - 1) * HD;
    if (tid < HD / 8) {
      reinterpret_cast<uint4*>(Kp + dst)[tid] =
          reinterpret_cast<const uint4*>(k_new + src)[tid];
    } else if (tid < 2 * (HD / 8)) {
      const int c = tid - HD / 8;
      reinterpret_cast<uint4*>(Vp + dst)[c] =
          reinterpret_cast<const uint4*>(v_new + src)[c];
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
      const uint4 u = *reinterpret_cast<const uint4*>(
          q + (size_t(b) * Hq + kvh * G + g) * HD + lane16 * 8);
      unpack8(u, qf[g]);
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

  for (int base = 0; base < kv_len; base += TILE) {
    // scores: warp w covers tile keys [32w, 32w + 32), two per iteration
#pragma unroll 4
    for (int it = 0; it < 16; ++it) {
      const int kl = warp * 32 + it * 2 + (lane >> 4);
      const int s = base + kl;
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
      if (s < kv_len) {
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(Kp + size_t(s) * HD +
                                                 lane16 * 8),
                kf);
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
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) sP[g][kl] = s < kv_len ? part[g] * scale : NEG;
      }
    }
    __syncthreads();

    // softmax of the tile: one warp per query head
    if (warp < G) {
      const int g = warp;
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        const int kl = lane * (TILE / 32) + i;
        if (base + kl < kv_len) mx = fmaxf(mx, sP[g][kl]);
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
        const float p =
            base + kl < kv_len ? expf(sP[g][kl] - m_new) : 0.f;
        sP[g][kl] = p;
        sum += p;
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
    for (int kl = kg; kl < nk; kl += KGROUPS) {
      const float2 vf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(
              Vp + size_t(base + kl) * HD + 2 * dp));
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

}  // namespace

extern "C" int aurora_ragged_decode_bf16(
    const void* q, const void* k_new, const void* v_new, void* k_rows,
    void* v_rows, void* out, const void* kv_lens, const void* row_ids,
    const void* layer, int Bq, int Hq, int Hkv, int B, int S, int head_dim,
    float scale, void* stream) {
  if (head_dim != HD || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG ||
      Bq <= 0)
    return int(cudaErrorInvalidValue);
  dim3 grid(Hkv, Bq);
  decode_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<bf16*>(k_rows),
      static_cast<bf16*>(v_rows), static_cast<bf16*>(out),
      static_cast<const int*>(kv_lens), static_cast<const int*>(row_ids),
      static_cast<const int*>(layer), Hq, Hkv, B, S, scale);
  return int(cudaGetLastError());
}
