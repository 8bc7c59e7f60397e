"""Rotary position embeddings (aurora_tpu/ops/rope.py): the HF-Llama
half-split layout or GLM's interleaved pairs, partial rotary (the first
rd features), and optional linear position scaling (Vicuna-7B-v1.5-16k
uses factor 4.0).

DeepSeek-V2's rotary (`rope_pairs`, the reference's
models/deepseek_v2.py `_rope_interleaved`) rotates consecutive pairs by
explicit per-pair frequencies with cos and sin scaled: the universal
config's `rope_inv_freq` and `rope_attention_scaling`, which YaRN fills
(`yarn_inv_freq`, the port's own copy of transformers' yarn rope init,
which the reference calls at conversion: the card's host has no
transformers)."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch


def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    # computed in float64 on the host then rounded once, as the reference
    freqs = [theta ** (-(2.0 * i) / head_dim) for i in range(head_dim // 2)]
    return torch.tensor(freqs, dtype=torch.float32, device=device)


def rope_cos_sin(position_ids: torch.Tensor, head_dim: int,
                 theta: float = 10000.0,
                 linear_scaling: Optional[float] = None,
                 dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """position_ids [..., T] int → cos, sin [..., T, head_dim]."""
    inv_freq = _inv_freq(head_dim, float(theta), position_ids.device)
    pos = position_ids.to(torch.float32)
    if linear_scaling is not None:
        pos = pos / linear_scaling
    freqs = pos[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rotate_interleaved(x: torch.Tensor) -> torch.Tensor:
    """GLM's pairwise rotation: (x0, x1, x2, x3, ...) → (-x1, x0, -x3, x2,
    ...)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, interleaved: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k [B, T, H, D]; cos/sin [B, T, rd] or [T, rd]. rd < D rotates the
    first rd features only (partial rotary); interleaved uses GLM's
    adjacent-pair lanes with the first half of the table repeated
    pairwise. The rotation runs in cos's dtype (fp32) and is cast back to
    each input's dtype."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    rot = rotate_half
    if interleaved:
        half = cos.shape[-1] // 2
        cos = cos[..., :half].repeat_interleave(2, dim=-1)
        sin = sin[..., :half].repeat_interleave(2, dim=-1)
        rot = rotate_interleaved
    rd = cos.shape[-1]

    def one(x):
        if rd == x.shape[-1]:
            return (x * cos + rot(x) * sin).to(x.dtype)
        xr, xp = x[..., :rd], x[..., rd:]
        return torch.cat([xr * cos + rot(xr) * sin, xp.to(cos.dtype)],
                         dim=-1).to(x.dtype)

    return one(q), one(k)


def yarn_inv_freq(rope_scaling: Dict[str, Any], dim: int, base: float,
                  max_position_embeddings: int) -> Tuple[tuple, float]:
    """YaRN's (inverse frequencies of the dim/2 pairs, attention scaling)
    from a HF config's rope_scaling, as transformers'
    `_compute_yarn_parameters` gives them (the same float32 CPU tensor
    operations, so the same numbers): factor, attention_factor or the
    mscale / mscale_all_dim ratio, beta_fast / beta_slow, the original
    context and truncate."""
    rs = rope_scaling
    factor = rs["factor"]
    attention_factor = rs.get("attention_factor")
    mscale, mscale_all = rs.get("mscale"), rs.get("mscale_all_dim")
    original = rs.get("original_max_position_embeddings") \
        or max_position_embeddings

    def get_mscale(scale, m=1):
        return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

    if attention_factor is None:
        if mscale and mscale_all:
            attention_factor = float(get_mscale(factor, mscale)
                                     / get_mscale(factor, mscale_all))
        else:
            attention_factor = get_mscale(factor)
    beta_fast = rs.get("beta_fast") or 32
    beta_slow = rs.get("beta_slow") or 1

    def correction_dim(rot):
        return (dim * math.log(original / (rot * 2 * math.pi))) \
            / (2 * math.log(base))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if rs.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = base ** (torch.arange(0, dim, 2).to(dtype=torch.float)
                         / dim)
    extrapolation = 1.0 / pos_freqs
    interpolation = 1.0 / (factor * pos_freqs)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    extra_factor = 1 - ramp
    inv = (interpolation * (1 - extra_factor)
           + extrapolation * extra_factor)
    return tuple(float(x) for x in inv), float(attention_factor)


def rope_pairs(x: torch.Tensor, positions: torch.Tensor, theta: float,
               inv_freq: Optional[tuple] = None,
               attention_scaling: float = 1.0) -> torch.Tensor:
    """DeepSeek-V2's complex-pair rotary: x [B, T, Hx, d], positions
    [B, T]; pair (x[2i], x[2i+1]) turns by position · inv_freq[i] (default
    theta^(-2i/d)), cos and sin times attention_scaling, in fp32, cast back
    to x's dtype."""
    d = x.shape[-1]
    if inv_freq is not None:
        inv = torch.tensor(inv_freq, dtype=torch.float32, device=x.device)
    else:
        inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                      device=x.device) / d)
    ang = positions[..., None].float() * inv
    cos = (torch.cos(ang) * attention_scaling)[:, :, None, :]
    sin = (torch.sin(ang) * attention_scaling)[:, :, None, :]
    xr, xi = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
