"""Rotary position embeddings (aurora_tpu/ops/rope.py): the HF-Llama
half-split layout or GLM's interleaved pairs, partial rotary (the first
rd features), and optional linear position scaling (Vicuna-7B-v1.5-16k
uses factor 4.0)."""

from __future__ import annotations

from typing import Optional, Tuple

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
