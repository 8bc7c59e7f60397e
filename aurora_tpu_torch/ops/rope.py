"""Rotary position embeddings, HF-Llama half-split layout
(aurora_tpu/ops/rope.py), with optional linear position scaling
(Vicuna-7B-v1.5-16k uses factor 4.0)."""

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


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k [B, T, H, D]; cos/sin [B, T, D] or [T, D]. The rotation runs
    in cos's dtype (fp32) and is cast back to each input's dtype."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]

    def one(x):
        return (x * cos + rotate_half(x) * sin).to(x.dtype)

    return one(q), one(k)
