"""Full-sequence attention (aurora_tpu/ops/attention.py `mha_reference`).

The reference computes this in XLA, outside any Pallas kernel; the port
uses PyTorch's scaled_dot_product_attention with an additive float mask.
Layout [batch, seq, heads, head_dim] at the public boundary, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_MASK_VALUE = -2.3819763e38  # the reference's finite mask value


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False,
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q [B, T, H, D]; k, v [B, S, Hkv, D] (Hkv divides H → GQA).
    bias: additive, broadcastable to [B, H, T, S]; mask: boolean, True =
    attend; q_offset: position of q[:, 0] within the kv sequence.
    The additive mask is cast to q's dtype (SDPA's contract)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    H, T, S = q.shape[2], q.shape[1], k.shape[1]
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    combined = mask
    if causal:
        qi = torch.arange(T, device=q.device)[:, None] + q_offset
        ki = torch.arange(S, device=q.device)[None, :]
        c = (qi >= ki)[None, None]
        combined = c if combined is None else combined & c
    attn_mask = None
    if bias is not None:
        attn_mask = bias.to(torch.float32)
    if combined is not None:
        fill = torch.zeros((), dtype=torch.float32, device=q.device)
        blocked = torch.where(combined, fill, _MASK_VALUE)
        attn_mask = blocked if attn_mask is None else attn_mask + blocked
    if attn_mask is not None:
        attn_mask = attn_mask.to(q.dtype)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=attn_mask, scale=scale)
    return out.transpose(1, 2)
