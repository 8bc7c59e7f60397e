"""Full-sequence attention (aurora_tpu/ops/attention.py): the plain path
`mha_reference` and the dispatch `mha`.

The reference computes `mha_reference` in XLA, outside any Pallas kernel;
the port uses PyTorch's scaled_dot_product_attention with an additive
float mask, except with a logit softcap, which SDPA cannot express: then
the capped fp32 scores are computed explicitly. `mha` sends a call to the flash kernels
(ops/pallas/flash_attention.py) by the reference's rule, with "CUDA
tensor" in place of "TPU backend". Layout [batch, seq, heads, head_dim]
at the public boundary, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend

from aurora_tpu_torch.ops.pallas.flash_attention import flash_attention

_MASK_VALUE = -2.3819763e38  # the reference's finite mask value

# SDPA's backends that repeat bit for bit on the card. PyTorch 2.11 picks
# cuDNN attention for masked calls on an H100, and its results did not
# repeat: a 7B greedy dense decode gave other tokens on its second run,
# and the ViT (masked by ToMe's size bias) other embeddings in another
# process. The dense KV-cache decode and the ViT keep to these.
REPEATABLE_SDPA = [SDPBackend.FLASH_ATTENTION,
                   SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False,
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  q_segment_ids: Optional[torch.Tensor] = None,
                  kv_segment_ids: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None,
                  q_offset: int = 0,
                  logit_cap: float = 0.0) -> torch.Tensor:
    """q [B, T, H, D]; k, v [B, S, Hkv, D] (Hkv divides H → GQA).
    bias: additive, broadcastable to [B, H, T, S]; mask: boolean, True =
    attend; segment ids [B, T] / [B, S]: attention only within equal ids;
    q_offset: position of q[:, 0] within the kv sequence; logit_cap c > 0:
    the fp32 scores s become c * tanh(s / c) before bias and mask (the
    reference's division by the constant c is, under jit, a multiply by
    fp32(1 / c), and so it is here). The additive mask is cast to q's
    dtype (SDPA's contract). A row that sees no key gets the uniform
    average of v, as the reference's softmax over equal masked logits
    gives."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    H, T, S = q.shape[2], q.shape[1], k.shape[1]
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    combined = None
    if causal:
        qi = torch.arange(T, device=q.device)[:, None] + q_offset
        ki = torch.arange(S, device=q.device)[None, :]
        combined = (qi >= ki)[None, None]
    if q_segment_ids is not None:
        seg = (q_segment_ids[:, None, :, None]
               == kv_segment_ids[:, None, None, :])
        combined = seg if combined is None else combined & seg
    if mask is not None:
        combined = mask if combined is None else combined & mask
    if logit_cap > 0:
        return _capped_attention(q, k, v, scale, logit_cap, bias, combined)
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


def _capped_attention(q, k, v, scale, logit_cap, bias, combined):
    """The reference's XLA path with a softcap: fp32 scores of q * scale
    against k (k, v already repeated to H heads), c * tanh(s / c), then
    bias and the boolean mask, fp32 softmax, probabilities in q's dtype
    times v."""
    inv = float(np.float32(1.0) / np.float32(logit_cap))
    logits = torch.einsum("bthd,bshd->bhts", (q * scale).float(), k.float())
    logits = logit_cap * torch.tanh(logits * inv)
    if bias is not None:
        logits = logits + bias.to(torch.float32)
    if combined is not None:
        logits = torch.where(combined, logits, _MASK_VALUE)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = False,
        bias: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        q_segment_ids: Optional[torch.Tensor] = None,
        kv_segment_ids: Optional[torch.Tensor] = None,
        scale: Optional[float] = None,
        q_offset: int = 0,
        logit_cap: float = 0.0,
        use_flash: Optional[bool] = None) -> torch.Tensor:
    """Dispatching attention entry point.

    use_flash None → flash for CUDA tensors with no bias, no mask, no
    logit cap, T >= 128 and head_dim % 128 == 0; `mha_reference`
    otherwise. True/False force either path. The reference's forced flash
    path drops `bias` and `mask` without a word; here it raises instead,
    as it does (like the reference) for a logit cap.
    """
    if use_flash is None:
        use_flash = (q.is_cuda and bias is None and mask is None
                     and logit_cap == 0.0 and q.shape[1] >= 128
                     and q.shape[-1] % 128 == 0)
    if use_flash:
        if bias is not None or mask is not None or logit_cap > 0:
            raise ValueError("the flash path takes no bias, mask or logit "
                             "cap; pass use_flash=False")
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids,
                               q_offset=q_offset)
    return mha_reference(q, k, v, causal=causal, bias=bias, mask=mask,
                         q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids, scale=scale,
                         q_offset=q_offset, logit_cap=logit_cap)
