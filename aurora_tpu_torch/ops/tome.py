"""Token Merging, bipartite soft matching (aurora_tpu/ops/tome.py).

Same semantics as the reference: tokens split into A (even) and B (odd)
sets; each A token proposes its most similar B token (cosine similarity
of the merge metric); the r best proposals merge into their targets by a
size-weighted sum; with class_token the CLS token never merges and the
surviving A tokens are kept in ascending order. The proposal ranking is
a stable descending sort, so merge indices equal the reference's exactly
for the same metric. Only the bipartite variant is ported.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

_NEG_INF = -1e30


def tome_r(height: int, width: int, patch_size: int, kept_ratio: float,
           num_layers: int) -> int:
    """Per-layer merge count: int(H*W/p² * (1 - ratio) / num_layers)."""
    return int(height * width / (patch_size ** 2) * (1.0 - kept_ratio)
               / num_layers)


class TomeStep(NamedTuple):
    t_in: int
    r: int
    t_out: int


def tome_schedule(num_tokens: int, r: int, num_layers: int,
                  protected: int = 1) -> List[TomeStep]:
    """Per-layer token counts with the clamp r ≤ (t - protected) // 2."""
    steps = []
    t = num_tokens
    for _ in range(num_layers):
        r_eff = max(0, min(r, (t - protected) // 2))
        steps.append(TomeStep(t, r_eff, t - r_eff))
        t -= r_eff
    return steps


def compute_merge_indices(metric: torch.Tensor, r: int,
                          class_token: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """metric [B, T, C] → (unm_idx [B, tA-r], src_idx [B, r],
    dst_idx [B, r]), int64 indices into the A / B sets."""
    metric = metric.to(torch.float32)
    metric = metric / metric.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    a, b = metric[:, 0::2], metric[:, 1::2]
    scores = a @ b.transpose(1, 2)                       # [B, tA, tB]
    if class_token:
        scores[:, 0, :] = _NEG_INF
    node_max = scores.amax(dim=-1)
    node_idx = scores.argmax(dim=-1)   # first maximal index, as jnp.argmax
    edge_idx = torch.argsort(node_max, dim=-1, descending=True, stable=True)
    src_idx = edge_idx[:, :r]
    unm_idx = edge_idx[:, r:]
    if class_token:
        unm_idx = unm_idx.sort(dim=-1).values
    dst_idx = node_idx.gather(1, src_idx)
    return unm_idx, src_idx, dst_idx


def _gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def apply_merge(x: torch.Tensor, unm_idx: torch.Tensor,
                src_idx: torch.Tensor, dst_idx: torch.Tensor
                ) -> torch.Tensor:
    """Sum-merge token rows: x [B, T, C] → [B, T - r, C]."""
    a, b = x[:, 0::2], x[:, 1::2]
    unm = _gather_tokens(a, unm_idx)
    src = _gather_tokens(a, src_idx).to(b.dtype)
    dst = b.scatter_add(
        1, dst_idx[..., None].expand(-1, -1, x.shape[-1]), src)
    return torch.cat([unm, dst], dim=1)


def bipartite_soft_matching(metric: torch.Tensor, r: int,
                            class_token: bool = True):
    """Returns `merge(x)`, a sum-merge over the matched tokens; identity
    when the clamped r is 0."""
    protected = 1 if class_token else 0
    r = max(0, min(r, (metric.shape[1] - protected) // 2))
    if r <= 0:
        return lambda x: x
    unm_idx, src_idx, dst_idx = compute_merge_indices(
        metric, r, class_token=class_token)
    return lambda x: apply_merge(x, unm_idx, src_idx, dst_idx)


def merge_wavg(merge, x: torch.Tensor, size: torch.Tensor = None):
    """Size-weighted average merge → (merged_x, new_size), size [B, T, 1]
    starting at ones."""
    if size is None:
        size = torch.ones_like(x[..., :1])
    x = merge(x * size)
    size = merge(size)
    return x / size, size
