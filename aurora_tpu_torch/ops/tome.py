"""Token Merging, bipartite soft matching (aurora_tpu/ops/tome.py).

Same semantics as the reference: tokens split into A (even) and B (odd)
sets; each A token proposes its most similar B token (cosine similarity
of the merge metric); the r best proposals merge into their targets by a
size-weighted sum; with class_token the CLS token never merges and the
surviving A tokens are kept in ascending order. The proposal ranking is
a stable descending sort, so merge indices equal the reference's exactly
for the same metric. The merge adds the tokens into their targets in
a fixed order, on every device: on the card scatter_add's atomics add
them in any order, and the bf16 sums then differ from run to run, which
later layers' rankings turn into other merges. A merge takes a mode:
"sum" (merge_wavg's), "amax" (merge_source's provenance) or "mean".

The off-path matchers of the reference are here too: `merge_source`,
`kth_bipartite_soft_matching` (sets: every k-th token and the rest) and
`random_bipartite_soft_matching` (r random tokens and the rest). The
random one draws its split from a torch.Generator, where the reference
draws from a JAX key, so the two draw different splits from one seed;
`random_split` is the draw and `split_soft_matching` the matching given
a split, which takes the reference's split as it is.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

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


def _merge_add(b: torch.Tensor, idx: torch.Tensor,
               src: torch.Tensor) -> torch.Tensor:
    """b.scatter_add(1, idx, src) for rows b [B, tB, C], idx [B, r], src
    [B, r, C]: the sums in fp32, as a product with idx's one-hot, rounded
    to b's dtype once. A matmul adds in the same order on every call,
    where scatter_add's atomics on the card do not."""
    onehot = torch.zeros(*idx.shape, b.shape[1], dtype=torch.float32,
                         device=b.device).scatter_(2, idx[..., None], 1.0)
    return (b.float() + onehot.transpose(1, 2) @ src.float()).to(b.dtype)


def _scatter_rows(b: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """Merge the rows src [B, r, C] into b [B, tB, C] at idx [B, r]: "sum"
    (`_merge_add`), "amax", or "mean" (the sum over 1 + the rows merged
    into each target)."""
    if mode == "sum":
        return _merge_add(b, idx, src)
    if mode == "amax":
        return b.scatter_reduce(1, idx[..., None].expand(-1, -1, b.shape[2]),
                                src, reduce="amax", include_self=True)
    if mode == "mean":
        cnt = torch.zeros(b.shape[:2], dtype=torch.float32,
                          device=b.device).scatter_add_(
            1, idx, torch.ones(idx.shape, dtype=torch.float32,
                               device=b.device))
        return _merge_add(b, idx, src) / (1.0 + cnt.to(b.dtype))[..., None]
    raise ValueError(f"unknown merge mode {mode!r}")


def apply_merge(x: torch.Tensor, unm_idx: torch.Tensor,
                src_idx: torch.Tensor, dst_idx: torch.Tensor,
                mode: str = "sum") -> torch.Tensor:
    """Merge token rows: x [B, T, C] → [B, T - r, C]."""
    a, b = x[:, 0::2], x[:, 1::2]
    unm = _gather_tokens(a, unm_idx)
    src = _gather_tokens(a, src_idx).to(b.dtype)
    return torch.cat([unm, _scatter_rows(b, dst_idx, src, mode)], dim=1)


def _identity(x, mode="mean"):
    return x


def bipartite_soft_matching(metric: torch.Tensor, r: int,
                            class_token: bool = True):
    """Returns `merge(x, mode="mean")` over the matched tokens; identity
    when the clamped r is 0."""
    protected = 1 if class_token else 0
    r = max(0, min(r, (metric.shape[1] - protected) // 2))
    if r <= 0:
        return _identity
    unm_idx, src_idx, dst_idx = compute_merge_indices(
        metric, r, class_token=class_token)
    return lambda x, mode="mean": apply_merge(x, unm_idx, src_idx, dst_idx,
                                              mode)


def merge_wavg(merge, x: torch.Tensor, size: torch.Tensor = None):
    """Size-weighted average merge → (merged_x, new_size), size [B, T, 1]
    starting at ones."""
    if size is None:
        size = torch.ones_like(x[..., :1])
    x = merge(x * size, mode="sum")
    size = merge(size, mode="sum")
    return x / size, size


def merge_source(merge, x: torch.Tensor, source: torch.Tensor = None):
    """Provenance: which original tokens each merged token holds, an
    adjacency [B, T_merged, T] (the identity before any merge)."""
    if source is None:
        n, t, _ = x.shape
        source = torch.eye(t, dtype=x.dtype, device=x.device)[None].expand(
            n, t, t)
    return merge(source, mode="amax")


def _normalized(metric: torch.Tensor) -> torch.Tensor:
    m = metric.to(torch.float32)
    return m / m.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def kth_bipartite_soft_matching(metric: torch.Tensor, k: int):
    """Sets: every k-th token (B) and the rest (A); each A token merges
    into its most similar B token, so the output has T // k tokens.
    Raises ValueError unless k divides T (trailing tokens would vanish)."""
    if k <= 1:
        return _identity
    T = metric.shape[1]
    if T % k != 0:
        raise ValueError(
            f"kth matching needs k | T (T={T}, k={k}); trailing tokens "
            "would silently vanish otherwise")

    def split(x):
        xr = x.reshape(x.shape[0], -1, k, x.shape[-1])
        return (xr[:, :, :k - 1].reshape(x.shape[0], -1, x.shape[-1]),
                xr[:, :, k - 1])

    a, b = split(_normalized(metric))
    dst_idx = (a @ b.transpose(1, 2)).argmax(dim=-1)

    def merge(x: torch.Tensor, mode: str = "mean") -> torch.Tensor:
        xa, xb = split(x)
        return _scatter_rows(xb, dst_idx, xa.to(xb.dtype), mode)

    return merge


def random_split(metric: torch.Tensor, r: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draw of `random_bipartite_soft_matching`: a random permutation
    of each row's T tokens from `generator` → (a_idx [B, r], b_idx
    [B, T - r])."""
    B, N = metric.shape[:2]
    perm = torch.argsort(torch.rand((B, N), generator=generator,
                                    device=metric.device), dim=1)
    return perm[:, :r], perm[:, r:]


def split_soft_matching(metric: torch.Tensor, a_idx: torch.Tensor,
                        b_idx: torch.Tensor):
    """The matching given a split: each token of a_idx merges into its
    most similar token of b_idx → merge(x, mode="mean"), [B, T - r, C]."""
    m = _normalized(metric)
    a, b = _gather_tokens(m, a_idx), _gather_tokens(m, b_idx)
    dst_idx = (a @ b.transpose(1, 2)).argmax(dim=-1)

    def merge(x: torch.Tensor, mode: str = "mean") -> torch.Tensor:
        dst = _gather_tokens(x, b_idx)
        return _scatter_rows(dst, dst_idx, _gather_tokens(x, a_idx).to(
            dst.dtype), mode)

    return merge


def random_bipartite_soft_matching(metric: torch.Tensor, r: int,
                                   generator: Optional[torch.Generator]
                                   = None):
    """Sets: r random tokens (A) and the rest (B); identity for r ≤ 0."""
    if r <= 0:
        return _identity
    return split_soft_matching(metric, *random_split(metric, r, generator))
