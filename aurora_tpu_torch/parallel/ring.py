"""Ring attention: K/V blocks passed around the sequence-parallel ring,
the partial attentions merged by their log-sum-exp
(aurora_tpu/parallel/ring.py).

Each rank holds one block of the sequence. At step i it attends its
queries to the K/V block it holds (first its own, then those the ring
passes on) through the flash kernels' `flash_attention_lse`, and merges
the result into its running (out, lse) with `_merge`. K and V rotate as
one stacked tensor (one exchange a step; `collectives.ring_pass`, whose
backward is the reverse ring); the last block is used without rotating
again. Which flash call a block takes depends on where the K/V block
sits relative to the queries (the reference's diag / lower / upper
cases):

  * contiguous — rank r holds rows [r·Tl, (r+1)·Tl). Under causal
    masking a block from a later rank is skipped: it launches nothing and
    merges nothing (merging an empty block leaves (out, lse) exactly as
    they were), so rank r launches r + 1 forward blocks;
  * zigzag — rank r holds chunks r and 2·sp−1−r of 2·sp (`zigzag_split`);
    every rank sees the same number of masked blocks;
  * stripe — token g sits on rank g mod sp (`stripe_split`); a block from
    a later rank is causal shifted one row (q_offset −1), whose first row
    sees no key.
A row that sees no key has lse −2.38e38 from the kernels and −1e30 from
a skipped half-block here; `_merge` takes any lse ≤ −1e30 as empty.

Zigzag and stripe expect the sequence reordered by `zigzag_split` /
`stripe_split` before it is cut; `*_unsplit` undoes it.

Packed sequences take the llama3 ring (`ring_varlen_local`): K/V and
the segment ids are gathered over the ring (in head chunks of
`heads_k_stride`), and each chunk is one flash call with segment ids at
the rank's q_offset r·Tl.

`ring_attention_local` / `ring_varlen_local` take this rank's blocks and
an `Axis` (parallel/collectives.py); `ring_mha` / `ring_varlen_mha` take
the mesh and the name of its axis, as the reference's do. All of them take
and return this rank's shard of the global [B, T, H, D] arrays.
"""

from __future__ import annotations

from typing import Optional

import torch

from aurora_tpu_torch.ops.pallas.flash_attention import (flash_attention,
                                                        flash_attention_lse)
from aurora_tpu_torch.parallel.collectives import Axis, all_gather, ring_pass

_NEG_INF = -1e30


def _merge(acc, lse_acc, out, lse):
    """Online merge of normalized partial attentions weighted by their
    lse (yunchang's `update_out_and_lse` in normalized form). acc, out
    [B, T, H, D] fp32; lse_acc, lse [B, H, T] fp32."""
    m = torch.maximum(lse_acc, lse)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w_acc = torch.where(lse_acc <= _NEG_INF, 0.0, torch.exp(lse_acc - m_safe))
    w_new = torch.where(lse <= _NEG_INF, 0.0, torch.exp(lse - m_safe))
    denom = torch.clamp_min(w_acc + w_new, 1e-38)
    wa = (w_acc / denom).transpose(1, 2)[..., None]
    wn = (w_new / denom).transpose(1, 2)[..., None]
    merged = acc * wa + out * wn
    lse_new = m_safe + torch.log(denom)
    lse_new = torch.where((lse_acc <= _NEG_INF) & (lse <= _NEG_INF),
                          _NEG_INF, lse_new)
    return merged, lse_new


def _empty_rows(q):
    """(out, lse) of rows that see no key: zeros and −1e30."""
    B, T, H, D = q.shape
    return (q.new_zeros((B, T, H, D), dtype=torch.float32),
            q.new_full((B, H, T), _NEG_INF, dtype=torch.float32))


def _ring_flash_loop(q, k, v, *, axis: Axis, causal: bool, layout: str,
                     scale: Optional[float]):
    """The ring loop shared by ring and hybrid attention. q [B, Tl, H, D],
    k, v [B, Tl, Hkv, D], this rank's blocks; axis: the ring."""
    if layout not in ("contiguous", "zigzag", "stripe"):
        raise ValueError(f"unknown ring layout {layout!r}")
    Tl, D = q.shape[1], q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    if layout == "zigzag" and Tl % 2:
        raise ValueError(f"zigzag needs an even block, got {Tl} rows")
    half = Tl // 2
    rank, size = axis.index, axis.size

    def fl(q_, k_, v_, causal_, q_offset=0):
        out, lse = flash_attention_lse(q_, k_, v_, causal=causal_,
                                       q_offset=q_offset, scale=scale)
        return out.float(), lse.float()

    def diag(k, v):
        if not causal or layout in ("contiguous", "stripe"):
            return fl(q, k, v, causal)
        # zigzag: q_lo attends k_lo causally; q_hi attends k_lo fully and
        # k_hi causally, which is causal at q_offset half over the block
        o1, l1 = fl(q[:, :half], k[:, :half], v[:, :half], True)
        o2, l2 = fl(q[:, half:], k, v, True, half)
        return torch.cat([o1, o2], dim=1), torch.cat([l1, l2], dim=2)

    def lower(k, v):      # K/V from an earlier rank
        if not causal or layout == "contiguous":
            return fl(q, k, v, False)
        if layout == "stripe":
            return fl(q, k, v, True)
        return fl(q, k[:, :half], v[:, :half], False)   # zigzag: k_lo only

    def upper(k, v):      # K/V from a later rank
        if not causal:
            return fl(q, k, v, False)
        if layout == "contiguous":
            return None                                  # skipped
        if layout == "stripe":
            return fl(q, k, v, True, -1)
        o, l = fl(q[:, half:], k, v, False)             # zigzag: q_hi only
        zo, zl = _empty_rows(q[:, :half])
        return torch.cat([zo, o], dim=1), torch.cat([zl, l], dim=2)

    acc = lse_acc = None
    for i, kv in enumerate(ring_pass(torch.stack([k, v]), axis)):
        src = (rank - i) % size         # whose K/V block is in hand
        case = diag if src == rank else lower if src < rank else upper
        block = case(kv[0], kv[1])
        if block is not None:
            acc, lse_acc = (block if acc is None
                            else _merge(acc, lse_acc, *block))
    return acc.to(q.dtype)


def ring_attention_local(q, k, v, *, axis: Axis, causal: bool,
                         layout: str = "contiguous",
                         scale: Optional[float] = None):
    """This rank's ring loop. q, k, v [B, Tl, H or Hkv, D]: the flash
    wrapper repeats the KV heads for each call, so the ring carries the
    compact K/V."""
    return _ring_flash_loop(q, k, v, axis=axis, causal=causal,
                            layout=layout, scale=scale)


def ring_mha(q, k, v, mesh, *, axis_name: str = "sp", causal: bool = True,
             layout: str = "contiguous", scale=None):
    """Ring attention over the mesh axis `axis_name`: this rank's blocks
    of the sequence in, its block of the output out. For causal balance
    reorder the global sequence with `zigzag_split` first and pass
    layout='zigzag'."""
    return ring_attention_local(q, k, v, axis=mesh.axis(axis_name),
                                causal=causal, layout=layout, scale=scale)


def ring_varlen_local(q, k, v, q_segment_ids, *, axis: Axis,
                      heads_k_stride: int = 0, causal: bool = True,
                      scale: Optional[float] = None):
    """Packed sequences: K/V gathered over the ring in chunks of
    `heads_k_stride` KV heads (all at once for 0), each chunk one flash
    call with segment ids at this rank's q_offset rank·Tl.

    q [B, Tl, H, D]; k, v [B, Tl, Hkv, D]; q_segment_ids [B, Tl] (global
    segment numbers: one packing across the ring)."""
    Tl, H = q.shape[1], q.shape[2]
    Hkv = k.shape[2]
    G = H // Hkv
    if heads_k_stride <= 0 or heads_k_stride > Hkv:
        heads_k_stride = Hkv
    kv_seg = all_gather(q_segment_ids, axis, 1)
    outs = []
    for h0 in range(0, Hkv, heads_k_stride):
        kv = all_gather(torch.stack([k[:, :, h0:h0 + heads_k_stride],
                                     v[:, :, h0:h0 + heads_k_stride]]),
                        axis, 2)
        qc = q[:, :, h0 * G:(h0 + heads_k_stride) * G]
        outs.append(flash_attention(qc, kv[0], kv[1], causal=causal,
                                    scale=scale,
                                    q_segment_ids=q_segment_ids,
                                    kv_segment_ids=kv_seg,
                                    q_offset=axis.index * Tl))
    return torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]


def ring_varlen_mha(q, k, v, segment_ids, mesh, *, axis_name: str = "sp",
                    heads_k_stride: int = 0, causal: bool = True,
                    scale=None):
    """The llama3 ring over the mesh axis `axis_name` (contiguous blocks)."""
    return ring_varlen_local(q, k, v, segment_ids, axis=mesh.axis(axis_name),
                             heads_k_stride=heads_k_stride, causal=causal,
                             scale=scale)


# ---------------------------------------------------------------------------
# Reordering a global sequence for the zigzag and stripe layouts
# ---------------------------------------------------------------------------

def _take(x, idx, axis):
    return x.index_select(axis, torch.as_tensor(idx, device=x.device))


def stripe_split(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    """Reorder so that contiguous sp-blocks hold the strips {r, r+sp,
    r+2sp, ...}."""
    n = x.shape[axis]
    if n % sp:
        raise ValueError(f"stripe_split: {n} is not a multiple of {sp}")
    return _take(x, torch.arange(n).reshape(n // sp, sp).T.reshape(-1), axis)


def stripe_unsplit(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    n = x.shape[axis]
    if n % sp:
        raise ValueError(f"stripe_unsplit: {n} is not a multiple of {sp}")
    return _take(x, torch.arange(n).reshape(sp, n // sp).T.reshape(-1), axis)


def _zigzag_order(sp: int):
    order = []
    for r in range(sp):
        order += [r, 2 * sp - 1 - r]
    return order


def zigzag_split(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    """Reorder so that contiguous sp-blocks hold the chunk pairs
    (r, 2sp−1−r) of 2·sp chunks."""
    if x.shape[axis] % (2 * sp):
        raise ValueError(f"zigzag_split: {x.shape[axis]} is not a multiple "
                         f"of {2 * sp}")
    chunks = x.chunk(2 * sp, dim=axis)
    return torch.cat([chunks[i] for i in _zigzag_order(sp)], dim=axis)


def zigzag_unsplit(x: torch.Tensor, sp: int, axis: int = 1) -> torch.Tensor:
    if x.shape[axis] % (2 * sp):
        raise ValueError(f"zigzag_unsplit: {x.shape[axis]} is not a "
                         f"multiple of {2 * sp}")
    chunks = x.chunk(2 * sp, dim=axis)
    inv = [0] * (2 * sp)
    for pos, c in enumerate(_zigzag_order(sp)):
        inv[c] = pos
    return torch.cat([chunks[inv[i]] for i in range(2 * sp)], dim=axis)
