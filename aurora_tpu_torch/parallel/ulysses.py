"""Ulysses sequence parallelism: heads scattered and the sequence
gathered by an all-to-all (aurora_tpu/parallel/ulysses.py).

Each rank holds [B, T/sp, H, D]. One all-to-all sends each rank H/sp of
the heads for the whole sequence, [B, T, H/sp, D]; attention runs on
those heads through `ops.attention.mha` (the flash kernels on the card
when `flash_dispatch` allows); the reverse all-to-all brings the rank
its block of the sequence for every head back. q, k and v travel in one
all-to-all (each cut into sp head groups and concatenated along the
group), so that the backward too runs one collective a call.

GQA: the KV heads are repeated only as far as the all-to-all needs
(`_match_kv_heads`: the least multiple of Hkv that sp divides and that
divides H), not out to H; the attention repeats them locally.

When sp does not divide H (the reference's inner-SP path), each head is
cut into insp = sp / gcd(H, sp) pseudo-heads of D/insp columns for the
all-to-all, and the ranks of each inner group of insp consecutive ranks
gather their pseudo-heads back into whole heads (an all-gather over the
inner groups, made once for every group of the mesh); the ranks of an
inner group then hold the same heads and each keeps its own D/insp
columns of the output for the reverse all-to-all.

Segment ids (packed sequences) are gathered along the sequence.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from aurora_tpu_torch.ops.attention import mha
from aurora_tpu_torch.parallel.collectives import (Axis, all_gather,
                                                   all_to_all)


def _match_kv_heads(q, k, v, sp: int = 0):
    """GQA: repeat the KV heads to the least count the head-scatter
    all-to-all can split (sp divides it) and the attention can group (it
    divides H); to H when the pseudo-head path (sp ∤ H) runs."""
    h, hkv = q.shape[2], k.shape[2]
    if hkv == h:
        return k, v
    target = h
    if sp and h % sp == 0:
        lcm = hkv * sp // math.gcd(hkv, sp)
        for cand in range(lcm, h, lcm):
            if cand % hkv == 0 and h % cand == 0:
                target = cand
                break
    if target != hkv:
        k = k.repeat_interleave(target // hkv, dim=2)
        v = v.repeat_interleave(target // hkv, dim=2)
    return k, v


def _to_pseudo_heads(x, sp, insp):
    """[B, Tl, H, D] → [B, Tl, insp·H, D/insp], interleaved so that the
    all-to-all lands each inner group's pseudo-heads together."""
    b, tl, h, d = x.shape
    x = x.reshape(b, tl, sp // insp, h * insp // sp, insp, d // insp)
    return x.transpose(3, 4).reshape(b, tl, insp * h, d // insp)


def _from_pseudo_heads(x, sp, insp, h, d):
    """Inverse of `_to_pseudo_heads`."""
    b, tl = x.shape[:2]
    x = x.reshape(b, tl, sp // insp, insp, h * insp // sp, d // insp)
    return x.transpose(3, 4).reshape(b, tl, h, d)


def heads_to_sequence(xs: List[torch.Tensor], axis: Axis):
    """[B, Tl, h_i, D] each → [B, Tl·n, h_i/n, D] each (n = axis.size):
    one all-to-all for all of them (each cut into n head groups; group j
    goes to the axis' j-th rank)."""
    n = axis.size
    if n == 1:
        return list(xs)
    B, Tl, _, D = xs[0].shape
    widths = [x.shape[2] // n for x in xs]
    packed = torch.cat([x.reshape(B, Tl, n, w, D)
                        for x, w in zip(xs, widths)], dim=3)
    out = all_to_all(packed, axis, 2, 1)        # [B, Tl·n, 1, Σw, D]
    return list(out[:, :, 0].split(widths, dim=2))


def ulysses_attention_local(q, k, v, *, axis: Axis, causal: bool,
                            q_segment_ids=None, kv_segment_ids=None,
                            scale: Optional[float] = None):
    """This rank's body. q, k, v [B, T/sp, H or Hkv, D]."""
    sp = axis.size
    k, v = _match_kv_heads(q, k, v, sp)
    B, Tl, H, D = q.shape
    insp = sp // math.gcd(H, sp)
    if insp > 1:
        if (H * insp) % sp or D % insp:
            raise ValueError(f"inner-SP needs insp ({insp}) to divide "
                             f"head_dim ({D})")
        q, k, v = (_to_pseudo_heads(t, sp, insp) for t in (q, k, v))
    hq, hk = q.shape[2] // sp, k.shape[2] // sp
    qg, kg, vg = heads_to_sequence([q, k, v], axis)
    if insp > 1:
        inner = axis.split(insp)[0]
        qkv = all_gather(torch.cat([qg, kg, vg], dim=2), inner, 3)
        qg, kg, vg = qkv.split([hq, hk, hk], dim=2)
    if q_segment_ids is not None:
        q_segment_ids = all_gather(q_segment_ids, axis, 1)
        kv_segment_ids = all_gather(kv_segment_ids, axis, 1)
    if scale is None:
        scale = D ** -0.5
    out = mha(qg, kg, vg, causal=causal, scale=scale,
              q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
    if insp > 1:
        w = D // insp
        out = out[..., (axis.index % insp) * w:(axis.index % insp + 1) * w]
        out = all_to_all(out, axis, 1, 2)
        return _from_pseudo_heads(out, sp, insp, H, D)
    return all_to_all(out, axis, 1, 2)


def ulysses_mha(q, k, v, mesh, *, axis_name: str = "sp", causal: bool = True,
                q_segment_ids=None, kv_segment_ids=None, scale=None):
    """Ulysses attention over the mesh axis `axis_name`: this rank's
    blocks of the sequence (and of the segment ids) in, its block of the
    output out."""
    return ulysses_attention_local(q, k, v, axis=mesh.axis(axis_name),
                                   causal=causal, scale=scale,
                                   q_segment_ids=q_segment_ids,
                                   kv_segment_ids=kv_segment_ids)
