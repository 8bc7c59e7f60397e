"""Hybrid Ulysses × ring sequence parallelism (aurora_tpu/parallel/
hybrid.py; yunchang's LongContextAttention).

The sp axis of u·r ranks is cut two ways (`Axis.split(u)`, groups made
once on every rank): rank s = g·u + j is Ulysses rank j of Ulysses group
g (consecutive ranks, the reference's `_ulysses_groups`) and ring rank g
of ring group j (ranks j, u + j, 2u + j, ...: `_ring_groups`, whose ring
runs g → g + 1, `_ring_perm`). An all-to-all inside the Ulysses group
scatters the heads u ways and gathers the group's u blocks of the
sequence; the ring loop of parallel/ring.py then runs over the r groups;
the reverse all-to-all returns this rank's block. The all-to-all moves
1/r of what full Ulysses would, the ring takes r − 1 hops instead of
sp − 1.

GQA: with u ∤ Hkv the KV heads are repeated to the least multiple of Hkv
that u divides and that divides H (lcm(Hkv, u) if it divides H).
Zigzag expects the global sequence reordered by `zigzag_split(x, r)`
(r the ring degree). Packed sequences take the llama3 ring over the
ring groups (`ring_varlen_local`), contiguous layout only.
"""

from __future__ import annotations

import math
from typing import Optional

from aurora_tpu_torch.parallel.collectives import Axis, all_gather, all_to_all
from aurora_tpu_torch.parallel.ring import _ring_flash_loop, ring_varlen_local
from aurora_tpu_torch.parallel.ulysses import heads_to_sequence


def hybrid_attention_local(q, k, v, *, axis: Axis, ulysses: int,
                           causal: bool, layout: str = "contiguous",
                           scale: Optional[float] = None, segment_ids=None,
                           heads_k_stride: int = 0):
    """This rank's body. q, k, v [B, T/sp, H or Hkv, D]; u must divide H.
    segment_ids [B, T/sp] switches to the llama3 ring."""
    u = ulysses
    if u < 1 or axis.size % u:
        raise ValueError(f"the Ulysses degree {u} must divide sp "
                         f"({axis.size})")
    H, D = q.shape[2], q.shape[-1]
    if H % u:
        raise ValueError(f"the Ulysses degree {u} must divide heads {H}")
    hkv = k.shape[2]
    if hkv % u:
        lcm = hkv * u // math.gcd(hkv, u)
        target = H
        for cand in range(lcm, H, lcm):
            if H % cand == 0:
                target = cand
                break
        k = k.repeat_interleave(target // hkv, dim=2)
        v = v.repeat_interleave(target // hkv, dim=2)
    if scale is None:
        scale = D ** -0.5
    uaxis, raxis = axis.split(u)
    qg, kg, vg = heads_to_sequence([q, k, v], uaxis)
    if segment_ids is not None:
        if layout != "contiguous":
            raise ValueError("the varlen ring takes the contiguous layout "
                             f"only, got {layout!r}")
        seg = all_gather(segment_ids, uaxis, 1)
        out = ring_varlen_local(qg, kg, vg, seg, axis=raxis,
                                heads_k_stride=heads_k_stride,
                                causal=causal, scale=scale)
    else:
        out = _ring_flash_loop(qg, kg, vg, axis=raxis, causal=causal,
                               layout=layout, scale=scale)
    return all_to_all(out, uaxis, 1, 2)


def hybrid_mha(q, k, v, mesh, *, axis_name: str = "sp", ulysses: int = 1,
               causal: bool = True, layout: str = "contiguous", scale=None):
    """Hybrid attention over the mesh axis `axis_name` (u·r ranks): this
    rank's blocks in, its block of the output out."""
    return hybrid_attention_local(q, k, v, axis=mesh.axis(axis_name),
                                  ulysses=ulysses, causal=causal,
                                  layout=layout, scale=scale)


def hybrid_varlen_mha(q, k, v, segment_ids, mesh, *, axis_name: str = "sp",
                      ulysses: int = 1, heads_k_stride: int = 0,
                      causal: bool = True, scale=None):
    """Packed sequences: the Ulysses all-to-all, then the llama3 ring."""
    return hybrid_attention_local(q, k, v, axis=mesh.axis(axis_name),
                                  ulysses=ulysses, causal=causal,
                                  scale=scale, segment_ids=segment_ids,
                                  heads_k_stride=heads_k_stride)
