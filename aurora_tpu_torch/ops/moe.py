"""Mixture-of-Experts MLP (aurora_tpu/ops/moe.py) and the grouped-expert
kernel that runs it on the card.

Routing (`routing_weights`): Mixtral's top-k of the router logits, then a
softmax over those k; or the fp32 softmax over every expert, then top-k,
optionally renormalized (Qwen-MoE, DBRX, DeepSeek, Grok); Grok's tanh
softcap on the logits first. Top-k keeps the lower expert index first on
equal values, as `jax.lax.top_k` does, on every device (a stable
descending sort).

Two forms of the routed MLP, with the reference's numbers:
  * `moe_mlp`, the dense form: every expert on every token, the routing
    weights zero where an expert was not picked. It is the plain twin of
    the grouped form, `llama_apply`'s offline MoE and the CPU engine's
    decode, as in the reference;
  * `moe_mlp_grouped`, the sort-by-expert form: each token's k copies
    sorted by expert (a stable sort), gate, up and down as grouped
    products (`moe_grouped_mm`) over the expert offsets, then the
    copies' weighted outputs un-permuted and summed per token in fp32.
The grouped form computes on the device alone: the offsets come from
`torch.searchsorted` on the sorted expert ids, and nothing is read back
to the host (no `.item()`, no `bincount`), so a MoE layer never waits on
the card. The combine gathers each token's k rows and adds them in the
order of their experts, as the reference's scatter-add meets them, with
no atomics (`index_add_` would add in another order on every run).

`moe_grouped_mm` is the port's counterpart of `lax.ragged_dot`, the
reference's grouped matmul: on CUDA tensors it launches the hand-written
kernel of csrc/moe_grouped_mm.cu (bf16 rows, bf16 or int8 experts
dequantized in the kernel as the reference's `_deq` rounds them, group
offsets read on the device); CPU tensors take its plain twin,
`moe_grouped_mm_reference`, a loop over the experts. `.launches` and
`_reference.calls` count each path, `.launches_extend` and
`.launches_decode` the kernel's two plans (`moe_plan`).

Expert weights keep the reference's [E, in, out] layout in an
`ExpertStack`: a float Parameter, or int8 with one fp32 scale per
(expert, output channel), the reference's `_w8` over the input axis.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, Any]


class ExpertStack(nn.Module):
    """One projection of E experts: `weight` [E, K, N] ([in, out] per
    expert, the reference's layout) as a float Parameter, or int8 with
    `scale` [E, N] fp32 (buffers; the reference's W8 expert stacks, whose
    `[L, E, 1, N]` scales lose their unit axis here)."""

    def __init__(self, weight: torch.Tensor,
                 scale: Optional[torch.Tensor] = None):
        super().__init__()
        if scale is None:
            self.weight = nn.Parameter(weight)
        else:
            self.register_buffer("weight", weight)
        self.register_buffer("scale", scale)

    @classmethod
    def empty(cls, E: int, K: int, N: int, quant: bool = False, device=None,
              dtype=None) -> "ExpertStack":
        if quant:
            return cls(torch.zeros((E, K, N), dtype=torch.int8,
                                   device=device),
                       torch.zeros((E, N), dtype=torch.float32,
                                   device=device))
        return cls(torch.zeros((E, K, N), dtype=dtype, device=device))

    def dequantized(self, dtype) -> torch.Tensor:
        """[E, K, N] in `dtype`: int8 values times their scale, both
        rounded to dtype first and the product rounded to dtype (the
        reference's `_deq`); float weights as they are."""
        if self.scale is None:
            return self.weight
        return self.weight.to(dtype) * self.scale.to(dtype)[:, None, :]


class _FloatStack:
    """A float [E, in, out] tensor given in place of an ExpertStack."""

    def __init__(self, weight: torch.Tensor):
        self.weight, self.scale = weight, None

    def dequantized(self, dtype) -> torch.Tensor:
        return self.weight


def _w(stack):
    return stack if isinstance(stack, ExpertStack) else _FloatStack(stack)


def init_moe_params(generator: torch.Generator, num_experts: int,
                    hidden: int, intermediate: int, dtype=torch.float32,
                    device=None) -> Params:
    """Router [D, E] and expert stacks gate/up [E, D, I], down [E, I, D],
    each ~ N(0, 0.02²) from `generator` (on `device`)."""
    def w(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * 0.02

    return {"router": w(hidden, num_experts),
            "gate": w(num_experts, hidden, intermediate),
            "up": w(num_experts, hidden, intermediate),
            "down": w(num_experts, intermediate, hidden)}


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] with fp32 products and sum, returned in fp32
    (the reference's dot with preferred_element_type=f32)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    lead = x.shape[:-1]
    if x.is_cuda and x.dtype == w.dtype:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*lead, -1)
    return x.float() @ w.float()


def top_k(x: torch.Tensor, k: int):
    """The k largest values on the last axis and their indices, the lower
    index first among equal values (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def routing_weights(logits: torch.Tensor, top_k_: int,
                    router_mode: str = "mixtral", norm_topk: bool = False,
                    logit_softcap: float = 0.0):
    """Router logits [..., E] → (top-k weights [..., k] fp32, indices).
    mixtral: top-k of the logits, a softmax over those k. softmax_topk:
    an fp32 softmax over every expert, top-k of the probabilities, divided
    by their sum with norm_topk. logit_softcap c > 0: c·tanh(l/c) first
    (Grok-1; the division runs as a multiply by the fp32 reciprocal, as
    XLA compiles it)."""
    if logit_softcap > 0.0:
        c = logit_softcap
        logits = c * torch.tanh(logits * float(np.float32(1)
                                               / np.float32(c)))
    if router_mode == "mixtral":
        vals, idx = top_k(logits, top_k_)
        return torch.softmax(vals, dim=-1), idx
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = top_k(probs, top_k_)
    if norm_topk:
        vals = vals / vals.sum(dim=-1, keepdim=True)
    return vals, idx


def moe_mlp(params: Params, x: torch.Tensor, top_k_: int,
            return_router_logits: bool = False, router_mode: str = "mixtral",
            norm_topk: bool = False, router_logit_softcap: float = 0.0,
            expert_offset: int = 0):
    """x [B, T, D] → [B, T, D]: every expert on every token, each output
    weighted by its routing weight (0 where not picked) and summed in
    fp32. params: "router" [D, E] and "gate", "up", "down" expert stacks
    (ExpertStack or float [E, in, out] tensors; int8 stacks dequantized
    to x's dtype first). The stacks may hold experts [expert_offset,
    expert_offset + E') of the router's E (a tensor-parallel rank's; the
    routing is over all E). return_router_logits also returns the raw
    (pre-softcap) router logits [B, T, E] fp32."""
    logits = dot_f32(x, params["router"])
    vals, idx = routing_weights(logits, top_k_, router_mode, norm_topk,
                                router_logit_softcap)
    probs = torch.zeros_like(logits).scatter(-1, idx, vals)
    wg, wu, wd = (_w(params[n]).dequantized(x.dtype).float()
                  for n in ("gate", "up", "down"))
    if wg.shape[0] != probs.shape[-1]:
        probs = probs[..., expert_offset:expert_offset + wg.shape[0]]
    xf = x.float()
    gate = torch.einsum("btd,edi->btei", xf, wg).to(x.dtype)
    up = torch.einsum("btd,edi->btei", xf, wu).to(x.dtype)
    h = F.silu(gate) * up
    out = torch.einsum("btei,eid->bted", h.float(), wd)
    out = (out * probs[..., None]).sum(dim=2).to(x.dtype)
    return (out, logits) if return_router_logits else out


def sort_by_expert(top_idx: torch.Tensor, num_experts: int):
    """Routing indices [N, k] → (order [N·k]: the copies sorted by expert,
    stably; offsets [E + 1] int32: expert e's copies are sorted rows
    [offsets[e], offsets[e + 1])), on top_idx's device, without a host
    read. Copy i of the flattened [N·k] is token i // k."""
    flat = top_idx.reshape(-1)
    sorted_e, order = torch.sort(flat, stable=True)
    bounds = torch.arange(num_experts + 1, device=flat.device,
                          dtype=sorted_e.dtype)
    offsets = torch.searchsorted(sorted_e, bounds, out_int32=True)
    return order, offsets


def combine_sorted(rows: torch.Tensor, order: torch.Tensor, k: int):
    """rows [N·k, D] (the copies' weighted outputs in sorted order) →
    [N, D] fp32: each token's k rows gathered and added in sorted order,
    that is in the order of their experts (the reference's scatter-add
    order), without atomics."""
    n = order.numel()
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=order.device))
    pos = torch.sort(inv.reshape(-1, k), dim=1).values
    parts = rows.float()[pos]                            # [N, k, D]
    acc = parts[:, 0]
    for j in range(1, k):
        acc = acc + parts[:, j]
    return acc


def moe_mlp_grouped(params: Params, x: torch.Tensor, top_k_: int,
                    return_router_logits: bool = False,
                    router_mode: str = "mixtral", norm_topk: bool = False,
                    router_logit_softcap: float = 0.0):
    """x [B, T, D] → [B, T, D], the sort-by-expert form of `moe_mlp`
    (the reference's `moe_mlp_grouped`): gate and up in x's dtype from
    fp32 sums, down in fp32, each copy's output times its routing weight,
    then the per-token sum (`combine_sorted`). params as for `moe_mlp`."""
    B, T, D = x.shape
    xf = x.reshape(B * T, D)
    logits = dot_f32(xf, params["router"])
    E = logits.shape[-1]
    vals, idx = routing_weights(logits, top_k_, router_mode, norm_topk,
                                router_logit_softcap)
    order, offsets = sort_by_expert(idx, E)
    xs = xf.index_select(0, order // top_k_)
    gate, up, down = (_w(params[n]) for n in ("gate", "up", "down"))
    g = moe_grouped_mm(xs, gate.weight, offsets, gate.scale,
                       out_dtype=x.dtype)
    u = moe_grouped_mm(xs, up.weight, offsets, up.scale, out_dtype=x.dtype)
    out = moe_grouped_mm(F.silu(g) * u, down.weight, offsets, down.scale,
                         out_dtype=torch.float32)
    w = vals.reshape(-1)[order]
    combined = combine_sorted(out * w[:, None], order, top_k_)
    combined = combined.reshape(B, T, D).to(x.dtype)
    if return_router_logits:
        return combined, logits.reshape(B, T, E)
    return combined


def _get(lp, name):
    return lp.get(name) if isinstance(lp, dict) else getattr(lp, name, None)


def expert_dot(h: torch.Tensor, stack: ExpertStack, out_dtype):
    """h [..., K] @ a one-expert stack ([1, K, N]) → [..., N] in
    out_dtype with fp32 sums: the grouped kernel over one group on the
    card, the dequantized weight otherwise."""
    lead, K = h.shape[:-1], h.shape[-1]
    h2 = h.reshape(-1, K)
    if h2.is_cuda:
        offsets = torch.arange(2, dtype=torch.int32,
                               device=h2.device) * h2.shape[0]
        out = moe_grouped_mm(h2.contiguous(), stack.weight, offsets,
                             stack.scale, out_dtype=out_dtype)
    else:
        out = (h2.float() @ stack.dequantized(h.dtype)[0].float()).to(
            out_dtype)
    return out.reshape(*lead, -1)


def shared_expert_mlp(lp, h: torch.Tensor) -> torch.Tensor:
    """The always-on shared expert (the reference's `shared_expert_mlp`):
    a SiLU MLP over `moe_shared_gate`, `moe_shared_up`, `moe_shared_down`
    (one-expert stacks, [1, in, out]), its fp32 output scaled by
    sigmoid(h · moe_shared_gate_w) where the layer has that scalar gate
    (Qwen2-MoE; DeepSeek's shared experts have none), in h's dtype. lp: a
    layer module or a dict of those names."""
    g = expert_dot(h, _w(_get(lp, "moe_shared_gate")), h.dtype)
    u = expert_dot(h, _w(_get(lp, "moe_shared_up")), h.dtype)
    out = expert_dot(F.silu(g) * u, _w(_get(lp, "moe_shared_down")),
                     torch.float32)
    gate_w = _get(lp, "moe_shared_gate_w")
    if gate_w is None:
        return out.to(h.dtype)
    return (out * torch.sigmoid(dot_f32(h, gate_w))).to(h.dtype)


def load_balancing_loss(router_logits: torch.Tensor, top_k_: int):
    """Mixtral's auxiliary loss E · Σ_e f_e · P_e: f the share of routed
    copies that go to expert e, P its mean router probability."""
    E = router_logits.shape[-1]
    probs = torch.softmax(router_logits.float(), dim=-1)
    _, idx = top_k(router_logits, top_k_)
    counts = F.one_hot(idx, E).float().sum(dim=-2)
    lead = tuple(range(counts.dim() - 1))
    f = counts.mean(dim=lead) / top_k_
    p = probs.mean(dim=lead)
    return E * (f * p).sum()


# ---------------------------------------------------------------------------
# The grouped-expert kernel (csrc/moe_grouped_mm.cu) and its plain twin
# ---------------------------------------------------------------------------

def moe_grouped_mm_reference(xs, w, offsets, scale=None, *, out_dtype=None):
    """Plain twin of `moe_grouped_mm`: for each expert e, its rows
    [offsets[e], offsets[e + 1]) of xs times W_e, products and sum in
    fp32, rounded to out_dtype (default xs's); int8 W_e dequantized to
    xs's dtype first (`ExpertStack.dequantized`). Rows outside every group
    are zero. Reads the offsets on the host."""
    moe_grouped_mm_reference.calls += 1
    out_dtype = out_dtype or xs.dtype
    out = torch.zeros((xs.shape[0], w.shape[2]), dtype=out_dtype,
                      device=xs.device)
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if hi <= lo:
            continue
        we = w[e].to(xs.dtype)
        if scale is not None:
            we = we * scale[e].to(xs.dtype)
        out[lo:hi] = (xs[lo:hi].float() @ we.float()).to(out_dtype)
    return out


moe_grouped_mm_reference.calls = 0


# The grouped kernel's two plans (csrc/moe_grouped_mm.cu). Extend: blocks
# of EXTEND_CLUSTER x EXTEND_ROWS rows of one expert x EXTEND_COLS output
# columns on wgmma, each taken by a cluster of EXTEND_CLUSTER CTAs (bf16
# experts: EXTEND_ROWS rows a CTA; int8: half the columns a CTA), walked
# by persistent clusters in bands of EXTEND_BAND blocks. Decode: stripes
# of DECODE_COLS output columns of one expert, its rows as token tiles of
# 8 or 16.
EXTEND_ROWS = 128
EXTEND_COLS = 256
EXTEND_BAND = 8
EXTEND_CLUSTER = 2
DECODE_COLS = 128
DECODE_ROWS_PER_EXPERT = 4     # decode while M <= this x E


class MoePlan(NamedTuple):
    """How `moe_grouped_mm` launches: `kind` "extend" or "decode"; `grid`
    the launch's blocks (extend: (persistent blocks,); decode: (column
    stripes, expert slots)); `tokens` a decode block's token tile (8 or
    16; 0 for extend)."""
    kind: str
    grid: tuple
    tokens: int


def moe_plan(M: int, K: int, N: int, E: int, int8: bool,
             sm_count: int = 132) -> MoePlan:
    """The grouped kernel's plan from what the host knows (M rows, K, N,
    E experts; never the rows an expert got, which stay on the device).
    At most DECODE_ROWS_PER_EXPERT rows an expert on average the weights
    are the wide operand: the decode plan streams each expert that has
    rows once, a block a stripe of DECODE_COLS columns, with min(E, M)
    expert slots (no more experts than rows can have any), the rows as
    token tiles of 8 (at most 2 rows an expert on average) or 16. Past
    that the extend plan: blocks of EXTEND_CLUSTER x EXTEND_ROWS rows of
    one expert x EXTEND_COLS columns on the tensor cores, a cluster of
    EXTEND_CLUSTER CTAs a block, one persistent CTA an SM at most and no
    more clusters than the most blocks any split of M rows over E experts
    can give. int8 experts take the same grid as bf16 ones (the kernel
    splits a block between the CTAs by columns instead of rows)."""
    del K, int8
    if M <= DECODE_ROWS_PER_EXPERT * E:
        return MoePlan("decode", (-(-N // DECODE_COLS), min(E, M)),
                       8 if M <= 2 * E else 16)
    rows = EXTEND_CLUSTER * EXTEND_ROWS
    blocks = (-(-N // EXTEND_COLS)) * (-(-M // rows) + E)
    return MoePlan("extend", (EXTEND_CLUSTER * min(
        sm_count // EXTEND_CLUSTER, blocks),), 0)


def moe_grouped_mm(xs, w, offsets, scale=None, *, out_dtype=None):
    """xs [M, K] (rows sorted by expert) × w [E, K, N] over the groups of
    offsets [E + 1] int32 → [M, N] in out_dtype (default xs's): expert e's
    rows [offsets[e], offsets[e + 1]) times W_e, fp32 products and sum.
    Int8 w takes its fp32 scale [E, N] and is dequantized as the
    reference rounds it (bf16(q)·bf16(s), before the product). On the
    card: bf16 xs, bf16 or int8 w, bf16 or fp32 out, K % 32 == 0,
    N % 16 == 0, all on one device and contiguous; the offsets stay on the
    device, and rows outside [offsets[0], offsets[E]) are not written. The
    launch follows `moe_plan`. CPU tensors take
    `moe_grouped_mm_reference`."""
    name = "moe_grouped_mm"
    if xs.dim() != 2 or w.dim() != 3 or xs.shape[1] != w.shape[1] \
            or offsets.shape != (w.shape[0] + 1,) \
            or (scale is not None and scale.shape != (w.shape[0],
                                                      w.shape[2])):
        raise ValueError(f"{name}: shapes xs {tuple(xs.shape)}, w "
                         f"{tuple(w.shape)}, offsets {tuple(offsets.shape)}"
                         f", scale {None if scale is None else tuple(scale.shape)}"
                         " do not match")
    if (w.dtype == torch.int8) != (scale is not None):
        raise TypeError(f"{name}: int8 weights take a scale, float weights "
                        "none")
    if xs.device.type == "cpu":
        return moe_grouped_mm_reference(xs, w, offsets, scale,
                                        out_dtype=out_dtype)
    if xs.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xs.device}")
    out_dtype = out_dtype or xs.dtype
    quant = w.dtype == torch.int8
    want = (("xs", xs, torch.bfloat16),
            ("w", w, torch.int8 if quant else torch.bfloat16),
            ("offsets", offsets, torch.int32)) + (
        (("scale", scale, torch.float32),) if quant else ())
    for label, t, dtype in want:
        if t.device != xs.device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected "
                             f"{xs.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    M, K = xs.shape
    E, _, N = w.shape
    if K % 32 or N % 16:
        raise ValueError(f"{name}: the CUDA kernel takes K % 32 == 0 and "
                         f"N % 16 == 0; got K={K}, N={N}")
    out = torch.empty((M, N), dtype=out_dtype, device=xs.device)
    if M == 0:
        return out
    from aurora_tpu_torch.ops.cuda_build import load_library
    plan = moe_plan(M, K, N, E, quant, torch.cuda.get_device_properties(
        xs.device).multi_processor_count)
    err = load_library().aurora_moe_grouped_mm(
        xs.data_ptr(), w.data_ptr(), 0 if scale is None else
        scale.data_ptr(), offsets.data_ptr(), out.data_ptr(), M, K, N, E,
        int(quant), int(out_dtype == torch.float32),
        int(plan.kind == "decode"), plan.tokens, plan.grid[0],
        torch.cuda.current_stream(xs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    moe_grouped_mm.launches += 1
    if plan.kind == "decode":
        moe_grouped_mm.launches_decode += 1
    else:
        moe_grouped_mm.launches_extend += 1
    return out


moe_grouped_mm.launches = 0          # every launch
moe_grouped_mm.launches_extend = 0   # launches of the extend plan
moe_grouped_mm.launches_decode = 0   # and of the decode plan
