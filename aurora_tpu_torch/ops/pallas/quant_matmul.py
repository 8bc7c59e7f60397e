"""Quantized decode matmuls: W4A8 over nibble-packed int4 weights
(aurora_tpu/ops/pallas/quant_matmul.py `w4a8_matmul_tiled`; `w4a8_matmul`
on the reference's flat layout), W4A16 on the flat layout
(`w4a16_matmul`), the fused W4 MLP (`fused_mlp_w4`) and W8A8 over int8
weights (`w8a8_matmul`).

The port's W4 layout, converted once when weights load (the reference's
TPU tile layout `w4_tile_layout` answers a VMEM budget the card does not
have):

  packed [N, K/2] int8   row n = output channel n; byte j holds input row
                         2j in its low nibble and row 2j+1 in its high
                         nibble, each a signed 4-bit value in [-8, 7]
  scale  [N, G]   fp32   per (output channel, input group of K/G rows)

so each output channel's weights are one contiguous stripe. The bytes are
the reference's flat layout ([G, g/2, N] packed, [G, 1, N] scales)
transposed: `w4_from_flat` converts.

The flat layout itself (`w4_to_flat` converts back) is kept for
`EngineConfig(w4_tiled=False)`, and the fused-MLP layout
(`w4_mlp_tile_layout`: gate/up I-tiles of the reference's width as
channel stripes, beside the flat down stream) for
`EngineConfig(w4_fused_mlp=True)`.

The W8 layout is the nn.Linear one: weight [N, K] int8, one fp32 scale
per output channel [N].

Each kernel wrapper takes its plain PyTorch twin (`*_plain`) for CPU
tensors and launches its CUDA kernel for CUDA tensors
(csrc/w4a8_matmul.cu, csrc/w4_flat_matmul.cu, csrc/fused_mlp_w4.cu,
csrc/w8a8_matmul.cu; the W4A8 ones and the fused MLP also quantize the
activations on the card); it never falls back from one to the other.
`.launches` and `_plain.calls` count each path.

`w4a8_matmul_tiled`, `w4a8_matmul`, `w8a8_matmul` and `w4a16_matmul` are
tensor-core weight streamers (csrc/weight_stream.cuh): a grid of (column
tile, K split) blocks that `weight_plan` picks on the host, whose splits meet
through a partial-sum scratch and a ticket per column tile that are kept
per device (`_stream_buffers`), so launches of one of them on one device
must not overlap (one stream; a CUDA graph replays them in order).
`quantize_rows` is `quantize_activations` in one kernel launch, for the
W8A8 decode path. `fused_mlp_w4_bound` bounds the fused MLP kernel's
difference from its bf16 twin, from the two orders of summation.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_TOKENS = 64      # rows the kernels take (the engine sends at most 64)

# The reference divides by constants (127, 7) inside jit, which XLA
# compiles to a multiply by the fp32 reciprocal; the port multiplies by the
# same fp32 values so that its quantizers agree with it bit for bit.
INV127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_activations(h: torch.Tensor):
    """Per-token absmax int8 quantization (the engine's _wdot recipe).
    h [..., K] float → (h8 int8 [..., K], s_a fp32 [..., 1])."""
    hf = h.float()
    s_a = (hf.abs().amax(dim=-1, keepdim=True) * INV127).clamp_min(1e-12)
    h8 = torch.clamp(torch.round(hf / s_a), -127, 127).to(torch.int8)
    return h8, s_a


def w4_unpack(packed: torch.Tensor):
    """packed [..., K/2] int8 → (lo, hi) int32 nibble planes, each
    sign-extended: lo holds the even input rows, hi the odd ones."""
    b = packed.to(torch.int32)
    return ((b & 0xF) ^ 8) - 8, b >> 4


def w4_pack(q: torch.Tensor) -> torch.Tensor:
    """Signed 4-bit values [..., K] (int, in [-8, 7]) → packed [..., K/2]
    int8 bytes: even rows in the low nibble, odd rows in the high."""
    q = q.to(torch.int32)
    byte = (q[..., 0::2] & 0xF) | ((q[..., 1::2] & 0xF) << 4)
    return byte.to(torch.uint8).view(torch.int8)


def w4_dequantize(packed: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """[N, K/2] packed + [N, G] scales → dense [N, K] weights in `dtype`
    (the grouped values times their scale in fp32, then cast)."""
    lo, hi = w4_unpack(packed)
    N, G = scale.shape
    q = torch.stack([lo, hi], dim=-1).reshape(N, G, -1).float()
    return (q * scale[:, :, None]).reshape(N, -1).to(dtype)


# cs = max_g s · 8/127: the per-channel int8 step that covers the W4
# group scales' whole range (the reference's constant, as XLA folds it)
A8_CHANNEL_SCALE = float(np.float32(8.0 / 127.0))


def w4_requantize_int8(packed: torch.Tensor, scale: torch.Tensor):
    """[N, K/2] packed + [N, G] scales → (int8 [N, K], fp32 per-output-
    channel scales cs [N]): the reference's AURORA_W4_PREFILL=a8
    requantization, cs = max_g s · (8/127), m = s / cs, w8 = clip(round(q
    · m), ±127), so that w8 · cs approximates q · s within cs/2."""
    lo, hi = w4_unpack(packed)
    N, G = scale.shape
    q = torch.stack([lo, hi], dim=-1).reshape(N, G, -1).float()
    cs = scale.amax(dim=1) * A8_CHANNEL_SCALE
    m = scale / cs[:, None]
    w8 = torch.clamp(torch.round(q * m[:, :, None]), -127, 127)
    return w8.to(torch.int8).reshape(N, -1), cs


def w4_from_flat(pk: np.ndarray, s_w: np.ndarray):
    """The reference's flat W4 layout, one layer as numpy arrays
    ([G, g/2, N] packed int8, [G, 1, N] fp32 scales) → the port's
    (packed [N, K/2], scale [N, G]) tensors."""
    G, gh, N = pk.shape
    packed = np.array(pk.reshape(G * gh, N).T, dtype=np.int8, order="C")
    scale = np.array(s_w.reshape(G, N).T, dtype=np.float32, order="C")
    return torch.from_numpy(packed), torch.from_numpy(scale)


def w4_to_flat(packed: torch.Tensor, scale: torch.Tensor):
    """Inverse of `w4_from_flat`, on the tensors' device: the port's
    (packed [N, K/2], scale [N, G]) → the reference's flat layout
    (packed [G, g/2, N] int8, scale [G, 1, N] fp32), contiguous."""
    N, G = scale.shape
    pk = packed.t().contiguous().reshape(G, -1, N)
    return pk, scale.t().contiguous().reshape(G, 1, N)


def w4_flat_dequantize(pk: torch.Tensor, s_w: torch.Tensor,
                       dtype) -> torch.Tensor:
    """Flat [G, g/2, N] packed + [G, 1, N] scales → dense [K, N] weights
    in `dtype` (the grouped values times their scale in fp32, then cast:
    the reference's `_w4dot` prefill branch)."""
    lo, hi = w4_unpack(pk)
    G, gh, N = pk.shape
    q = torch.stack([lo, hi], dim=2).reshape(G, 2 * gh, N).float()
    return (q * s_w).reshape(2 * G * gh, N).to(dtype)


# ---------------------------------------------------------------------------
# The fused-MLP layout (the counterpart of the reference's
# w4_mlp_tile_layout / w4_mlp_untile_layout, with the reference's I-tile)
# ---------------------------------------------------------------------------

MLP_TILES = (256, 128)   # the reference's I-tile widths, in order of choice


def w4_mlp_tile(I: int, gd: int):
    """The reference's I-tile for intermediate width I and down group gd
    (`_w4_mlp_fuse_params`: the first t in MLP_TILES with I % t == 0,
    t % gd == 0 and t <= I), or None where it keeps the two-call MLP."""
    return next((t for t in MLP_TILES if I % t == 0 and t % gd == 0
                 and t <= I), None)


def w4_mlp_tile_layout(gu_pk, gu_s, dn_pk, dn_s, ti=None):
    """Flat W4 gateup ([G, g/2, 2I] packed, [G, 1, 2I] scales; gate
    columns then up columns) and down ([Gd, gd/2, D], [Gd, 1, D]) →
    the fused-MLP layout, I-tiles of ti (default the reference's,
    `w4_mlp_tile`):

      mgu [Ib, 2ti, D/2] int8   tile j's channels as stripes of D/2
                                packed bytes (the stripe layout of
                                `w4a8_matmul_tiled`), in groups of 16:
                                gate columns j·ti + 8m .. + 7, then the
                                up columns of the same 8
      mgs [Ib, G,   2ti] fp32   their scales, in that channel order
      mdw [Gd, gd/2, D]  int8   the flat down stream as it is: tile j
      mds [Gd, 1,    D]  fp32   is its packed rows [j·ti/2, (j+1)·ti/2)

    so that every 16 channels of a tile hold 8 whole (gate, up) pairs.
    The reference's own tiles are K-major ([Ib, D/2, 2ti], gate block
    then up block): `w4_mlp_untile_reference` reads those."""
    G, gh, I2 = gu_pk.shape
    I, D2 = I2 // 2, G * gh
    Gd, ghd = dn_pk.shape[:2]
    ti = ti or w4_mlp_tile(I, I // Gd)
    if ti is None or I % ti or ti % 8:
        raise ValueError(f"no I-tile of {MLP_TILES} fits I={I} with down "
                         f"groups of {I // Gd}")
    Ib, m = I // ti, ti // 8
    mgu = (gu_pk.reshape(D2, 2, Ib, m, 8).permute(2, 3, 1, 4, 0)
           .reshape(Ib, 2 * ti, D2).contiguous())
    mgs = (gu_s.float().reshape(G, 2, Ib, m, 8).permute(2, 0, 3, 1, 4)
           .reshape(Ib, G, 2 * ti).contiguous())
    return mgu, mgs, dn_pk.contiguous(), dn_s.float().contiguous()


def _untile_gateup(mgu, mgs):
    """mgu, mgs of `w4_mlp_tile_layout` → the flat gateup (gu_pk [G, g/2,
    2I], gu_s [G, 1, 2I])."""
    Ib, ti2, D2 = mgu.shape
    G, m = mgs.shape[1], ti2 // 16
    gu_pk = (mgu.reshape(Ib, m, 2, 8, D2).permute(4, 2, 0, 1, 3)
             .reshape(G, D2 // G, Ib * ti2))
    gu_s = (mgs.reshape(Ib, G, m, 2, 8).permute(1, 3, 0, 2, 4)
            .reshape(G, 1, Ib * ti2))
    return gu_pk, gu_s


def w4_mlp_untile_layout(mgu, mgs, mdw, mds):
    """Inverse of `w4_mlp_tile_layout` → flat (gu_pk, gu_s, dn_pk, dn_s)
    for the paths that want the two projections (prefill) and for the
    plain twin."""
    return (*_untile_gateup(mgu, mgs), mdw, mds)


def w4_mlp_untile_reference(mgu, mgs, mdw, mds):
    """The reference's fused-MLP tiles (its `w4_mlp_tile_layout`: mgu
    [Ib, D/2, 2ti] K-major, gate columns then up columns; mgs [Ib, G,
    2ti]; mdw [Ib, ti/2, D]; mds [Ib, ti/group, D]) → flat (gu_pk, gu_s,
    dn_pk, dn_s), for the bridge."""
    Ib, D2, ti2 = mgu.shape
    ti, G = ti2 // 2, mgs.shape[1]
    gu_pk = (mgu.reshape(Ib, D2, 2, ti).permute(1, 2, 0, 3)
             .reshape(G, D2 // G, 2 * Ib * ti))
    gu_s = mgs.reshape(Ib, G, 2, ti).permute(1, 2, 0, 3).reshape(
        G, 1, 2 * Ib * ti)
    ghd, D = mdw.shape[1] // mds.shape[1], mdw.shape[-1]
    return gu_pk, gu_s, mdw.reshape(-1, ghd, D), mds.reshape(-1, 1, D)


# ---------------------------------------------------------------------------
# Plain twin (the contract; CPU path and the card's reference)
# ---------------------------------------------------------------------------

def _w4a8_terms(h, pk, s_w):
    """The W4A8 recipe's group terms on the flat layout (pk [G, g/2, N],
    s_w [G, 1, N]): h [B, K] → (terms [B, G, N] fp32, s_a [B, 1]). Each
    group's int32 partial is at most 127·8·g < 2^24 in magnitude, so fp32
    products of the unpacked planes give it exactly (with TF32 off on the
    card); a term is that partial times its scale, rounded once."""
    B = h.shape[0]
    G, gh, N = pk.shape
    h8, s_a = quantize_activations(h)
    x = h8.float().reshape(B, G, gh, 2)
    lo, hi = w4_unpack(pk)
    part = (torch.einsum("bgj,gjn->bgn", x[..., 0], lo.float())
            + torch.einsum("bgj,gjn->bgn", x[..., 1], hi.float()))
    return part * s_w.reshape(1, G, N), s_a


def _w4a8_fp32(h, pk, s_w):
    """The W4A8 recipe in fp32 on the flat layout: h [B, K] → [B, N]
    fp32, the group terms summed in fp32, the activation scale last."""
    terms, s_a = _w4a8_terms(h, pk, s_w)
    return terms.sum(dim=1) * s_a


def w4a8_matmul_tiled_plain(h, packed, scale, *, out_dtype=None):
    """fp32 reference of `w4a8_matmul_tiled`: `_w4a8_fp32` on the stripe
    bytes transposed to the flat layout."""
    w4a8_matmul_tiled_plain.calls += 1
    out = _w4a8_fp32(h, *w4_to_flat(packed, scale))
    return out.to(out_dtype or h.dtype)


w4a8_matmul_tiled_plain.calls = 0


def w8a8_matmul_plain(h8, s_a, w8, s_w, *, out_dtype=torch.bfloat16):
    """Reference of `w8a8_matmul`. The int32 dot of each output is exact in
    fp64 (|sum| ≤ 127² K < 2^53) and rounds to fp32 as the int32 does;
    then acc · s_a · s_w in fp32, in that order."""
    w8a8_matmul_plain.calls += 1
    acc = (h8.double() @ w8.double().t()).float()
    return (acc * s_a * s_w.reshape(1, -1)).to(out_dtype)


w8a8_matmul_plain.calls = 0


def w4a8_matmul_plain(h, pk, s_w, *, out_dtype=None):
    """fp32 reference of `w4a8_matmul` (the reference's `w4a8_matmul` and
    `_w4dot` decode branch on the flat layout)."""
    w4a8_matmul_plain.calls += 1
    return _w4a8_fp32(h, pk, s_w).to(out_dtype or h.dtype)


w4a8_matmul_plain.calls = 0


def _w4a16_weight(pk, s_w, dtype):
    """Flat W4 → dense [K, N] weights as the reference's `_kernel4`
    dequantizes them: dtype(q) · dtype(s), rounded to dtype."""
    lo, hi = w4_unpack(pk)
    G, gh, N = pk.shape
    s = s_w.to(dtype)
    w = torch.stack([lo.to(dtype) * s, hi.to(dtype) * s], dim=2)
    return w.reshape(2 * G * gh, N)


def w4a16_matmul_plain(h, pk, s_w, *, out_dtype=None):
    """Reference of `w4a16_matmul`: bf16(h) @ bf16(bf16(q) · bf16(s)),
    each product exact in fp32, fp32 accumulation."""
    w4a16_matmul_plain.calls += 1
    w = _w4a16_weight(pk, s_w, torch.bfloat16).float()
    out = h.to(torch.bfloat16).float() @ w
    return out.to(out_dtype or h.dtype)


w4a16_matmul_plain.calls = 0


def fused_mlp_w4_plain(h, mgu, mgs, mdw, mds, *, out_dtype=None,
                       compute_dtype=torch.bfloat16):
    """Reference of `fused_mlp_w4`: gate/up by the W4A8 recipe kept in
    fp32, silu(gate)·up in fp32 as gate / (1 + exp(-gate)) · up, cast to
    compute_dtype, then the down projection on weights dequantized as
    compute_dtype(q) · compute_dtype(s) with fp32 accumulation. The
    reference's kernel computes in bf16 on the chip and in fp32 in
    interpret mode: compute_dtype picks which one to reproduce."""
    fused_mlp_w4_plain.calls += 1
    gu_pk, gu_s, dn_pk, dn_s = w4_mlp_untile_layout(mgu, mgs, mdw, mds)
    gu = _w4a8_fp32(h, gu_pk, gu_s)
    gate, up = gu.chunk(2, dim=-1)
    act = (gate / (1.0 + torch.exp(-gate)) * up).to(compute_dtype)
    out = act.float() @ _w4a16_weight(dn_pk, dn_s, compute_dtype).float()
    return out.to(out_dtype or h.dtype)


fused_mlp_w4_plain.calls = 0


# ---------------------------------------------------------------------------
# The fused MLP kernel's bound against its bf16 twin
# ---------------------------------------------------------------------------
#
# Kernel (csrc/fused_mlp_w4.cu) and twin (`fused_mlp_w4_plain`, bf16
# compute) take the same rounded group terms x_g = fp32(part_g · s_g) and
# differ only in the order of two fp32 sums:
#   * gate/up: the twin sums its G terms in torch's order; the kernel in
#     KW running sums (slice s takes the groups g ≡ s mod KW in increasing
#     g, its first addition 0 + x exact), which it adds in slice order.
#     Each addition rounds by at most u = 2^-24 of its result, so the
#     kernel is within u · Σ |partial sums| of the exact sum, and the
#     twin's distance from it is measured. Through · s_a and silu(g) · up
#     (exp to 2 ulps, then IEEE add, divide and multiply on both sides)
#     the two fp32 activations differ by at most E_act (`fused_mlp_act`).
#   * Where no bf16 rounding midpoint lies within E_act of the twin's
#     activation, both round it to the same bf16; where one does (a near
#     tie) the kernel's may be the neighbour: bf16(a ± E_act) bounds the
#     change. The down product then moves by Σ over those near-tie i of
#     that change · |Wd[i, d]|, Wd the bf16 down weights.
#   * down: the products act · Wd are exact in fp32. The twin's fp32
#     matmul is measured against the exact sum; the kernel sums a tile's
#     ti rows in 16-row mma k-steps, in order, and the tile partials in
#     tile order (mlp_reduce). One bf16 mma with fp32 accumulation (the
#     products exact, aligned to the largest and truncated, then
#     normalized) errs by less than 18 ulps of its largest addend, below
#     TC_MMA · (|C| + Σ|products|); each tile addition by u of its result.
# The sum of these is the per-output bound (`fused_mlp_down_bound`).

U32 = 2.0 ** -24         # fp32 unit roundoff (round to nearest)
TC_MMA = 2.0 ** -18      # one bf16 mma's fp32 accumulation, over |C| + Σ|p|
MMA_K = 16               # rows of one bf16 mma k-step


def fused_kslices(B: int) -> int:
    """The kernel's gate/up group slices at B rows (weight_stream.cuh
    `A8<TT>::KW`: 4 at up to 8 rows, 2 at up to 32, else 1)."""
    return 4 if B <= 8 else 2 if B <= 32 else 1


def _slice_order_bound(terms, nslice):
    """u · Σ |partial sums| (and a second-order term) of the kernel's
    order over the last dim of terms (fp64, exact): nslice running sums
    of every nslice-th term, then their sum in slice order."""
    n = terms.shape[-1]
    tot = torch.zeros(terms.shape[:-1], dtype=torch.float64,
                      device=terms.device)
    run = None
    for s in range(nslice):
        cs = terms[..., s::nslice].cumsum(-1)
        if cs.shape[-1] == 0:
            continue
        tot += cs[..., 1:].abs().sum(-1)
        run = cs[..., -1] if run is None else run + cs[..., -1]
        if s:
            tot += run.abs()
    nu = (n + nslice) * U32
    return U32 * tot * (1 + 2 * nu) + nu * nu * terms.abs().sum(-1)


def fused_mlp_act(h, mgu, mgs):
    """The twin's fp32 activation [B, I] of `fused_mlp_w4` (before its
    bf16 rounding) and E_act [B, I] (fp64), the most by which the
    kernel's fp32 activation can differ from it (see above)."""
    G = mgs.shape[1]
    terms, s_a = _w4a8_terms(h, *_untile_gateup(mgu, mgs))
    twin = terms.sum(dim=1)                       # the twin's fp32 sums
    x = terms.double().transpose(1, 2)            # [B, 2I, G]
    exact = x.sum(-1)
    e_sum = ((twin.double() - exact).abs()
             + _slice_order_bound(x, fused_kslices(h.shape[0]))
             + G * 2.0 ** -53 * x.abs().sum(-1))
    gu = twin * s_a
    sa = s_a.double()
    e_gu = e_sum * sa * (1 + 2 * U32) + 2 * U32 * gu.double().abs() * (
        1 + 2 * U32)
    gate, up = gu.chunk(2, dim=-1)
    e_g, e_u = e_gu.chunk(2, dim=-1)
    act = gate / (1.0 + torch.exp(-gate)) * up
    g64, u64 = gate.double().abs(), up.double().abs()
    e_act = (1.1 * (u64 + e_u) * e_g + (g64 + e_g) * e_u
             + 20 * U32 * act.double().abs()) * (1 + 1e-3) + 1e-37
    return act, e_act


def fused_mlp_down_bound(act, e_act, mdw, mds, ti: int):
    """Per-output bound [B, D] (fp32) of |kernel − twin| for the fused
    MLP's down product, from the twin's fp32 activation act [B, I], its
    bound e_act [B, I] (fp64) and the down stream (mdw [Gd, gd/2, D],
    mds [Gd, 1, D]) in I-tiles of ti rows (see above)."""
    a64 = act.double()
    r = act.to(torch.bfloat16).double()
    lo32 = torch.nextafter((a64 - e_act).float(),
                           torch.tensor(-float("inf"), device=act.device))
    hi32 = torch.nextafter((a64 + e_act).float(),
                           torch.tensor(float("inf"), device=act.device))
    lo = lo32.to(torch.bfloat16).double()
    hi = hi32.to(torch.bfloat16).double()
    delta = torch.maximum(hi - r, r - lo)          # 0 away from a near tie
    wd = _w4a16_weight(mdw, mds, torch.bfloat16)
    wd64 = wd.double()
    flip = delta @ wd64.abs()
    exact = r @ wd64
    twin = (r.float() @ wd.float()).double()       # the twin's own sum
    B, I = act.shape
    D = wd.shape[1]
    ra = r.abs()
    err = torch.zeros((B, D), dtype=torch.float64, device=act.device)
    run = None
    for j in range(I // ti):
        x = r[:, j * ti:(j + 1) * ti].reshape(B, -1, MMA_K)
        xa = ra[:, j * ti:(j + 1) * ti].reshape(B, -1, MMA_K)
        w = wd64[j * ti:(j + 1) * ti].reshape(-1, MMA_K, D)
        step = torch.einsum("bck,ckd->bcd", x, w)          # each k-step
        step_abs = torch.einsum("bck,ckd->bcd", xa, w.abs())
        prev = step.cumsum(1) - step                        # C before it
        err += TC_MMA * (prev.abs() + step_abs).sum(1)
        tile = step.sum(1)
        if run is None:
            run = tile
        else:
            run = run + tile
            err += U32 * run.abs()
    n_add = I // MMA_K + I // ti
    err = err * (1 + 1e-3) + (TC_MMA + U32) * n_add * flip \
        + I * 2.0 ** -53 * (ra @ wd64.abs())
    return (flip + err + (twin - exact).abs()).float()


def fused_mlp_w4_bound(h, mgu, mgs, mdw, mds):
    """Per-output bound [B, D] of |fused_mlp_w4 − fused_mlp_w4_plain(
    compute_dtype=bf16)|, both with fp32 output, on the same inputs and
    device: `fused_mlp_act`, then `fused_mlp_down_bound`."""
    act, e_act = fused_mlp_act(h, mgu, mgs)
    ti = mgu.shape[1] // 2
    return fused_mlp_down_bound(act, e_act, mdw, mds, ti)


# ---------------------------------------------------------------------------
# The weight streamers' grid (csrc/weight_stream.cuh)
# ---------------------------------------------------------------------------

WEIGHT_TILE = 128    # output channels per block of the weight streamers
W8_GROUP = 128       # the W8A8 split unit: k bytes of one ring stage
# blocks of a streamer one SM holds at few rows (csrc/weight_stream.cuh
# `min_blocks`): the plan's default
_WEIGHT_BLOCKS_PER_SM = 3


def weight_plan(N: int, K: int, group: int, sm_count: int,
                blocks_per_sm: int = _WEIGHT_BLOCKS_PER_SM):
    """(tile, per, nsplit) of a weight streamer's grid of (column tile,
    K split) blocks: ceil(N / tile) column tiles, and the G = ceil(K /
    group) groups of K split into nsplit runs of `per` groups (the last
    one shorter where per does not divide G), so that every split starts
    and ends on a group boundary (W4: a scale group; W8: W8_GROUP); split
    s takes k in [s·per·group, min((s+1)·per·group, K)). The most splits
    whose blocks the card holds at once (sm_count · blocks_per_sm, the
    kernel's occupancy): one wave, with no tail of late blocks."""
    tiles = -(-N // WEIGHT_TILE)
    G = -(-K // group)
    most = max(1, sm_count * blocks_per_sm // tiles)
    per = -(-G // min(G, most))
    return WEIGHT_TILE, per, -(-G // per)


_stream_bufs: dict = {}


def _stream_buffers(name: str, dev, tiles: int, nscratch: int):
    """The weight streamer `name`'s per-device (tickets, part): int32
    zeros, one a column tile (the last block of a tile resets its own),
    and a 4-byte scratch for the splits' partial sums (int32, read as fp32
    by the W4 streamers). Kept across
    launches and grown outside any CUDA graph capture; a buffer once
    handed out is never freed, since a captured graph keeps its address:
    a larger one is added beside it, and the newest serves later
    launches."""
    key = (name, torch.cuda._get_device_index(dev, optional=True))
    kept = _stream_bufs.setdefault(key, [])
    if not kept or kept[-1][0].numel() < tiles \
            or kept[-1][1].numel() < nscratch:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: the split scratch must hold "
                               f"{tiles} tickets and {nscratch} partials "
                               "before a capture; launch once outside it "
                               "first")
        old = kept[-1] if kept else None
        t = max(tiles, 2 * old[0].numel() if old else 1024)
        n = max(nscratch, 2 * old[1].numel() if old else 1 << 20)
        kept.append((torch.zeros(t, dtype=torch.int32, device=dev),
                     torch.empty(n, dtype=torch.int32, device=dev)))
    return kept[-1]


_resident: dict = {}


# each weight streamer's occupancy entry point in the kernel library:
# (rows, [group,] kernel, shared bytes, blocks an SM)
_OCCUPANCY = {"w8a8_matmul": ("aurora_w8a8_kernel", False),
              "w4a16_matmul": ("aurora_w4a16_kernel", True),
              "w4a8_matmul_tiled": ("aurora_w4a8_kernel", True),
              "w4a8_matmul": ("aurora_w4a8_flat_kernel", True)}


def _blocks_per_sm(name: str, B: int, group: int) -> int:
    """Blocks of the streamer `name` at B rows that one SM holds (its
    registers and shared bytes, from the CUDA occupancy API), cached.
    Raises on a name that is not a weight streamer."""
    if name not in _OCCUPANCY:
        raise ValueError(f"{name!r} is not a weight streamer (one of "
                         f"{sorted(_OCCUPANCY)})")
    key = (name, B, group)
    if key not in _resident:
        import ctypes
        from aurora_tpu_torch.ops.cuda_build import load_library
        entry, grouped = _OCCUPANCY[name]
        fn, smem, blocks = ctypes.c_void_p(), ctypes.c_int(), ctypes.c_int()
        args = (B, group) if grouped else (B,)
        err = getattr(load_library(), entry)(
            *args, ctypes.byref(fn), ctypes.byref(smem),
            ctypes.byref(blocks))
        _launch(name, err)
        _resident[key] = max(1, blocks.value)
    return _resident[key]


def _stream_grid(name, dev, B, N, K, group):
    """(span, nsplit, part pointer, tickets pointer) of one launch."""
    from aurora_tpu_torch.ops.pallas.ragged_attention import _sm_count
    tile, per, nsplit = weight_plan(N, K, group, _sm_count(dev),
                                    _blocks_per_sm(name, B, group))
    if nsplit == 1:
        return per * group, 1, None, None
    tickets, part = _stream_buffers(name, dev, -(-N // tile),
                                    nsplit * B * N)
    return per * group, nsplit, part.data_ptr(), tickets.data_ptr()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name, h, tensors, out_dtype):
    """The checks every W4 kernel makes: one device, contiguous,
    16-byte aligned operands, the element types it takes, 1..64 rows."""
    for label, t, dtype in tensors:
        if t.device != h.device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected "
                             f"{h.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got "
                            f"{t.dtype}")
    for label, dtype in (("h", h.dtype), ("out_dtype", out_dtype)):
        if dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name}: {label} must be bfloat16 or float32, "
                            f"got {dtype}")
    if not 0 < h.shape[0] <= MAX_TOKENS:
        raise ValueError(f"{name}: the CUDA kernel takes 1..{MAX_TOKENS} "
                         f"rows, got {h.shape[0]}")


def _flat_shapes(name, h, pk, s_w):
    """(B, K, N, G) of h [B, K] against flat W4 [G, g/2, N] + [G, 1, N]."""
    if h.dim() != 2 or pk.dim() != 3 or s_w.shape != (pk.shape[0], 1,
                                                      pk.shape[2]) \
            or 2 * pk.shape[0] * pk.shape[1] != h.shape[1]:
        raise ValueError(f"{name}: shapes h {tuple(h.shape)}, packed "
                         f"{tuple(pk.shape)}, scale {tuple(s_w.shape)} do "
                         f"not match")
    return h.shape[0], h.shape[1], pk.shape[2], pk.shape[0]


def _w4a8_group(name, K, G):
    """The group of K/G rows the W4A8 streamer takes: 32·2^i (its units
    are whole int8 mma k-steps of 32 k, its groups a power of two)."""
    group = K // G if G and K % G == 0 else 0
    if K % 32 or group < 32 or group & (group - 1):
        raise ValueError(f"{name}: the CUDA kernel takes K % 32 == 0 and "
                         f"groups of 32·2^i rows; got K={K}, G={G}")
    return group


def _launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def _act_scratch(h):
    """One int8 scratch for the activation quantizer (one allocation: each
    costs the host more than a kernel launch): the even and odd int8
    planes [B, K/2] each, then the fp32 scales [B] → (the scratch tensor,
    even, odd, scales addresses); K % 8 == 0 keeps each part aligned."""
    B, K = h.shape
    scratch = torch.empty((B * K + 4 * B,), dtype=torch.int8,
                          device=h.device)
    base = scratch.data_ptr()
    return scratch, base, base + B * K // 2, base + B * K


def w4a8_matmul_tiled(h, packed, scale, *, out_dtype=None):
    """[B, K] float × W4 (packed [N, K/2] int8, scale [N, G] fp32) →
    [B, N] in out_dtype (default h's dtype).

    Per-token int8 activations (quantize_activations), int32 partial sums
    per K-group, group scales applied in fp32, the activation scale last
    (the reference's exact _w4dot numerics). B ≤ 64 and groups of
    32·2^i rows on the card, where the kernel streams the weights once
    for all rows; its launches on one device must not overlap (the
    module's docstring)."""
    if h.dim() != 2 or packed.dim() != 2 or scale.dim() != 2 \
            or packed.shape != (scale.shape[0], h.shape[1] // 2) \
            or h.shape[1] % 2:
        raise ValueError(f"w4a8_matmul_tiled: shapes h {tuple(h.shape)}, "
                         f"packed {tuple(packed.shape)}, scale "
                         f"{tuple(scale.shape)} do not match")
    out_dtype = out_dtype or h.dtype
    if h.device.type == "cpu":
        return w4a8_matmul_tiled_plain(h, packed, scale, out_dtype=out_dtype)
    if h.device.type != "cuda":
        raise ValueError(f"w4a8_matmul_tiled: unsupported device {h.device}")
    name = "w4a8_matmul_tiled"
    _check_cuda(name, h, (("h", h, None), ("packed", packed, torch.int8),
                          ("scale", scale, torch.float32)), out_dtype)
    B, K = h.shape
    N, G = scale.shape
    group = _w4a8_group(name, K, G)
    scratch, he, ho, s_a = _act_scratch(h)
    out = torch.empty((B, N), dtype=out_dtype, device=h.device)
    span, nsplit, part, tickets = _stream_grid(name, h.device, B, N, K,
                                               group)
    from aurora_tpu_torch.ops.cuda_build import load_library
    _launch(name, load_library().aurora_w4a8_matmul(
        h.data_ptr(), packed.data_ptr(), scale.data_ptr(), he, ho, s_a,
        out.data_ptr(), part, tickets, B, K, N, G, span, nsplit,
        int(h.dtype == torch.float32), int(out_dtype == torch.float32),
        torch.cuda.current_stream(h.device).cuda_stream))
    w4a8_matmul_tiled.launches += 1
    return out


w4a8_matmul_tiled.launches = 0


def quantize_rows(h):
    """`quantize_activations` of h [B, K] (bf16 or fp32) → (h8 int8
    [B, K], s_a fp32 [B, 1]), bit for bit, in one kernel launch on the
    card (csrc/w4_common.cuh `quantize_rows`, contiguous layout) instead
    of ~8 elementwise launches; CPU tensors take quantize_activations
    itself."""
    name = "quantize_rows"
    if h.dim() != 2 or h.shape[0] == 0:
        raise ValueError(f"{name}: h must be [B, K] with B > 0, got "
                         f"{tuple(h.shape)}")
    if h.device.type == "cpu":
        return quantize_activations(h)
    if h.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {h.device}")
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: h must be bfloat16 or float32, got "
                        f"{h.dtype}")
    if not h.is_contiguous():
        raise ValueError(f"{name}: h must be contiguous")
    B, K = h.shape
    h8 = torch.empty((B, K), dtype=torch.int8, device=h.device)
    s_a = torch.empty((B, 1), dtype=torch.float32, device=h.device)
    from aurora_tpu_torch.ops.cuda_build import load_library
    _launch(name, load_library().aurora_quantize_rows(
        h.data_ptr(), h8.data_ptr(), s_a.data_ptr(), B, K,
        int(h.dtype == torch.float32),
        torch.cuda.current_stream(h.device).cuda_stream))
    quantize_rows.launches += 1
    return h8, s_a


quantize_rows.launches = 0


def w8a8_matmul(h8, s_a, w8, s_w, *, out_dtype=torch.bfloat16):
    """[B, K] int8 × W8 (weight [N, K] int8, s_w [N] fp32) → [B, N] in
    out_dtype: the int32 product times the per-token activation scale s_a
    [B, 1] fp32, then the weight scale (the reference's `w8a8_matmul`
    with the weight in the nn.Linear layout). B ≤ 64 on the card, where
    the kernel streams the weights once for all rows; its launches on
    one device must not overlap (the module's docstring)."""
    name = "w8a8_matmul"
    if h8.dim() != 2 or w8.dim() != 2 or h8.shape[1] != w8.shape[1] \
            or s_a.shape != (h8.shape[0], 1) or s_w.numel() != w8.shape[0]:
        raise ValueError(f"{name}: shapes h8 {tuple(h8.shape)}, s_a "
                         f"{tuple(s_a.shape)}, w8 {tuple(w8.shape)}, s_w "
                         f"{tuple(s_w.shape)} do not match")
    if h8.device.type == "cpu":
        return w8a8_matmul_plain(h8, s_a, w8, s_w, out_dtype=out_dtype)
    if h8.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {h8.device}")
    for label, t, dtype in (("h8", h8, torch.int8), ("s_a", s_a,
                                                     torch.float32),
                            ("w8", w8, torch.int8),
                            ("s_w", s_w, torch.float32)):
        if t.device != h8.device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected "
                             f"{h8.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.dtype == torch.int8 and t.data_ptr() % 16:   # 16-byte loads
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got "
                            f"{t.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    B, K = h8.shape
    N = w8.shape[0]
    if not 0 < B <= MAX_TOKENS or K % 16:
        raise ValueError(f"{name}: the CUDA kernel takes 1..{MAX_TOKENS} "
                         f"rows and K % 16 == 0; got B={B}, K={K}")
    out = torch.empty((B, N), dtype=out_dtype, device=h8.device)
    span, nsplit, part, tickets = _stream_grid(name, h8.device, B, N, K,
                                               W8_GROUP)
    from aurora_tpu_torch.ops.cuda_build import load_library
    _launch(name, load_library().aurora_w8a8_matmul(
        h8.data_ptr(), s_a.data_ptr(), w8.data_ptr(), s_w.data_ptr(),
        out.data_ptr(), part, tickets, B, K, N, span, nsplit,
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(h8.device).cuda_stream))
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def w4a8_matmul(h, pk, s_w, *, out_dtype=None):
    """[B, K] float × flat W4 (packed [G, g/2, N] int8, scales [G, 1, N]
    fp32, the reference's layout) → [B, N] in out_dtype (default h's):
    the reference's `w4a8_matmul`, i.e. the W4A8 recipe of
    `w4a8_matmul_tiled` on K-major bytes. B ≤ 64, N % 4 == 0 and groups
    of 32·2^i rows on the card, where the kernel streams the weights once
    for all rows; its launches on one device must not overlap (the
    module's docstring)."""
    name = "w4a8_matmul"
    B, K, N, G = _flat_shapes(name, h, pk, s_w)
    out_dtype = out_dtype or h.dtype
    if h.device.type == "cpu":
        return w4a8_matmul_plain(h, pk, s_w, out_dtype=out_dtype)
    if h.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {h.device}")
    _check_cuda(name, h, (("h", h, None), ("packed", pk, torch.int8),
                          ("scale", s_w, torch.float32)), out_dtype)
    group = _w4a8_group(name, K, G)
    if N % 4:
        raise ValueError(f"{name}: the CUDA kernel takes N % 4 == 0; got "
                         f"N={N}")
    scratch, he, ho, s_a = _act_scratch(h)
    out = torch.empty((B, N), dtype=out_dtype, device=h.device)
    span, nsplit, part, tickets = _stream_grid(name, h.device, B, N, K,
                                               group)
    from aurora_tpu_torch.ops.cuda_build import load_library
    _launch(name, load_library().aurora_w4a8_flat_matmul(
        h.data_ptr(), pk.data_ptr(), s_w.data_ptr(), he, ho, s_a,
        out.data_ptr(), part, tickets, B, K, N, G, span, nsplit,
        int(h.dtype == torch.float32), int(out_dtype == torch.float32),
        torch.cuda.current_stream(h.device).cuda_stream))
    w4a8_matmul.launches += 1
    return out


w4a8_matmul.launches = 0


def w4a16_matmul(h, pk, s_w, *, out_dtype=None):
    """[B, K] float (rounded to bf16) × flat W4 → [B, N] in out_dtype
    (default h's): the reference's `w4a16_matmul`, weights dequantized as
    bf16(bf16(q) · bf16(s)), fp32 accumulation. B ≤ 64 and groups of a
    multiple of 16 rows on the card, where the kernel streams the weights
    once for all rows; its launches on one device must not overlap (the
    module's docstring)."""
    name = "w4a16_matmul"
    B, K, N, G = _flat_shapes(name, h, pk, s_w)
    out_dtype = out_dtype or h.dtype
    if h.device.type == "cpu":
        return w4a16_matmul_plain(h, pk, s_w, out_dtype=out_dtype)
    if h.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {h.device}")
    _check_cuda(name, h, (("h", h, None), ("packed", pk, torch.int8),
                          ("scale", s_w, torch.float32)), out_dtype)
    if N % 4 or (2 * pk.shape[1]) % 16:
        raise ValueError(f"{name}: the CUDA kernel takes N % 4 == 0 and "
                         f"groups of a multiple of 16 rows; got N={N}, "
                         f"group={2 * pk.shape[1]}")
    out = torch.empty((B, N), dtype=out_dtype, device=h.device)
    span, nsplit, part, tickets = _stream_grid(name, h.device, B, N, K,
                                               K // G)
    from aurora_tpu_torch.ops.cuda_build import load_library
    _launch(name, load_library().aurora_w4a16_matmul(
        h.data_ptr(), pk.data_ptr(), s_w.data_ptr(), out.data_ptr(), part,
        tickets, B, K, N, G, span, nsplit, int(h.dtype == torch.float32),
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(h.device).cuda_stream))
    w4a16_matmul.launches += 1
    return out


w4a16_matmul.launches = 0


def fused_mlp_grid(B: int, mgu, mgs, mdw):
    """(cluster size C, channels a block) that `fused_mlp_w4`'s tile
    kernel takes on the card for B rows of this fused MLP: I/ti clusters
    of C blocks (csrc/fused_mlp_w4.cu `plan_tile`)."""
    import ctypes
    from aurora_tpu_torch.ops.cuda_build import load_library
    Ib, ti2, D2 = mgu.shape
    G, (Gd, ghd, _) = mgs.shape[1], mdw.shape
    C, CB = ctypes.c_int(), ctypes.c_int()
    _launch("fused_mlp_w4", load_library().aurora_fused_mlp_cluster(
        B, 2 * D2, ti2 // 2, Ib, 2 * D2 // G, 2 * ghd, ctypes.byref(C),
        ctypes.byref(CB)))
    return C.value, CB.value


def fused_mlp_w4(h, mgu, mgs, mdw, mds, *, out_dtype=None):
    """silu(h @ Wg) · (h @ Wu) @ Wd over the fused-MLP layout
    (`w4_mlp_tile_layout`): h [B, D] float → [B, D] in out_dtype (default
    h's). Gate/up by the W4A8 recipe kept in fp32, silu·mul in fp32, the
    activation in bf16, the down projection W4A16 (`fused_mlp_w4_plain`).
    CPU tensors compute in fp32, as the reference's interpret mode does;
    the card's kernel in bf16, as the reference's chip kernel, within
    `fused_mlp_w4_bound` of its bf16 twin. B ≤ 64 on the card."""
    name = "fused_mlp_w4"
    Ib, ti2, D2 = mgu.shape
    G, (Gd, ghd, D) = mgs.shape[1], mdw.shape
    if h.dim() != 2 or h.shape[1] != 2 * D2 or D != 2 * D2 \
            or mgs.shape != (Ib, G, ti2) or D2 % G or ti2 % 16 \
            or mds.shape != (Gd, 1, D) or 2 * Gd * ghd != Ib * ti2 // 2:
        raise ValueError(f"{name}: shapes h {tuple(h.shape)}, mgu "
                         f"{tuple(mgu.shape)}, mgs {tuple(mgs.shape)}, mdw "
                         f"{tuple(mdw.shape)}, mds {tuple(mds.shape)} do "
                         f"not match")
    out_dtype = out_dtype or h.dtype
    if h.device.type == "cpu":
        return fused_mlp_w4_plain(h, mgu, mgs, mdw, mds, out_dtype=out_dtype,
                                  compute_dtype=torch.float32)
    if h.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {h.device}")
    _check_cuda(name, h, (("h", h, None), ("mgu", mgu, torch.int8),
                          ("mgs", mgs, torch.float32),
                          ("mdw", mdw, torch.int8),
                          ("mds", mds, torch.float32)), out_dtype)
    ti, group, gd = ti2 // 2, D // G, 2 * ghd
    if ti not in MLP_TILES or D % 32 or group < 32 or group & (group - 1) \
            or ti % gd or gd % 16:
        raise ValueError(f"{name}: the CUDA kernel takes I-tiles of "
                         f"{MLP_TILES}, D % 32 == 0, gate/up groups of "
                         f"32·2^i rows and down groups of a multiple of 16 "
                         f"dividing the tile; got tile {ti}, D={D}, gate/up "
                         f"group {group}, down group {gd}")
    B = h.shape[0]
    scratch, he, ho, s_a = _act_scratch(h)
    part = torch.empty((Ib, B, D), dtype=torch.float32, device=h.device)
    out = torch.empty((B, D), dtype=out_dtype, device=h.device)
    from aurora_tpu_torch.ops.cuda_build import load_library
    _launch(name, load_library().aurora_fused_mlp_w4(
        h.data_ptr(), mgu.data_ptr(), mgs.data_ptr(), mdw.data_ptr(),
        mds.data_ptr(), he, ho, s_a, part.data_ptr(), out.data_ptr(), B, D,
        Ib * ti, G, Gd, ti, int(h.dtype == torch.float32),
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(h.device).cuda_stream))
    fused_mlp_w4.launches += 1
    return out


fused_mlp_w4.launches = 0
