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
(`w4_mlp_tile_layout`: gate/up tiles of MLP_TILE intermediate columns
beside the flat down stream) for `EngineConfig(w4_fused_mlp=True)`.

The W8 layout is the nn.Linear one: weight [N, K] int8, one fp32 scale
per output channel [N].

Each kernel wrapper takes its plain PyTorch twin (`*_plain`) for CPU
tensors and launches its CUDA kernel for CUDA tensors
(csrc/w4a8_matmul.cu, csrc/w4_flat_matmul.cu, csrc/fused_mlp_w4.cu,
csrc/w8a8_matmul.cu; the W4A8 ones and the fused MLP also quantize the
activations on the card); it never falls back from one to the other.
`.launches` and `_plain.calls` count each path.
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
# w4_mlp_tile_layout / w4_mlp_untile_layout, with the port's own I-tile)
# ---------------------------------------------------------------------------

MLP_TILE = 64        # intermediate columns per block of the fused-MLP kernel


def w4_mlp_tile_layout(gu_pk, gu_s, dn_pk, dn_s, ti: int = MLP_TILE):
    """Flat W4 gateup ([G, g/2, 2I] packed, [G, 1, 2I] scales; gate
    columns then up columns) and down ([Gd, gd/2, D], [Gd, 1, D]) →
    the fused-MLP layout:

      mgu [Ib, D/2, 2ti] int8   tile j = gate cols of tile j ‖ up cols
      mgs [Ib, G,   2ti] fp32
      mdw [Gd, gd/2, D]  int8   the flat down stream as it is: tile j
      mds [Gd, 1,    D]  fp32   is its packed rows [j·ti/2, (j+1)·ti/2)

    so that each block of the kernel reads one contiguous gate/up tile.
    Unlike the reference (ti of 128 or 256, a multiple of the down group)
    ti divides the down group, so a tile's down rows share one scale row."""
    G, gh, I2 = gu_pk.shape
    I, D2 = I2 // 2, G * gh
    Ib = I // ti
    mgu = (gu_pk.reshape(D2, 2, Ib, ti).permute(2, 0, 1, 3)
           .reshape(Ib, D2, 2 * ti).contiguous())
    mgs = (gu_s.float().reshape(G, 2, Ib, ti).permute(2, 0, 1, 3)
           .reshape(Ib, G, 2 * ti).contiguous())
    return mgu, mgs, dn_pk.contiguous(), dn_s.float().contiguous()


def w4_mlp_untile_layout(mgu, mgs, mdw, mds):
    """Inverse of `w4_mlp_tile_layout` → flat (gu_pk, gu_s, dn_pk, dn_s)
    for the paths that want the two projections (prefill). It also
    untiles the reference's layout (any ti; its down stream as tiles, mdw
    [Ib, ti/2, D] and mds [Ib, ti/group, D]): both down layouts reshape
    to the flat [Gd, group/2, D]."""
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

def _w4a8_fp32(h, pk, s_w):
    """The W4A8 recipe in fp32 on the flat layout (pk [G, g/2, N], s_w
    [G, 1, N]): h [B, K] → [B, N] fp32. Each group's int32 partial is at
    most 127·8·g < 2^24 in magnitude, so fp32 products of the unpacked
    planes give it exactly (with TF32 off on the card); the group sum then
    runs in fp32, and the activation scale comes last."""
    B = h.shape[0]
    G, gh, N = pk.shape
    h8, s_a = quantize_activations(h)
    x = h8.float().reshape(B, G, gh, 2)
    lo, hi = w4_unpack(pk)
    part = (torch.einsum("bgj,gjn->bgn", x[..., 0], lo.float())
            + torch.einsum("bgj,gjn->bgn", x[..., 1], hi.float()))
    return (part * s_w.reshape(1, G, N)).sum(dim=1) * s_a


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


def _flat_kernel_shapes(name, pk, N):
    """The flat kernels read 4 columns and 4 packed rows at a time."""
    if N % 4 or pk.shape[1] % 4:
        raise ValueError(f"{name}: the CUDA kernel takes N % 4 == 0 and "
                         f"groups of a multiple of 8 rows; got N={N}, "
                         f"group={2 * pk.shape[1]}")


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
    (the reference's exact _w4dot numerics). B ≤ 64 on the card."""
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
    cpg = (K // 32) // G if G else 0
    if K % 32 or G <= 0 or (K // 32) % G or cpg > 32 or cpg & (cpg - 1):
        raise ValueError(f"{name}: the CUDA kernel takes K % 32 == 0 and "
                         f"groups of 32·2^i (≤ 1024) rows; got K={K}, "
                         f"G={G}")
    scratch, he, ho, s_a = _act_scratch(h)
    out = torch.empty((B, N), dtype=out_dtype, device=h.device)
    from aurora_tpu_torch.ops.cuda_build import load_library
    _launch(name, load_library().aurora_w4a8_matmul(
        h.data_ptr(), packed.data_ptr(), scale.data_ptr(), he, ho, s_a,
        out.data_ptr(), B, K, N, G, int(h.dtype == torch.float32),
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(h.device).cuda_stream))
    w4a8_matmul_tiled.launches += 1
    return out


w4a8_matmul_tiled.launches = 0


def w8a8_matmul(h8, s_a, w8, s_w, *, out_dtype=torch.bfloat16):
    """[B, K] int8 × W8 (weight [N, K] int8, s_w [N] fp32) → [B, N] in
    out_dtype: the int32 product times the per-token activation scale s_a
    [B, 1] fp32, then the weight scale (the reference's `w8a8_matmul`
    with the weight in the nn.Linear layout). B ≤ 64 on the card."""
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
    from aurora_tpu_torch.ops.cuda_build import load_library
    err = load_library().aurora_w8a8_matmul(
        h8.data_ptr(), s_a.data_ptr(), w8.data_ptr(), s_w.data_ptr(),
        out.data_ptr(), B, K, N, int(out_dtype == torch.float32),
        torch.cuda.current_stream(h8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def w4a8_matmul(h, pk, s_w, *, out_dtype=None):
    """[B, K] float × flat W4 (packed [G, g/2, N] int8, scales [G, 1, N]
    fp32, the reference's layout) → [B, N] in out_dtype (default h's):
    the reference's `w4a8_matmul`, i.e. the W4A8 recipe of
    `w4a8_matmul_tiled` on K-major bytes. B ≤ 64 on the card."""
    name = "w4a8_matmul"
    B, K, N, G = _flat_shapes(name, h, pk, s_w)
    out_dtype = out_dtype or h.dtype
    if h.device.type == "cpu":
        return w4a8_matmul_plain(h, pk, s_w, out_dtype=out_dtype)
    if h.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {h.device}")
    _check_cuda(name, h, (("h", h, None), ("packed", pk, torch.int8),
                          ("scale", s_w, torch.float32)), out_dtype)
    _flat_kernel_shapes(name, pk, N)
    scratch, he, ho, s_a = _act_scratch(h)
    out = torch.empty((B, N), dtype=out_dtype, device=h.device)
    from aurora_tpu_torch.ops.cuda_build import load_library
    _launch(name, load_library().aurora_w4a8_flat_matmul(
        h.data_ptr(), pk.data_ptr(), s_w.data_ptr(), he, ho, s_a,
        out.data_ptr(), B, K, N, G, int(h.dtype == torch.float32),
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(h.device).cuda_stream))
    w4a8_matmul.launches += 1
    return out


w4a8_matmul.launches = 0


def w4a16_matmul(h, pk, s_w, *, out_dtype=None):
    """[B, K] float (rounded to bf16) × flat W4 → [B, N] in out_dtype
    (default h's): the reference's `w4a16_matmul`, weights dequantized as
    bf16(bf16(q) · bf16(s)), fp32 accumulation. B ≤ 64 on the card."""
    name = "w4a16_matmul"
    B, K, N, G = _flat_shapes(name, h, pk, s_w)
    out_dtype = out_dtype or h.dtype
    if h.device.type == "cpu":
        return w4a16_matmul_plain(h, pk, s_w, out_dtype=out_dtype)
    if h.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {h.device}")
    _check_cuda(name, h, (("h", h, None), ("packed", pk, torch.int8),
                          ("scale", s_w, torch.float32)), out_dtype)
    _flat_kernel_shapes(name, pk, N)
    out = torch.empty((B, N), dtype=out_dtype, device=h.device)
    from aurora_tpu_torch.ops.cuda_build import load_library
    _launch(name, load_library().aurora_w4a16_matmul(
        h.data_ptr(), pk.data_ptr(), s_w.data_ptr(), out.data_ptr(), B, K,
        N, G, int(h.dtype == torch.float32), int(out_dtype == torch.float32),
        torch.cuda.current_stream(h.device).cuda_stream))
    w4a16_matmul.launches += 1
    return out


w4a16_matmul.launches = 0


def fused_mlp_w4(h, mgu, mgs, mdw, mds, *, out_dtype=None):
    """silu(h @ Wg) · (h @ Wu) @ Wd over the fused-MLP layout
    (`w4_mlp_tile_layout`): h [B, D] float → [B, D] in out_dtype (default
    h's). Gate/up by the W4A8 recipe kept in fp32, silu·mul in fp32, the
    activation in bf16, the down projection W4A16 (`fused_mlp_w4_plain`).
    CPU tensors compute in fp32, as the reference's interpret mode does;
    the card's kernel in bf16, as the reference's chip kernel. B ≤ 64 on
    the card."""
    name = "fused_mlp_w4"
    Ib, D2, ti2 = mgu.shape
    G, (Gd, ghd, D) = mgs.shape[1], mdw.shape
    if h.dim() != 2 or h.shape[1] != 2 * D2 or D != 2 * D2 \
            or mgs.shape != (Ib, G, ti2) or D2 % G \
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
    if ti2 != 2 * MLP_TILE or (2 * ghd) % MLP_TILE or (D2 // G) % 4 \
            or D % 4:
        raise ValueError(f"{name}: the CUDA kernel takes I-tiles of "
                         f"{MLP_TILE}, a down group that is a multiple of "
                         f"{MLP_TILE}, gate/up groups of a multiple of 8 "
                         f"rows and D % 4 == 0; got tile {ti2 // 2}, down "
                         f"group {2 * ghd}, gate/up group {2 * D2 // G}, "
                         f"D={D}")
    B = h.shape[0]
    scratch, he, ho, s_a = _act_scratch(h)
    part = torch.empty((Ib, B, D), dtype=torch.float32, device=h.device)
    out = torch.empty((B, D), dtype=out_dtype, device=h.device)
    from aurora_tpu_torch.ops.cuda_build import load_library
    _launch(name, load_library().aurora_fused_mlp_w4(
        h.data_ptr(), mgu.data_ptr(), mgs.data_ptr(), mdw.data_ptr(),
        mds.data_ptr(), he, ho, s_a, part.data_ptr(), out.data_ptr(), B, D,
        Ib * MLP_TILE, G, Gd, int(h.dtype == torch.float32),
        int(out_dtype == torch.float32),
        torch.cuda.current_stream(h.device).cuda_stream))
    fused_mlp_w4.launches += 1
    return out


fused_mlp_w4.launches = 0
