"""Quantized decode matmuls: W4A8 over nibble-packed int4 weights
(aurora_tpu/ops/pallas/quant_matmul.py `w4a8_matmul_tiled`) and W8A8 over
int8 weights (`w8a8_matmul`).

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

The W8 layout is the nn.Linear one: weight [N, K] int8, one fp32 scale
per output channel [N].

`w4a8_matmul_tiled` and `w8a8_matmul` take their plain PyTorch twins
(`*_plain`) for CPU tensors and launch their CUDA kernels
(csrc/w4a8_matmul.cu, which also quantizes the activations, and
csrc/w8a8_matmul.cu) for CUDA tensors; they never fall back from one to
the other. `.launches` and `_plain.calls` count each path.
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


# ---------------------------------------------------------------------------
# Plain twin (the contract; CPU path and the card's reference)
# ---------------------------------------------------------------------------

def w4a8_matmul_tiled_plain(h, packed, scale, *, out_dtype=None):
    """fp32 reference of `w4a8_matmul_tiled`. Each group's int32 partial
    is at most 127·8·(K/G) < 2^24 in magnitude, so fp32 products of the
    unpacked planes give it exactly (with TF32 off on the card); the group
    sum then runs in fp32."""
    w4a8_matmul_tiled_plain.calls += 1
    B, K = h.shape
    N, G = scale.shape
    h8, s_a = quantize_activations(h)
    x = h8.float().reshape(B, G, -1, 2)
    lo, hi = w4_unpack(packed)
    lo = lo.float().reshape(N, G, -1)
    hi = hi.float().reshape(N, G, -1)
    part = (torch.einsum("bgj,ngj->bgn", x[..., 0], lo)
            + torch.einsum("bgj,ngj->bgn", x[..., 1], hi))
    out = (part * scale.t()[None]).sum(dim=1) * s_a
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


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check_w4_cuda(h, packed, scale, out_dtype):
    name = "w4a8_matmul_tiled"
    for label, t in (("h", h), ("packed", packed), ("scale", scale)):
        if t.device != h.device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected "
                             f"{h.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: h must be bfloat16 or float32, got "
                        f"{h.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: out_dtype must be bfloat16 or float32, "
                        f"got {out_dtype}")
    if packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: packed must be int8 and scale float32")
    B, K = h.shape
    N, G = scale.shape
    if not 0 < B <= MAX_TOKENS:
        raise ValueError(f"{name}: the CUDA kernel takes 1..{MAX_TOKENS} "
                         f"rows, got {B}")
    cpg = (K // 32) // G if G else 0
    if K % 32 or G <= 0 or (K // 32) % G or cpg > 32 or cpg & (cpg - 1):
        raise ValueError(f"{name}: the CUDA kernel takes K % 32 == 0 and "
                         f"groups of 32·2^i (≤ 1024) rows; got K={K}, "
                         f"G={G}")


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
    _check_w4_cuda(h, packed, scale, out_dtype)
    B, K = h.shape
    N, G = scale.shape
    # one scratch allocation (each costs the host more than the kernel
    # launch): the even and odd int8 activation planes [B, K/2] each, then
    # the fp32 activation scales [B]; K % 32 == 0 keeps every part 16-byte
    # aligned
    scratch = torch.empty((B * K + 4 * B,), dtype=torch.int8,
                          device=h.device)
    base = scratch.data_ptr()
    out = torch.empty((B, N), dtype=out_dtype, device=h.device)
    from aurora_tpu_torch.ops.cuda_build import load_library
    err = load_library().aurora_w4a8_matmul(
        h.data_ptr(), packed.data_ptr(), scale.data_ptr(), base,
        base + B * K // 2, base + B * K, out.data_ptr(), B, K, N, G,
        int(h.dtype == torch.float32), int(out_dtype == torch.float32),
        torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w4a8_matmul_tiled: CUDA launch failed "
                           f"(cudaError {err})")
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
