"""Ragged attention over row-contiguous KV buffers — the serving engine's
two attention kernels (aurora_tpu/ops/pallas/ragged_attention.py).

KV lives in head-major rows [L, B, Hkv, S, hd]: each request owns one row
per layer. The layer, the row of each lane, its query offset and its KV
length are device int32 tensors that the kernels read themselves. Rows are
bf16 (the activation dtype on the CPU), or int8 with per-token fp32 scale
planes [L, B, Hkv, S] (`k_scales`/`v_scales`, the reference's `quant`
mode): the logits are scaled by the key's scale, the probabilities by the
value's scale. With `kv_pack` the int8 rows hold nibble-packed int4 values
[L, B, Hkv, S/2, hd] (two tokens a byte, the PACK_SEG pairing below, grid
values in [-7, 7]) beside the same token-space scale planes.

* `ragged_attention` — EXTEND: causal attention of each lane's T new
  tokens (already written into its row) against the row.
* `ragged_decode_attention` — DECODE: write each lane's new K/V token at
  kv_lens-1 of its row in place (int8: quantized onto the `kv_quantize`
  grid; packed: its nibble merged into the byte it shares with its mate
  token), then attend over the row.

Each public function takes its plain PyTorch twin (`*_plain`) when the
tensors lie on the CPU, and launches its CUDA kernel
(csrc/ragged_extend.cu, csrc/ragged_decode.cu) for CUDA tensors; it never
falls back from one to the other. `*.launches` (bf16 kernels),
`*.launches_int8` (int8 kernels), `*.launches_int4` (packed int4 kernels)
and `*_plain.calls` (twins, any mode) count how often each path ran;
`*.launches_window` counts, beside them, the launches of any mode that ran
with a sliding window or a logit softcap. The decode kernel's split-KV
grid is planned on the host by `decode_plan`. Its splits merge through
one buffer of tickets per device, so decode launches on one device must
run one at a time: on one stream, or ordered between streams (two graph
replays that capture it included).

Both functions take the reference's two options. `window` w (Mistral's
sliding window; None or <= 0 disables it): a query at position p sees
only the keys in (p - w, p], and the kernels skip the key tiles wholly
below a query block's window. `logit_cap` c > 0 (Gemma2's attention
softcap): each score s becomes c * tanh(s / c), after the scale and the
int8 key scale and before the mask. The reference's `s / c` by a Python
constant compiles under jit to a multiply by the fp32 reciprocal, so the
port multiplies by fp32(1 / c) too.
"""

from __future__ import annotations

import numpy as np
import torch

_NEG_INF = -2.3819763e38
# nibble-packed int4 KV: token seg*256 + j (j < 128) sits in the low nibble
# and token seg*256 + j + 128 in the high nibble of packed row seg*128 + j
# (the reference's pairing, so that packed rows compare byte for byte)
PACK_SEG = 256


# the twin computes its fp32 logits in query blocks of at most this many
# elements (T 6144 against 7168 keys and 32 heads would be 5.6 GB a lane)
_PLAIN_LOGITS = 1 << 26


def _check_kv_options(k_scales, v_scales, kv_pack, logit_cap):
    if logit_cap < 0:
        raise ValueError(f"logit_cap must be >= 0, got {logit_cap}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales go together")
    if kv_pack and k_scales is None:
        raise ValueError("packed int4 KV (kv_pack) needs k_scales/v_scales")


def pack_int4_rows(q4: torch.Tensor) -> torch.Tensor:
    """Token-space grid values [..., S, hd] (int, each in [-7, 7]) →
    nibble-packed rows [..., S/2, hd] int8 with the PACK_SEG pairing."""
    *lead, S, hd = q4.shape
    if S % PACK_SEG:
        raise ValueError(f"S={S} is not a multiple of {PACK_SEG}")
    x = q4.to(torch.int32).reshape(*lead, S // PACK_SEG, 2, PACK_SEG // 2,
                                   hd)
    b = (x[..., 0, :, :] & 0xF) | ((x[..., 1, :, :] & 0xF) << 4)
    return b.to(torch.uint8).view(torch.int8).reshape(*lead, S // 2, hd)


def unpack_int4_rows(pk: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4_rows: [..., S/2, hd] → [..., S, hd] int8."""
    *lead, S2, hd = pk.shape
    half = PACK_SEG // 2
    if S2 % half:
        raise ValueError(f"{S2} packed rows are not a multiple of {half}")
    b = pk.to(torch.int32) & 0xFF
    lo = (((b & 0xF) ^ 8) - 8).reshape(*lead, S2 // half, half, hd)
    hi = (((b >> 4) ^ 8) - 8).reshape(*lead, S2 // half, half, hd)
    return torch.cat([lo, hi], dim=-2).reshape(*lead, 2 * S2, hd).to(
        torch.int8)


def packed_slot(pos):
    """(packed row, high nibble?) of token position(s) `pos` under the
    PACK_SEG pairing."""
    half = PACK_SEG // 2
    return (pos // PACK_SEG) * half + pos % half, pos % PACK_SEG >= half


def blend_nibbles(packed, new_lo, take_lo, new_hi, take_hi):
    """Packed bytes [n, ...] whose low / high nibbles become the low four
    bits of new_lo / new_hi ([n, ...] grid values) where take_lo / take_hi
    ([n] bool) are set, and stay as they are elsewhere."""
    b = packed.to(torch.int32) & 0xFF
    shape = (-1,) + (1,) * (b.dim() - 1)
    lo = torch.where(take_lo.reshape(shape), new_lo.to(torch.int32) & 0xF,
                     b & 0xF)
    hi = torch.where(take_hi.reshape(shape), new_hi.to(torch.int32) & 0xF,
                     b >> 4)
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def kv_quantize(x, maxq: float = 127.0):
    """[..., hd] → (int8 values, per-token fp32 scales [...]): the
    engine's `_kv_quantize`. The reference divides by the constant maxq
    under jit, which XLA compiles to a multiply by its fp32 reciprocal; the
    port does the same so that rows and scales agree bit for bit."""
    xf = x.float()
    inv = float(np.float32(1.0) / np.float32(maxq))
    s = xf.abs().amax(dim=-1).clamp_min(1e-8) * inv
    q = torch.clamp(torch.round(xf / s[..., None]), -maxq, maxq)
    return q.to(torch.int8), s


def _as_index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1)


def _window_width(window) -> int:
    """The sliding window as a Python int, 0 when it is off (None or
    <= 0, as in the reference)."""
    return 0 if window is None else max(int(window), 0)


def _inv_cap(logit_cap: float) -> float:
    """fp32(1) / fp32(c): what XLA multiplies by for the reference's
    division by the constant c."""
    return float(np.float32(1.0) / np.float32(logit_cap))


# ---------------------------------------------------------------------------
# The decode kernel's split-KV grid (csrc/ragged_decode.cu)
# ---------------------------------------------------------------------------

# the decode kernel's grid aims at no more than this many blocks an SM
# before it makes a split longer than one packing segment
_DECODE_BLOCKS_PER_SM = 4


def decode_plan(S: int, window: int, heads: int, sm_count: int):
    """(split, nsplit) of the decode kernel's grid of (split, KV head,
    lane) blocks, from what the host knows: S (token-space row width),
    the window (0: off), heads = lanes x KV heads and the SM count; never
    kv_lens, which lives on the device. A split is a multiple of PACK_SEG
    keys, so an int4 segment and its mate tokens stay in one block. The
    splits start at 0, or with a window at the segment of the lane's first
    visible key, so they must span min(S, window + PACK_SEG - 1) keys;
    splits of one segment each unless that gives more than
    _DECODE_BLOCKS_PER_SM blocks an SM."""
    span = S if window <= 0 else min(S, window + PACK_SEG - 1)
    segs = max(1, -(-span // PACK_SEG))
    per = max(1, segs * heads // (_DECODE_BLOCKS_PER_SM * sm_count))
    split = per * PACK_SEG
    return split, -(-max(span, 1) // split)


_sm_counts: dict = {}
_tickets: dict = {}


def _sm_count(dev) -> int:
    key = torch.cuda._get_device_index(dev, optional=True)
    if key not in _sm_counts:
        _sm_counts[key] = torch.cuda.get_device_properties(
            key).multi_processor_count
    return _sm_counts[key]


def _decode_tickets(dev, n: int) -> torch.Tensor:
    """The decode kernel's per-(lane, KV head) merge tickets: int32 zeros
    kept per device across launches (the merging block resets its own),
    grown outside any CUDA graph capture. A buffer once handed out is never
    freed, since a captured graph keeps its address: a larger one is added
    beside it, and the newest serves later launches."""
    key = torch.cuda._get_device_index(dev, optional=True)
    kept = _tickets.setdefault(key, [])
    if not kept or kept[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("ragged_decode_attention: the merge tickets "
                               f"must hold {n} entries before a capture; "
                               "launch once outside it first")
        size = max(n, 2 * kept[-1].numel() if kept else 4096)
        kept.append(torch.zeros(size, dtype=torch.int32, device=dev))
    return kept[-1]


# ---------------------------------------------------------------------------
# Plain twins (the contract; CPU path and the card's reference)
# ---------------------------------------------------------------------------

def _attend_plain(q, k_rows, v_rows, lens, offs, rows, lay, scale,
                  k_scales=None, v_scales=None, kv_pack=False, window=0,
                  logit_cap=0.0):
    Bk, T, Hq, hd = q.shape
    Hkv, S = k_rows.shape[2], k_rows.shape[3] * (2 if kv_pack else 1)
    G = Hq // Hkv
    if scale is None:
        scale = hd ** -0.5
    dev = q.device
    spos = torch.arange(S, device=dev)
    out = torch.empty_like(q)
    # one lane, and within it one block of queries, at a time bounds the
    # fp32 logits; softmax is per query row, so the blocks change nothing
    tb = max(1, _PLAIN_LOGITS // (Hq * S))
    inv_cap = _inv_cap(logit_cap) if logit_cap > 0 else 0.0
    for i in range(Bk):
        k, v = k_rows[lay, rows[i]], v_rows[lay, rows[i]]   # [Hkv, S, hd]
        if kv_pack:
            k, v = unpack_int4_rows(k), unpack_int4_rows(v)
        k, v = k.to(torch.float32), v.to(torch.float32)
        for t0 in range(0, T, tb):
            qi = q[i, t0:t0 + tb].to(torch.float32)
            n = qi.shape[0]
            qi = qi.reshape(n, Hkv, G, hd)
            logits = torch.einsum("thgd,hsd->hgts", qi * scale, k)
            if k_scales is not None:        # per-key dequant on the logits
                logits = logits * k_scales[lay, rows[i]][:, None, None, :]
            if logit_cap > 0:
                logits = logit_cap * torch.tanh(logits * inv_cap)
            qpos = offs[i] + t0 + torch.arange(n, device=dev)
            mask = ((spos[None, :] <= qpos[:, None])
                    & (spos[None, :] < lens[i]))
            if window > 0:
                mask &= spos[None, :] > qpos[:, None] - window
            logits = torch.where(mask, logits, _NEG_INF)
            probs = torch.where(mask, torch.softmax(logits, dim=-1), 0.0)
            if v_scales is not None:        # per-value dequant on p
                probs = probs * v_scales[lay, rows[i]][:, None, None, :]
            o = torch.einsum("hgts,hsd->thgd", probs, v)
            out[i, t0:t0 + n] = o.reshape(n, Hq, hd).to(q.dtype)
    return out


def ragged_attention_plain(q, k_rows, v_rows, kv_lens, q_offsets, row_ids,
                           *, layer, scale=None, window=None,
                           logit_cap: float = 0.0, k_scales=None,
                           v_scales=None, kv_pack=False):
    """fp32 reference of `ragged_attention` (ragged_attention_reference's
    twin, with the layer picked from the 5-D buffers; int8 rows with their
    [L, B, Hkv, S] scale planes as the reference's quant mode, packed int4
    rows unpacked first; the window and the cap as the module docstring
    says). Fully masked query rows and padded lanes (kv_len 0) give
    zeros."""
    ragged_attention_plain.calls += 1
    dev = q.device
    return _attend_plain(q, k_rows, v_rows,
                         _as_index(kv_lens, dev).long(),
                         _as_index(q_offsets, dev).long(),
                         _as_index(row_ids, dev).long(), int(layer), scale,
                         k_scales, v_scales, kv_pack, _window_width(window),
                         logit_cap)


ragged_attention_plain.calls = 0


def ragged_decode_attention_plain(q, k_new, v_new, k_rows, v_rows, kv_lens,
                                  row_ids, *, layer, scale=None,
                                  window=None, logit_cap: float = 0.0,
                                  k_scales=None, v_scales=None,
                                  kv_maxq: float = 127.0,
                                  kv_pack: bool = False):
    """Reference of `ragged_decode_attention`: in-place write of each
    active lane's token at kv_lens-1 (int8: its `kv_quantize` values and
    scales; packed: its nibble merged into the shared byte), then the
    extend reference with T = 1 at that position."""
    ragged_decode_attention_plain.calls += 1
    dev = q.device
    lens = _as_index(kv_lens, dev).long()
    rows = _as_index(row_ids, dev).long()
    lay = int(layer)
    S = k_rows.shape[3] * (2 if kv_pack else 1)
    lanes = ((lens > 0) & (lens <= S)).nonzero(as_tuple=True)[0]
    pos = lens[lanes] - 1
    kn, vn = k_new[lanes], v_new[lanes]
    if k_scales is not None:
        kn, ksn = kv_quantize(kn, kv_maxq)
        vn, vsn = kv_quantize(vn, kv_maxq)
        k_scales[lay, rows[lanes], :, pos] = ksn
        v_scales[lay, rows[lanes], :, pos] = vsn
    at = (lay, rows[lanes], slice(None), pos)
    if kv_pack:       # the token's nibbles into its plane, the mates kept
        prow, high = packed_slot(pos)
        at = at[:3] + (prow,)
        kn = blend_nibbles(k_rows[at], kn, ~high, kn, high)
        vn = blend_nibbles(v_rows[at], vn, ~high, vn, high)
    k_rows[at] = kn.to(k_rows.dtype)
    v_rows[at] = vn.to(v_rows.dtype)
    out = _attend_plain(q, k_rows, v_rows, lens, (lens - 1).clamp_min(0),
                        rows, lay, scale, k_scales, v_scales, kv_pack,
                        _window_width(window), logit_cap)
    if k_scales is not None:
        return out, k_rows, v_rows, k_scales, v_scales
    return out, k_rows, v_rows


ragged_decode_attention_plain.calls = 0


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name, tensors, ints):
    """Every tensor on one device and contiguous, each of its listed
    dtype; index tensors int32."""
    dev = tensors[0][1].device
    for label, t in [(lb, t) for lb, t, _ in tensors] + list(ints.items()):
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, "
                             f"expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for label, t, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype} on the "
                            f"card, got {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must start on a 16-byte "
                             "boundary (bulk copies)")


def _kv_tensors(k_rows, v_rows, k_scales, v_scales, kv_pack=False):
    """(label, tensor, dtype) of the KV operands: bf16 rows, or int8 rows
    with fp32 scale planes of the rows' [L, B, Hkv, S] shape (packed int4
    rows [L, B, Hkv, S/2, hd] with S a PACK_SEG multiple)."""
    if k_scales is None:
        return [("k_rows", k_rows, torch.bfloat16),
                ("v_rows", v_rows, torch.bfloat16)]
    want = tuple(k_rows.shape[:3]) + (k_rows.shape[3] * (2 if kv_pack
                                                         else 1),)
    if kv_pack and want[3] % PACK_SEG:
        raise ValueError(f"packed KV rows must hold a multiple of "
                         f"{PACK_SEG} tokens, got {want[3]}")
    if want[3] % 4:       # the kernels copy scale planes in 16-byte units
        raise ValueError(f"int8 KV rows must hold a multiple of 4 tokens "
                         f"on the card, got {want[3]}")
    if tuple(k_scales.shape) != want or tuple(v_scales.shape) != want:
        raise ValueError(f"k_scales/v_scales must be {list(want)}, got "
                         f"{tuple(k_scales.shape)} / "
                         f"{tuple(v_scales.shape)}")
    return [("k_rows", k_rows, torch.int8), ("v_rows", v_rows, torch.int8),
            ("k_scales", k_scales, torch.float32),
            ("v_scales", v_scales, torch.float32)]


def _int_args(name, dev, n, **idx):
    """Index arguments as contiguous int32 device tensors; `layer` holds
    one entry, every other argument one per lane."""
    out = {}
    for label, x in idx.items():
        t = _as_index(x, dev).contiguous()
        want = 1 if label == "layer" else n
        if t.numel() != want:
            raise ValueError(f"{name}: {label} must have {want} entries, "
                             f"got {t.numel()}")
        out[label] = t
    return out


def _validate(name, q, k_rows, v_rows, hd_expected=128):
    if k_rows.dim() != 5 or v_rows.shape != k_rows.shape:
        raise ValueError(f"{name}: k_rows/v_rows must be one [L, B, Hkv, S, "
                         f"hd] shape, got {tuple(k_rows.shape)} / "
                         f"{tuple(v_rows.shape)}")
    Hq, hd = q.shape[2], q.shape[3]
    Hkv = k_rows.shape[2]
    if hd != hd_expected or k_rows.shape[4] != hd:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim "
                         f"{hd_expected}, got {hd}")
    if Hq % Hkv:
        raise ValueError(f"{name}: Hq={Hq} is not a multiple of Hkv={Hkv}")


def _mode(quant, kv_pack):
    """Kernel name suffix and launch counter of a KV mode."""
    if kv_pack:
        return "int4", "launches_int4"
    return ("int8", "launches_int8") if quant else ("bf16", "launches")


def _option_args(window: int, logit_cap: float):
    """The kernels' window, cap and fp32 reciprocal of the cap."""
    cap = float(logit_cap)
    return window, cap, (_inv_cap(cap) if cap > 0 else 0.0)


def _count(fn, counter, window, logit_cap):
    """One launch on the mode's counter, and on launches_window when the
    window or the cap was on."""
    setattr(fn, counter, getattr(fn, counter) + 1)
    if window > 0 or logit_cap > 0:
        fn.launches_window += 1


def ragged_attention(q, k_rows, v_rows, kv_lens, q_offsets, row_ids, *,
                     layer=None, scale=None, window=None,
                     logit_cap: float = 0.0, k_scales=None, v_scales=None,
                     kv_pack: bool = False):
    """Causal attention of new tokens against row-contiguous KV.

    q [Bk, T, Hq, hd]; k_rows/v_rows [L, B, Hkv, S, hd] (or [B, Hkv, S,
    hd] with layer None), new tokens already written at their positions;
    kv_lens [Bk] valid KV length per lane including the new tokens (0 for
    a padded lane, whose output is zeros); q_offsets [Bk] global position
    of q[:, 0]; row_ids [Bk] the KV row of each lane; layer: int or 1-elem
    int32 device tensor; window: sliding-window width, an int (None or
    <= 0: off); logit_cap: tanh softcap (0: off); k_scales/v_scales
    [L, B, Hkv, S] (or [B, Hkv, S]) fp32 with int8 rows; kv_pack: the int8
    rows are nibble-packed [..., S/2, hd] (PACK_SEG pairing). Returns
    [Bk, T, Hq, hd] in q's dtype.
    """
    _check_kv_options(k_scales, v_scales, kv_pack, logit_cap)
    window = _window_width(window)
    quant = k_scales is not None
    if k_rows.dim() == 4:
        if layer is not None:
            raise ValueError("layer must be None for 4-D KV rows")
        k_rows, v_rows, layer = k_rows[None], v_rows[None], 0
        if quant:
            k_scales, v_scales = k_scales[None], v_scales[None]
    elif layer is None:
        raise ValueError("layer is required for 5-D KV rows")
    if q.device.type == "cpu":
        return ragged_attention_plain(q, k_rows, v_rows, kv_lens, q_offsets,
                                      row_ids, layer=layer, scale=scale,
                                      window=window, logit_cap=logit_cap,
                                      k_scales=k_scales, v_scales=v_scales,
                                      kv_pack=kv_pack)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_attention: unsupported device {q.device}")
    name = "ragged_attention"
    _validate(name, q, k_rows, v_rows)
    Bk, T, Hq, hd = q.shape
    L, B, Hkv, S, _ = k_rows.shape
    S *= 2 if kv_pack else 1          # the kernels take token-space S
    idx = _int_args(name, q.device, Bk, kv_lens=kv_lens,
                    q_offsets=q_offsets, row_ids=row_ids, layer=layer)
    _check_cuda(name, [("q", q, torch.bfloat16)]
                + _kv_tensors(k_rows, v_rows, k_scales, v_scales, kv_pack),
                idx)
    out = torch.empty_like(q)
    from aurora_tpu_torch.ops.cuda_build import load_library
    lib = load_library()
    if scale is None:
        scale = hd ** -0.5
    tail = (out.data_ptr(), idx["kv_lens"].data_ptr(),
            idx["q_offsets"].data_ptr(), idx["row_ids"].data_ptr(),
            idx["layer"].data_ptr(), Bk, T, Hq, Hkv, L, B, S, hd,
            float(scale),
            *_option_args(window, logit_cap),
            torch.cuda.current_stream(q.device).cuda_stream)
    suffix, counter = _mode(quant, kv_pack)
    scales = (k_scales.data_ptr(), v_scales.data_ptr()) if quant else ()
    err = getattr(lib, "aurora_ragged_extend_" + suffix)(
        q.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(), *scales, *tail)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    _count(ragged_attention, counter, window, logit_cap)
    return out


ragged_attention.launches = 0
ragged_attention.launches_int8 = 0
ragged_attention.launches_int4 = 0
ragged_attention.launches_window = 0


def ragged_decode_attention(q, k_new, v_new, k_rows, v_rows, kv_lens,
                            row_ids, *, layer, scale=None, window=None,
                            logit_cap: float = 0.0, k_scales=None,
                            v_scales=None, kv_maxq: float = 127.0,
                            kv_pack: bool = False):
    """Fused decode step: write each lane's new K/V token into its row at
    kv_lens-1 (in place; no write where kv_lens is 0), then attend.

    q [B, 1, Hq, hd]; k_new/v_new [B, Hkv, hd]; k_rows/v_rows [L, B, Hkv,
    S, hd]; kv_lens [B] row length including the new token; row_ids [B]
    distinct per lane. With k_scales/v_scales ([L, B, Hkv, S] fp32, int8
    rows) the new token is quantized onto the `kv_quantize` grid of
    kv_maxq; with kv_pack (rows [L, B, Hkv, S/2, hd], kv_maxq ≤ 7) its
    nibbles are merged into the bytes it shares with its mate token.
    window and logit_cap as in `ragged_attention` (the query sits at
    kv_lens-1). Returns (attn [B, 1, Hq, hd], k_rows, v_rows[, k_scales,
    v_scales]) — the row and scale tensors are the inputs, updated in
    place.
    """
    _check_kv_options(k_scales, v_scales, kv_pack, logit_cap)
    window = _window_width(window)
    quant = k_scales is not None
    if q.shape[1] != 1:
        raise ValueError("ragged_decode_attention takes one query token")
    if kv_pack and not 0 < kv_maxq <= 7:
        raise ValueError(f"packed int4 KV holds grid values up to 7, got "
                         f"kv_maxq={kv_maxq}")
    if q.device.type == "cpu":
        return ragged_decode_attention_plain(
            q, k_new, v_new, k_rows, v_rows, kv_lens, row_ids,
            layer=layer, scale=scale, window=window, logit_cap=logit_cap,
            k_scales=k_scales, v_scales=v_scales, kv_maxq=kv_maxq,
            kv_pack=kv_pack)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_decode_attention: unsupported device {q.device}")
    name = "ragged_decode_attention"
    _validate(name, q, k_rows, v_rows)
    Bq, _, Hq, hd = q.shape
    L, B, Hkv, S, _ = k_rows.shape
    S *= 2 if kv_pack else 1          # the kernels take token-space S
    if Hq // Hkv > 8:
        raise ValueError(f"{name}: the CUDA kernel takes at most 8 query "
                         f"heads per KV head, got {Hq // Hkv}")
    if k_new.shape != (Bq, Hkv, hd) or v_new.shape != (Bq, Hkv, hd):
        raise ValueError(f"{name}: k_new/v_new must be [{Bq}, {Hkv}, {hd}]")
    idx = _int_args(name, q.device, Bq, kv_lens=kv_lens, row_ids=row_ids,
                    layer=layer)
    bf = torch.bfloat16
    _check_cuda(name, [("q", q, bf), ("k_new", k_new, bf),
                       ("v_new", v_new, bf)]
                + _kv_tensors(k_rows, v_rows, k_scales, v_scales, kv_pack),
                idx)
    out = torch.empty_like(q)
    from aurora_tpu_torch.ops.cuda_build import load_library
    lib = load_library()
    if scale is None:
        scale = hd ** -0.5
    G = Hq // Hkv
    split, nsplit = decode_plan(S, window, Bq * Hkv, _sm_count(q.device))
    part = tickets = None
    if nsplit > 1:    # partials of the splits, merged by the last block
        part = torch.empty(Bq * Hkv * nsplit * G * (hd + 2),
                           dtype=torch.float32, device=q.device)
        tickets = _decode_tickets(q.device, Bq * Hkv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    head = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_rows.data_ptr(), v_rows.data_ptr())
    tail = (out.data_ptr(), *(t.data_ptr() if t is not None else None
                              for t in (part, tickets)),
            idx["kv_lens"].data_ptr(), idx["row_ids"].data_ptr(),
            idx["layer"].data_ptr(),
            Bq, Hq, Hkv, B, S, hd, split, nsplit, float(scale),
            *_option_args(window, logit_cap))
    suffix, counter = _mode(quant, kv_pack)
    if quant:
        inv = float(np.float32(1.0) / np.float32(kv_maxq))
        err = getattr(lib, "aurora_ragged_decode_" + suffix)(
            *head, k_scales.data_ptr(), v_scales.data_ptr(), *tail,
            float(kv_maxq), inv, stream)
    else:
        err = lib.aurora_ragged_decode_bf16(*head, *tail, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")
    _count(ragged_decode_attention, counter, window, logit_cap)
    if quant:
        return out, k_rows, v_rows, k_scales, v_scales
    return out, k_rows, v_rows


ragged_decode_attention.launches = 0
ragged_decode_attention.launches_int8 = 0
ragged_decode_attention.launches_int4 = 0
ragged_decode_attention.launches_window = 0
