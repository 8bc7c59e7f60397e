"""Continuous-batching serving engine over row-contiguous KV
(aurora_tpu/serve/engine.py) on one GPU: bf16, W8 (int8, per-channel
scales) or W4 (int4-packed, group-scaled) weights; bf16, int8 or
nibble-packed int4 KV.

Each running request owns one row of the [L, B, Hkv, S, hd] K and V
buffers (int8 KV adds per-token fp32 scale planes [L, B, Hkv, S]; int4 KV
keeps S/2 packed rows [L, B, Hkv, S/2, hd] beside the same planes). All
requests admitted in a step prefill in ONE batched extend (lanes indexed
by row_ids / q_offsets / kv_lens); decode runs K steps per host sync with
the sampled tokens fed back on the device. Attention in both modes goes
through the hand-written CUDA kernels of ops/pallas/ragged_attention.py,
and W4 and W8 matmuls of at most 64 tokens through the kernels of
ops/pallas/quant_matmul.py (their plain twins on CPU tensors).

The module splits
  * the device half — `_forward_rows`, `_write_kv_window`, `_lm_head`,
    `_sample_core`, and `DeviceRunner`, which holds the KV rows and
    sampler histograms and runs the reference's `_extend_step` and
    `_decode_block` as `extend` and `decode_block`; from
  * the host half — `ServeEngine`: admission, waves, token acceptance,
    release and stats.

A config's sliding window (Mistral: the same width in every layer) and
attention logit softcap go into both attention kernels.

Prefix caching, the reference's default: finished prompts' KV is copied
from the rows into a token-granular slot pool (serve/kv_pool.py) and
indexed by a radix tree over their token ids (the C++ tree of
aurora_tpu_torch/native, else serve/radix_cache.py); an admitted request
whose prompt starts with a cached prefix has that prefix copied into its
row (`_load_prefix`) and extends only the rest. `disable_radix_cache=True`
is the reference's ChunkCache mode: every prompt extends from position 0.

Stop strings: after each accepted token a bounded tail of the output is
decoded with the engine's tokenizer; a request whose tail holds one of its
stop strings finishes (FinishReason.EOS) with `stop_trim` set, and the
caller trims its text there (serve/runtime.py). Within a decode block the
tokens after the stop are discarded, as after an EOS.

Not ported yet (each raises NotImplementedError when asked for): chunked/
interleaved prefill, jump-forward and constrained decoding, tensor
parallelism, and the other model families (MLA, MoE, Gemma2's
alternating windows).
"""

from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from aurora_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                           W4FusedMLP, W4Linear, W8Linear,
                                           layer_mlp, layer_qkv,
                                           projection_shapes, w4_group)
from aurora_tpu_torch.ops.norms import family_norm as _norm
from aurora_tpu_torch.ops.pallas.quant_matmul import (INV127, MAX_TOKENS,
                                                      quantize_activations,
                                                      quantize_rows,
                                                      w4_dequantize,
                                                      w4_flat_dequantize,
                                                      w4_mlp_tile,
                                                      w4_mlp_tile_layout,
                                                      w4_pack, w4_to_flat,
                                                      w4a8_matmul,
                                                      w4a8_matmul_tiled,
                                                      w8a8_matmul)
from aurora_tpu_torch.ops.pallas.ragged_attention import (
    PACK_SEG, blend_nibbles, kv_quantize as _kv_quantize, packed_slot,
    ragged_attention, ragged_decode_attention)
from aurora_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from aurora_tpu_torch.native import NativeRadixCache
from aurora_tpu_torch.serve.kv_pool import KVPool, SlotAllocator
from aurora_tpu_torch.serve.radix_cache import NullPrefixCache, RadixCache
from aurora_tpu_torch.serve.scheduler import (FinishReason, Request,
                                              Scheduler, SchedulePolicy)

_TOPK_LOGPROBS = 5  # top alternatives returned per sampled token
_MAX_TOPK = 256     # sampling candidate bound (see _sample_core)


def make_radix(free_slots):
    """→ (tree, "native" or "python", why the C++ tree failed or None):
    the C++ radix tree unless AURORA_NATIVE_RADIX=0, else, or when it
    cannot be built or loaded, the Python one (the reference's
    `_make_radix`, which falls back silently; the engine keeps the name
    as `radix_impl` and the failure as `radix_error`)."""
    if os.environ.get("AURORA_NATIVE_RADIX", "1") != "0":
        try:
            return NativeRadixCache(free_slots=free_slots), "native", None
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            return RadixCache(free_slots=free_slots), "python", str(e)
    return RadixCache(free_slots=free_slots), "python", None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    max_seq_len: int = 2048          # per-request KV row capacity
    num_slots: int = 8192            # radix-cache pool (prefix KV only)
    prefill_buckets: Tuple[int, ...] = (32, 128, 512, 2048)
    policy: SchedulePolicy = SchedulePolicy.LPM
    kv_dtype: Any = torch.bfloat16
    kv_chunk: int = 1024             # KV rows are a multiple of this width
    decode_steps: int = 1            # decode steps per host sync
    kv_quant: str = "none"
    weight_quant: str = "none"
    tp: int = 1
    # True: the reference's ChunkCache passthrough, every request
    # prefills from scratch and no prompt KV is copied into the pool
    disable_radix_cache: bool = False
    max_extend_lanes: int = 16       # lanes per extend sub-wave
    # the reference's W4 decode layouts (its AURORA_W4_FUSED_MLP and
    # AURORA_W4_TILED): gateup/down as one fused-MLP kernel per layer; and
    # False keeps the W4 projections in the reference's flat layout. Both
    # exist for parity with the reference. Measured on an "NVIDIA H100
    # 80GB HBM3, 700.00 W" as CUDA-graph replays against the stripes
    # (PERF.md §6): the fused MLP ties the stripes' two MLP calls at 4
    # rows (0.0485 against 0.0483 ms a 7B layer) and takes 1.8x their
    # time at 64 (0.1906 against 0.1080); the flat layout's W4A8 takes
    # 1.06x the stripes' at 4 rows (0.0673 against 0.0638 ms over a 7B
    # layer's four projections), 1.03x at 64, and 2.12 against 2.10 ms
    # of W4A8 a decode step. The stripes, the reference's default, stay
    # the default
    w4_fused_mlp: bool = False
    w4_tiled: bool = True

    def __post_init__(self):
        if self.kv_quant not in ("none", "int8", "int4"):
            raise NotImplementedError(
                f"kv_quant={self.kv_quant!r}: none, int8 or int4")
        if self.weight_quant not in ("none", "int4", "int8"):
            raise NotImplementedError(
                f"weight_quant={self.weight_quant!r}: none, int4 or int8")
        if self.tp != 1:
            raise NotImplementedError(
                f"tp={self.tp}: tensor-parallel serving is not ported yet")
        if self.weight_quant != "int4" and (self.w4_fused_mlp
                                            or not self.w4_tiled):
            raise ValueError("w4_fused_mlp and w4_tiled are W4 layouts: "
                             "they need weight_quant='int4'")

    @property
    def s_row(self) -> int:
        """KV row width: max_seq_len rounded up to a kv_chunk multiple
        (int4 KV: the chunk rounded up to the 256-token packing segment)."""
        c = min(self.kv_chunk, self.max_seq_len)
        if self.kv_quant == "int4":
            c = max(-(-c // PACK_SEG) * PACK_SEG, PACK_SEG)
        return -(-self.max_seq_len // c) * c


def kv_bytes_per_token_layer(cfg: LlamaConfig, kv_quant: str,
                             kv_dtype) -> int:
    """K + V bytes of one token in one layer (int8: values plus the fp32
    scale of each head; int4: nibble-packed values plus the scales)."""
    hkv, hd = cfg.num_key_value_heads, cfg.head_dim
    if kv_quant == "int8":
        return 2 * hkv * (hd + 4)
    if kv_quant == "int4":
        return 2 * hkv * (hd // 2 + 4)
    itemsize = torch.empty((), dtype=kv_dtype).element_size()
    return 2 * hkv * hd * itemsize


def row_buffer_bytes(cfg: LlamaConfig, ecfg: EngineConfig) -> int:
    """Device bytes of the KV rows plus the sampler histograms."""
    rows = (cfg.num_hidden_layers * ecfg.max_batch * ecfg.s_row
            * kv_bytes_per_token_layer(cfg, ecfg.kv_quant, ecfg.kv_dtype))
    hist = ecfg.max_batch * cfg.vocab_size * 5     # counts i32 + seen b8
    return rows + hist


# ---------------------------------------------------------------------------
# Weight quantization (the reference's quantize_weights_int4/_int8 and
# fuse_serving_weights, over the port's modules)
# ---------------------------------------------------------------------------

_INV7 = float(np.float32(1.0) / np.float32(7.0))


def _w8(w: torch.Tensor):
    """[out, in] weight → (int8 [out, in], per-output-channel fp32 scale
    [out]). The reference's division by the constant 127 runs as XLA
    compiles it, a multiply by the fp32 reciprocal (so does _w4's by 7)."""
    wf = w.float()
    s = (wf.abs().amax(dim=1) * INV127).clamp_min(1e-12)
    return torch.clamp(torch.round(wf / s[:, None]), -127,
                       127).to(torch.int8), s


def _w4(w: torch.Tensor):
    """[out, in] weight → (packed int8 [out, in/2], fp32 scales [out, G]):
    symmetric absmax per (output channel, group of min(128, in) input
    rows), values rounded half to even into [-8, 7]."""
    O, D = w.shape
    group = w4_group(D)
    wf = w.float().reshape(O, D // group, group)
    s = (wf.abs().amax(dim=2) * _INV7).clamp_min(1e-12)
    q = torch.clamp(torch.round(wf / s[:, :, None]), -8, 7)
    return w4_pack(q.reshape(O, D)), s


def _quantize_model(model: LlamaModel, weight_quant: str, quantize,
                    free_source: bool) -> LlamaModel:
    cfg = model.cfg
    fused = hasattr(model.layers[0], "qkv")
    out = LlamaModel(cfg, device="meta", weight_quant=weight_quant,
                     fused=fused)
    out.embed_tokens = model.embed_tokens
    out.final_norm = model.final_norm
    for src, dst in zip(model.layers, out.layers):
        dst.input_norm = src.input_norm
        dst.post_attn_norm = src.post_attn_norm
        for name in projection_shapes(cfg, fused):
            setattr(dst, name, quantize(getattr(src, name).weight.detach()))
            if free_source:
                setattr(src, name, None)
    out.lm_head = W8Linear(*_w8(model.lm_head.weight.detach()))
    if free_source:
        model.lm_head = None
    return out


def quantize_weights_int4(model: LlamaModel,
                          free_source: bool = False) -> LlamaModel:
    """A W4 model from a dense one: every layer projection → W4Linear,
    the LM head → W8Linear (int8 for logit quality); the embeddings and
    norms are shared with `model`, not copied. Quantizes one projection
    at a time. free_source=True drops each source nn.Linear from `model`
    as it is quantized, so peak memory stays about the dense model plus
    one projection's fp32 transient; `model` is then left without them."""
    return _quantize_model(model, "int4", lambda w: W4Linear(*_w4(w)),
                           free_source)


def quantize_weights_int8(model: LlamaModel,
                          free_source: bool = False) -> LlamaModel:
    """A W8 model from a dense one: every layer projection and the LM
    head → W8Linear (int8, one fp32 scale per output channel), as
    quantize_weights_int4 does it (shared embeddings and norms,
    free_source)."""
    return _quantize_model(model, "int8", lambda w: W8Linear(*_w8(w)),
                           free_source)


def _w4_mlp_fuse(layer) -> Optional[W4FusedMLP]:
    """A layer's W4 gateup/down → a W4FusedMLP (the reference's
    `_w4_mlp_fuse_params` for one layer, in the port's layout with the
    reference's I-tile), or None exactly where the reference keeps the
    two-call MLP (`w4_mlp_tile`: no I-tile t in (256, 128) with I % t ==
    0, t % gd == 0 and t <= I, for intermediate width I and down group
    gd). Unlike the reference, which checks only the packed stacks,
    mismatched scale stacks raise ValueError."""
    gu, dn = getattr(layer, "gateup", None), getattr(layer, "down", None)
    if not (isinstance(gu, W4Linear) and isinstance(dn, W4Linear)) \
            or gu.flat or dn.flat:
        return None
    I2, D2 = gu.packed.shape
    D, I_2 = dn.packed.shape
    for name, w, n_in in (("gateup", gu, 2 * D2), ("down", dn, 2 * I_2)):
        if w.scale.dim() != 2 or w.scale.shape[0] != w.packed.shape[0] \
                or w.scale.shape[1] != n_in // w4_group(n_in):
            raise ValueError(f"{name}: scales {tuple(w.scale.shape)} do not "
                             f"match packed {tuple(w.packed.shape)}")
    I, gd = I2 // 2, w4_group(2 * I_2)
    if D != 2 * D2 or 2 * I_2 != I or w4_mlp_tile(I, gd) is None:
        return None
    return W4FusedMLP(*w4_mlp_tile_layout(*w4_to_flat(gu.packed, gu.scale),
                                          *w4_to_flat(dn.packed, dn.scale)))


def w4_decode_layout(model: LlamaModel, cfg: LlamaConfig,
                     ecfg: EngineConfig) -> LlamaModel:
    """Every W4 decode-layout transform the engine applies at init, in the
    reference's order (`w4_decode_layout_params`): with w4_fused_mlp,
    each layer's gateup/down → one W4FusedMLP; then with w4_tiled=False
    every remaining W4 projection → the flat layout. Returns `model`
    itself when nothing changes (already laid out so), else a new model
    that shares the embeddings, norms, head and untouched projections."""
    if weight_quant_of(model) != "int4":
        return model
    plan = []
    for layer in model.layers:
        mlp = _w4_mlp_fuse(layer) if ecfg.w4_fused_mlp else None
        projs = {}
        for name, proj in layer.named_children():
            if mlp is not None and name in ("gateup", "down"):
                continue
            if isinstance(proj, W4Linear) and not ecfg.w4_tiled \
                    and not proj.flat:
                proj = W4Linear(*w4_to_flat(proj.packed, proj.scale))
            projs[name] = proj
        plan.append((mlp, projs))
    if all(mlp is None and all(p is getattr(layer, n)
                               for n, p in projs.items())
           for layer, (mlp, projs) in zip(model.layers, plan)):
        return model
    out = LlamaModel(cfg, device="meta", weight_quant="int4",
                     fused=hasattr(model.layers[0], "qkv"))
    out.embed_tokens = model.embed_tokens
    out.final_norm = model.final_norm
    out.lm_head = model.lm_head
    for src, dst, (mlp, projs) in zip(model.layers, out.layers, plan):
        dst.input_norm = src.input_norm
        dst.post_attn_norm = src.post_attn_norm
        for name in [n for n, _ in dst.named_children()]:
            delattr(dst, name)
        for name, proj in projs.items():
            setattr(dst, name, proj)
        if mlp is not None:
            dst.mlp = mlp
    return out


def weight_quant_of(model: LlamaModel) -> str:
    """"int4", "int8" or "none": how `model`'s layer weights are stored."""
    proj = model.layers[0].o
    if isinstance(proj, W4Linear):
        return "int4"
    return "int8" if isinstance(proj, W8Linear) else "none"


def _cat_out(parts):
    """Projections → one projection, concatenated on the output axis
    (exact for per-output-channel and per-group scales)."""
    if all(isinstance(p, W4Linear) for p in parts):
        return W4Linear(torch.cat([p.packed for p in parts]),
                        torch.cat([p.scale for p in parts]))
    if all(isinstance(p, W8Linear) for p in parts):
        return W8Linear(torch.cat([p.weight for p in parts]),
                        torch.cat([p.scale for p in parts]))
    w = torch.cat([p.weight.detach() for p in parts])
    lin = nn.Linear(w.shape[1], w.shape[0], bias=False, device="meta")
    lin.weight = nn.Parameter(w, requires_grad=False)
    return lin


def fuse_serving_weights(model: LlamaModel) -> LlamaModel:
    """q/k/v → qkv and gate/up → gateup in every layer, IN PLACE (each
    layer's sources are dropped as its fused stream is built, so peak
    memory stays about one model). Returns `model`."""
    for layer in model.layers:
        for fused, names in (("qkv", ("q", "k", "v")),
                             ("gateup", ("gate", "up"))):
            if not all(hasattr(layer, n) for n in names):
                continue
            setattr(layer, fused, _cat_out([getattr(layer, n)
                                            for n in names]))
            for n in names:
                delattr(layer, n)
    return model


# ---------------------------------------------------------------------------
# Device half: row-KV llama forward, LM head, sampler
# ---------------------------------------------------------------------------

# Above this many tokens (lanes × bucket) `_w4dot` dequantizes the layer's
# weights to the activation dtype and runs a dense matmul (the reference's
# prefill branch) and `_w8dot` runs torch._int_mm; at or below it they run
# the W4A8 and W8A8 kernels (and `layer_mlp` the fused-MLP kernel).
_W4_GROUPED_MAX_TOKENS = MAX_TOKENS


def _w4dot(h, w: W4Linear):
    """h [..., K] @ W4 → [..., N] in h's dtype. Few tokens (decode): the
    W4A8 kernel of the module's layout (stripes: w4a8_matmul_tiled; flat:
    w4a8_matmul), with per-token int8 activations. Many tokens (extend):
    the weights dequantized to h's dtype, a dense matmul, no activation
    quantization. The two branches differ numerically, as the
    reference's do."""
    lead, K = h.shape[:-1], h.shape[-1]
    if math.prod(lead) <= _W4_GROUPED_MAX_TOKENS:
        kernel = w4a8_matmul if w.flat else w4a8_matmul_tiled
        out = kernel(h.reshape(-1, K), w.packed, w.scale)
        return out.reshape(*lead, -1)
    if w.flat:
        return h @ w4_flat_dequantize(w.packed, w.scale, h.dtype)
    return torch.nn.functional.linear(
        h, w4_dequantize(w.packed, w.scale, h.dtype))


def _int8_linear(x8, s_a, w: W8Linear) -> torch.Tensor:
    """Per-token int8 rows x8 [n, K] (scales s_a [n, 1]) @ W8 → fp32
    [n, N]: the int32 product by torch._int_mm, whose card version needs
    more than 16 rows (the rows are zero-padded to at least 32), then
    acc · s_a · s_w."""
    n = x8.shape[0]
    pad = max(32, -(-n // 8) * 8) - n
    acc = torch._int_mm(torch.nn.functional.pad(x8, (0, 0, 0, pad)),
                        w.weight.t())[:n]
    return acc.float() * s_a * w.scale


def _w8dot(h, w: W8Linear):
    """h [..., K] @ W8 → [..., N] in h's dtype (the reference's W8A8
    `_wdot` branch): per-token int8 activations, the exact int32 product,
    then acc · s_a · s_w in fp32. Few tokens (decode): the quantizer in
    one launch (quantize_rows) and the W8A8 kernel; many (extend):
    quantize_activations and torch._int_mm. Both give the same numbers."""
    lead, K = h.shape[:-1], h.shape[-1]
    h2 = h.reshape(-1, K)
    if math.prod(lead) <= _W4_GROUPED_MAX_TOKENS:
        h8, s_a = quantize_rows(h2.contiguous())
        out = w8a8_matmul(h8, s_a, w.weight, w.scale, out_dtype=h.dtype)
    else:
        out = _int8_linear(*quantize_activations(h2), w).to(h.dtype)
    return out.reshape(*lead, -1)


def _wdot(h, proj):
    """h @ W for one projection module: W4 (_w4dot), W8 (_w8dot) or
    dense."""
    if isinstance(proj, W4Linear):
        return _w4dot(h, proj)
    if isinstance(proj, W8Linear):
        return _w8dot(h, proj)
    return proj(h)


@dataclasses.dataclass
class KVWriteIndex:
    """Where an extend wave's new K/V land: token t_idx of lane lane_idx
    goes to position pos_idx of row row_idx. Built once per wave and
    reused by every layer. For packed int4 rows also each byte the wave
    touches, once: packed row byte_pos of row byte_row, whose low and high
    nibbles come from the wave's flattened token src_lo / src_hi (lane ·
    T + t), or, where that is -1, stay as they are."""
    lane_idx: torch.Tensor
    t_idx: torch.Tensor
    row_idx: torch.Tensor
    pos_idx: torch.Tensor
    byte_row: Optional[torch.Tensor] = None
    byte_pos: Optional[torch.Tensor] = None
    src_lo: Optional[torch.Tensor] = None
    src_hi: Optional[torch.Tensor] = None


def _kv_write_index(row_ids, q_offsets, kv_lens, T: int, S: int,
                    device, pack: bool = False) -> KVWriteIndex:
    """Host-side plan of the extend write: positions [q_offset, q_offset +
    T) ∩ [0, kv_len) ∩ [0, S) of each lane. Query padding past kv_len and
    bucket padding past the row are dropped, as the reference's windowed
    write drops them. pack: plan the packed int4 bytes too, each byte once
    even where the wave writes both of its tokens."""
    lanes, ts, rows, pos = [], [], [], []
    for i, (row, off, ln) in enumerate(zip(row_ids, q_offsets, kv_lens)):
        off, ln = int(off), int(ln)
        end = min(ln, off + T, S)
        if end > off >= 0:
            n = end - off
            lanes.append(np.full(n, i))
            ts.append(np.arange(n))
            rows.append(np.full(n, int(row)))
            pos.append(np.arange(off, end))

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def dev(arr):
        return torch.as_tensor(arr, dtype=torch.int64, device=device)

    lanes, ts, rows, pos = cat(lanes), cat(ts), cat(rows), cat(pos)
    widx = KVWriteIndex(dev(lanes), dev(ts), dev(rows), dev(pos))
    if pack:
        prow, high = packed_slot(pos)
        uniq, src = _nibble_plan(rows * (S // 2) + prow, high,
                                 lanes * T + ts)
        widx.byte_row, widx.byte_pos = dev(uniq // (S // 2)), \
            dev(uniq % (S // 2))
        widx.src_lo, widx.src_hi = dev(src[0]), dev(src[1])
    return widx


def _nibble_plan(key, high, token):
    """Packed bytes touched by tokens at byte keys `key` (high nibble where
    `high`): → (each key once, sorted; [2, n] the token in its low / high
    nibble, -1 where no token writes it)."""
    uniq, inv = np.unique(key, return_inverse=True)
    src = np.full((2, len(uniq)), -1, np.int64)
    src[high.astype(np.int64), inv] = token
    return uniq, src


def _write_kv_window(rows, l: int, k, v, widx: KVWriteIndex,
                     scales=None) -> None:
    """Write the wave's new tokens into layer l of the rows, in place
    (with int8 rows, their per-token scales [Bk, T, Hkv] into ks/vs; with
    packed int4 rows, each touched byte rebuilt once from both of its
    nibbles, the reference's _write_kv_window_packed)."""
    at = (widx.row_idx, slice(None), widx.pos_idx)
    new = (widx.lane_idx, widx.t_idx)
    if widx.byte_row is None:
        rows["k"][l][at] = k[new].to(rows["k"].dtype)
        rows["v"][l][at] = v[new].to(rows["v"].dtype)
    else:
        bat = (widx.byte_row, slice(None), widx.byte_pos)
        lo, hi = widx.src_lo.clamp_min(0), widx.src_hi.clamp_min(0)
        for name, x in (("k", k), ("v", v)):
            x = x.flatten(0, 1)
            rows[name][l][bat] = blend_nibbles(
                rows[name][l][bat], x[lo], widx.src_lo >= 0, x[hi],
                widx.src_hi >= 0)
    if scales is not None:
        rows["ks"][l][at] = scales[0][new]
        rows["vs"][l][at] = scales[1][new]


def _is_packed(rows) -> bool:
    """Packed int4 rows: S/2 value rows beside full-S scale planes."""
    return "ks" in rows and rows["k"].shape[3] * 2 == rows["ks"].shape[3]


@torch.no_grad()
def _load_prefix(rows, pool, slots, row: int, start: int, n_valid: int):
    """Copy a radix-cached prefix chunk into row `row`, in place: position
    start + i takes pool slot slots[i] for i < n_valid; every other
    position, and positions past the row, stay as they are. rows / pool:
    the engine's {"k", "v"(, "ks", "vs")} row buffers and pool planes.
    Packed int4 rows take each token's nibble into its byte and keep the
    mate nibble (the pool holds int4 grid values in int8). One gather from
    the pool and one scatter into the row a plane, over all layers.
    Returns rows."""
    packed = _is_packed(rows)
    S = rows["ks"].shape[3] if packed else rows["k"].shape[3]
    n = min(int(n_valid), S - int(start))
    if n <= 0:
        return rows
    dev = rows["k"].device
    sl = torch.as_tensor(np.asarray(slots[:n], np.int64), device=dev)
    pos = np.arange(start, start + n)
    for name, buf in rows.items():
        c = pool[name].index_select(1, sl).transpose(1, 2)  # [L, Hkv, n..]
        dst = buf[:, row]
        if packed and buf.dim() == 5:
            prow, high = packed_slot(pos)
            uniq, src = _nibble_plan(prow, high, np.arange(n))
            at = torch.as_tensor(uniq, device=dev)
            lo, hi = (torch.as_tensor(x, device=dev) for x in src)
            x = c.permute(2, 0, 1, 3)                        # [n, L, Hkv, hd]
            cur = dst.index_select(2, at).permute(2, 0, 1, 3)
            new = blend_nibbles(cur, x[lo.clamp_min(0)], lo >= 0,
                                x[hi.clamp_min(0)], hi >= 0)
            dst.index_copy_(2, at, new.permute(1, 2, 0, 3))
        else:
            dst.index_copy_(2, torch.as_tensor(pos, device=dev),
                            c.to(buf.dtype))
    return rows


@torch.no_grad()
def _store_prompt(pool, rows, row: int, start: int, slots):
    """Copy row `row`'s positions start + i into pool slot slots[i], in
    place; a slot equal to the pool's size is padding and is dropped.
    Packed int4 rows are unpacked (sign-extended nibbles) into the int8
    pool. One gather from the row and one scatter into the pool a plane,
    over all layers. Returns pool."""
    packed = _is_packed(rows)
    S = rows["ks"].shape[3] if packed else rows["k"].shape[3]
    num_slots = pool["k"].shape[1]
    slots = np.asarray(slots, np.int64)
    keep = slots != num_slots
    pos = np.clip(start + np.arange(len(slots)), 0, S - 1)[keep]
    if not len(pos):
        return pool
    dev = rows["k"].device
    sl = torch.as_tensor(slots[keep], device=dev)
    for name, buf in rows.items():
        src = buf[:, row]
        if packed and buf.dim() == 5:
            prow, high = packed_slot(pos)
            b = src.index_select(2, torch.as_tensor(prow, device=dev))
            b = b.to(torch.int32)
            nib = torch.where(torch.as_tensor(high, device=dev)[:, None],
                              b >> 4, b) & 0xF
            x = ((nib ^ 8) - 8).to(torch.int8)
        else:
            x = src.index_select(2, torch.as_tensor(pos, device=dev))
        pool[name].index_copy_(1, sl, x.transpose(1, 2).to(pool[name].dtype))
    return pool


def _forward_rows(model: LlamaModel, cfg: LlamaConfig, embeds, rows,
                  row_ids, q_offsets, kv_lens, layer_ids,
                  kv_write: Optional[KVWriteIndex] = None):
    """Shared EXTEND/DECODE forward over row-contiguous KV.

    embeds [Bk, T, D]; rows {"k", "v": [L, B, Hkv, S, hd]} (+ "ks", "vs"
    [L, B, Hkv, S] fp32 scales when the rows are int8; packed int4 rows
    are [L, B, Hkv, S/2, hd], and that shape is the packing flag, as in the
    reference); row_ids,
    q_offsets, kv_lens [Bk] int32 device tensors (kv_lens is the row
    length AFTER the new tokens, 0 for a padded lane); layer_ids [L] int32
    device tensor (each kernel reads its layer index from it). EXTEND
    (T > 1) writes the new K/V through `kv_write` (int8/int4: quantized
    first, to maxq 127/7, and the extend attends over the quantized rows,
    new tokens included), then attends; DECODE (T == 1) writes (quantizing
    the token in the kernel) and attends in one kernel. Each projection
    dispatches on its module: W4, W8 or dense. Both kernels take every
    layer's sliding window (cfg.sliding_window; Gemma2's alternating
    layers are not ported) and cfg.attn_logit_softcap, as the reference's
    `_window(l)` and kernel calls do. Returns the last valid token's final
    hidden state per lane, [Bk, D].
    """
    x = embeds
    Bk, T, _ = x.shape
    hd = cfg.head_dim
    quant = "ks" in rows
    kv_pack = _is_packed(rows)
    maxq = 7.0 if kv_pack else 127.0
    scales = dict(k_scales=rows.get("ks"), v_scales=rows.get("vs"),
                  kv_pack=kv_pack, window=cfg.sliding_window,
                  logit_cap=cfg.attn_logit_softcap)
    positions = q_offsets[:, None].long() + torch.arange(T, device=x.device)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta,
                            cfg.rope_linear_scaling)
    for l, lp in enumerate(model.layers):
        h = _norm(cfg, x, lp.input_norm)
        q, k, v = layer_qkv(cfg, lp, h, _wdot)
        q, k = apply_rope(q, k, cos, sin)
        layer = layer_ids[l:l + 1]
        if T == 1:
            attn = ragged_decode_attention(
                q, k[:, 0], v[:, 0], rows["k"], rows["v"], kv_lens, row_ids,
                layer=layer, scale=cfg.attn_scale, kv_maxq=maxq,
                **scales)[0]
        else:
            if quant:
                (k, ks), (v, vs) = (_kv_quantize(k, maxq),
                                    _kv_quantize(v, maxq))
                _write_kv_window(rows, l, k, v, kv_write, (ks, vs))
            else:
                _write_kv_window(rows, l, k, v, kv_write)
            attn = ragged_attention(q, rows["k"], rows["v"], kv_lens,
                                    q_offsets, row_ids, layer=layer,
                                    scale=cfg.attn_scale, **scales)
        x = x + _wdot(attn.reshape(Bk, T, -1).to(x.dtype), lp.o)
        x = x + layer_mlp(cfg, lp, _norm(cfg, x, lp.post_attn_norm), _wdot)
    x = _norm(cfg, x, model.final_norm)
    last = (kv_lens.long() - q_offsets.long() - 1).clamp(0, T - 1)
    return x[torch.arange(Bk, device=x.device), last]


def _lm_head(model: LlamaModel, x) -> torch.Tensor:
    """Logits in fp32. A dense head runs in the weights' dtype; the int8
    head (W4 and W8 models) runs W8A8: per-token int8 activations, an
    int32 matmul (torch._int_mm), then both scales."""
    head = model.lm_head
    if not isinstance(head, W8Linear):
        return torch.nn.functional.linear(x, head.weight).float()
    return _int8_linear(*quantize_activations(x), head)


def _sample_core(logits, counts, seen, samp, allowed, generator,
                 all_greedy: bool = False):
    """logits [N, V] fp32 → (sampled [N] int64, raw log-probs [N, V]).

    Per row: repetition penalty over `seen` (prompt + output), frequency
    and presence penalties over the output histogram `counts`, the allowed
    mask, temperature, top-k, top-p and min-p over at most _MAX_TOPK
    candidates, then a draw from `generator`. temperature <= 0 is greedy.
    Log-probs come from the raw (pre-penalty) distribution."""
    V = logits.shape[-1]
    raw_lp = torch.log_softmax(logits, dim=-1)
    rep = samp["rep"][:, None]
    logits = torch.where(seen, torch.where(logits > 0, logits / rep,
                                           logits * rep), logits)
    counts = counts.float()
    logits = logits - samp["freq"][:, None] * counts
    logits = logits - samp["pres"][:, None] * (counts > 0).float()
    if allowed is not None:
        logits = logits.masked_fill(~allowed, float("-inf"))
    greedy = logits.argmax(dim=-1)
    if all_greedy:
        return greedy, raw_lp
    kc = min(V, _MAX_TOPK)
    lt = logits / samp["temp"][:, None].clamp_min(1e-6)
    cand, cand_ids = lt.topk(kc, dim=-1)               # descending
    ks = samp["top_k"][:, None]
    rank = torch.arange(kc, device=logits.device)[None, :]
    cand = cand.masked_fill((ks > 0) & (rank >= ks), float("-inf"))
    probs = torch.softmax(cand, dim=-1)
    cum = probs.cumsum(dim=-1)
    cand = cand.masked_fill((cum - probs) > samp["top_p"][:, None],
                            float("-inf"))
    p_c = torch.softmax(cand, dim=-1)
    min_p = samp["min_p"][:, None]
    cand = cand.masked_fill((min_p > 0) & (p_c < min_p * p_c[:, :1]),
                            float("-inf"))
    choice = torch.multinomial(torch.softmax(cand, dim=-1), 1,
                               generator=generator)
    sampled = cand_ids.gather(1, choice)[:, 0]
    return torch.where(samp["temp"] <= 0.0, greedy, sampled), raw_lp


def _logprob_outputs(raw_lp, sampled, want_logprobs: bool):
    tok_lp = raw_lp.gather(1, sampled[:, None])[:, 0]
    N = raw_lp.shape[0]
    if want_logprobs:
        top_lp, top_ids = raw_lp.topk(_TOPK_LOGPROBS, dim=-1)
    else:
        top_lp = raw_lp.new_zeros((N, _TOPK_LOGPROBS))
        top_ids = torch.zeros((N, _TOPK_LOGPROBS), dtype=torch.int64,
                              device=raw_lp.device)
    return tok_lp, top_lp, top_ids


def _samp_arrays(reqs, n, rows=None) -> Dict[str, np.ndarray]:
    """Per-request SamplingParams → host [n] arrays (dense lanes when
    rows is None, else one entry per listed row)."""
    out = {"temp": np.zeros(n, np.float32),
           "top_k": np.zeros(n, np.int64),
           "top_p": np.ones(n, np.float32),
           "min_p": np.zeros(n, np.float32),
           "freq": np.zeros(n, np.float32),
           "pres": np.zeros(n, np.float32),
           "rep": np.ones(n, np.float32)}
    for i, r in enumerate(reqs):
        j = i if rows is None else rows[i]
        s = r.sampling
        out["temp"][j] = s.temperature
        out["top_k"][j] = s.top_k
        out["top_p"][j] = s.top_p
        out["min_p"][j] = s.min_p
        out["freq"][j] = s.frequency_penalty
        out["pres"][j] = s.presence_penalty
        out["rep"][j] = s.repetition_penalty
    return out


class DeviceRunner:
    """The device half of the engine: weights, KV rows, per-row sampler
    histograms and the sampling generator, with the extend, first-token
    sampling and K-step decode programs over them. Host code passes numpy
    arrays in and gets numpy arrays back; everything between stays on the
    device."""

    def __init__(self, model: LlamaModel, cfg: LlamaConfig,
                 ecfg: EngineConfig, device, seed: int = 0):
        self.model, self.cfg, self.ecfg = model, cfg, ecfg
        self.device = torch.device(device)
        B, S = ecfg.max_batch, ecfg.s_row
        L, Hkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                      cfg.head_dim)
        quant = ecfg.kv_quant in ("int8", "int4")
        store = torch.int8 if quant else ecfg.kv_dtype
        # int4: S/2 nibble-packed rows beside full-S scale planes
        Sv = S // 2 if ecfg.kv_quant == "int4" else S
        self.rows = {"k": torch.zeros((L, B, Hkv, Sv, hd), dtype=store,
                                      device=self.device),
                     "v": torch.zeros((L, B, Hkv, Sv, hd), dtype=store,
                                      device=self.device)}
        if quant:       # per-token fp32 scales of the int8/int4 rows
            for name in ("ks", "vs"):
                self.rows[name] = torch.zeros((L, B, Hkv, S),
                                              dtype=torch.float32,
                                              device=self.device)
        self.counts = torch.zeros((B, cfg.vocab_size), dtype=torch.int32,
                                  device=self.device)
        self.seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool,
                                device=self.device)
        self.layer_ids = torch.arange(L, dtype=torch.int32,
                                      device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def _idx(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.int32,
                               device=self.device)

    def _samp(self, samp_np):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in samp_np.items()}

    def embed(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                              device=self.device)
        return self.model.embed_tokens[ids]

    @torch.no_grad()
    def extend(self, embeds, row_ids, q_offsets, kv_lens) -> torch.Tensor:
        """_extend_step: one batched extend wave → logits [Bk, V] fp32.
        row_ids / q_offsets / kv_lens are host arrays of the wave."""
        widx = _kv_write_index(row_ids, q_offsets, kv_lens,
                               embeds.shape[1], self.ecfg.s_row,
                               self.device,
                               pack=self.ecfg.kv_quant == "int4")
        x = _forward_rows(self.model, self.cfg, embeds, self.rows,
                          self._idx(row_ids), self._idx(q_offsets),
                          self._idx(kv_lens), self.layer_ids, widx)
        return _lm_head(self.model, x)

    @torch.no_grad()
    def reset_row_stats(self, row: int, prompt_seen: np.ndarray) -> None:
        self.counts[row] = 0
        self.seen[row] = torch.as_tensor(prompt_seen, device=self.device)

    @torch.no_grad()
    def sample_after_extend(self, logits, row_ids, samp_np, allowed,
                            all_greedy: bool, want_logprobs: bool):
        """First token for freshly extended lanes → host arrays."""
        rows = torch.as_tensor(np.asarray(row_ids), dtype=torch.int64,
                               device=self.device)
        allowed_t = (None if allowed is None
                     else torch.as_tensor(allowed, device=self.device))
        sampled, raw_lp = _sample_core(
            logits, self.counts[rows], self.seen[rows], self._samp(samp_np),
            allowed_t, self.generator, all_greedy=all_greedy)
        outs = _logprob_outputs(raw_lp, sampled, want_logprobs)
        self.counts.index_put_((rows, sampled),
                               torch.ones_like(rows, dtype=torch.int32),
                               accumulate=True)
        self.seen[rows, sampled] = True
        return tuple(t.cpu().numpy() for t in (sampled,) + outs)

    @torch.no_grad()
    def decode_block(self, tokens, positions, active, samp_np, K: int,
                     allowed, all_greedy: bool, want_logprobs: bool):
        """_decode_block: K decode steps for every row, the sampled token
        of each step fed back on the device; one host sync at the end.
        Positions clamp to the row's last slot, inactive rows decode with
        kv_len 0 (no KV write). Returns K tuples (sampled, tok_lp, top_lp,
        top_ids) of host arrays."""
        dev = self.device
        B = len(tokens)
        S_row = self.ecfg.s_row
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                              device=dev)
        pos0 = torch.as_tensor(np.asarray(positions), dtype=torch.int32,
                               device=dev)
        act = torch.as_tensor(np.asarray(active), device=dev)
        samp = self._samp(samp_np)
        allowed_t = (None if allowed is None
                     else torch.as_tensor(allowed, device=dev))
        row_ids = torch.arange(B, dtype=torch.int32, device=dev)
        ar = row_ids.long()
        steps = []
        for j in range(K):
            pos_j = (pos0 + j).clamp_max(S_row - 1)
            kv_lens = torch.where(act, pos_j + 1, 0).to(torch.int32)
            embeds = self.model.embed_tokens[tok][:, None]
            x = _forward_rows(self.model, self.cfg, embeds, self.rows,
                              row_ids, pos_j, kv_lens, self.layer_ids)
            sampled, raw_lp = _sample_core(
                _lm_head(self.model, x), self.counts, self.seen, samp,
                allowed_t, self.generator, all_greedy=all_greedy)
            outs = _logprob_outputs(raw_lp, sampled, want_logprobs)
            self.counts.index_put_((ar, sampled), act.to(torch.int32),
                                   accumulate=True)
            self.seen[ar, sampled] |= act
            steps.append((sampled,) + outs)
            tok = sampled
        host = [torch.stack(parts).cpu().numpy() for parts in zip(*steps)]
        return [tuple(h[j] for h in host) for j in range(K)]


# ---------------------------------------------------------------------------
# Host half
# ---------------------------------------------------------------------------

class ServeEngine:
    """Single-GPU engine: schedule → batched extend / K-step decode.

    weight_quant="int4" / "int8" serves a W4 / W8 model: a dense `model`
    is quantized (quantize_weights_int4 / _int8 into a new model; `model`
    stays as it is) and its streams fused (fuse_serving_weights); a model
    that is already quantized so, fused or not, is served as given. A W4
    model then takes the decode layout that ecfg asks for
    (`w4_decode_layout`: a new model, unless it is laid out so already).
    tokenizer: decodes output tails for stop strings (requests with
    stop_strs need one)."""

    def __init__(self, model: LlamaModel, cfg: LlamaConfig,
                 ecfg: EngineConfig = EngineConfig(), embed_fn=None,
                 device=None, seed: int = 0, tokenizer=None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.tokenizer = tokenizer
        have = weight_quant_of(model)
        if have != ecfg.weight_quant:
            if have != "none":
                raise ValueError(f"a {have} model cannot be served with "
                                 f"weight_quant={ecfg.weight_quant!r}")
            quantize = {"int4": quantize_weights_int4,
                        "int8": quantize_weights_int8}[ecfg.weight_quant]
            model = fuse_serving_weights(quantize(model))
        model = w4_decode_layout(model, cfg, ecfg)
        self.embed_fn = embed_fn  # multimodal hook: req → [T, D] embeds
        device = device if device is not None else \
            model.embed_tokens.device
        self.runner = DeviceRunner(model, cfg, ecfg, device, seed)
        self.alloc = SlotAllocator(ecfg.num_slots)
        self.radix_error = None
        if ecfg.disable_radix_cache:
            # nothing is ever stored or loaded: no pool on the device
            self.pool = None
            self.radix, self.radix_impl = NullPrefixCache(), "null"
        else:
            # int8 and int4 KV: an int8 pool with scale planes (int4 rows
            # unpack into it: slots are token-granular, packing positional)
            self.pool = KVPool(cfg, ecfg.num_slots, ecfg.kv_dtype,
                               quant=ecfg.kv_quant in ("int8", "int4"),
                               device=self.runner.device)
            self.radix, self.radix_impl, self.radix_error = make_radix(
                self.alloc.free)
        self.sched = Scheduler(ecfg.max_batch,
                               ecfg.max_batch * ecfg.max_seq_len,
                               ecfg.policy, self.radix)
        self.row_reqs: List[Optional[Request]] = [None] * ecfg.max_batch
        self._done_buffer: List[Request] = []
        self._gen_total = 0
        self._steps = 0
        self.t_extend_s = 0.0   # cumulative extend wall time (step())
        self.t_decode_s = 0.0   # cumulative decode wall time (step())

    # -- public API ----------------------------------------------------------

    def add_request(self, req: Request) -> None:
        if req.stop_strs and self.tokenizer is None:
            raise ValueError(f"request {req.rid}: stop strings need an "
                             "engine built with a tokenizer")
        if req.constraint is not None:
            raise NotImplementedError(
                "constrained and jump-forward decoding are not ported yet")
        if len(req.input_ids) > max(self.ecfg.prefill_buckets):
            raise NotImplementedError(
                f"request {req.rid}: prompt of {len(req.input_ids)} tokens "
                f"exceeds the largest prefill bucket "
                f"{max(self.ecfg.prefill_buckets)}; chunked prefill is not "
                "ported yet")
        if not req.input_ids:
            req.finished = FinishReason.ABORT
            req.error = "empty prompt (input_ids must be non-empty)"
            self._done_buffer.append(req)
            return
        if req.max_new_tokens <= 0:
            req.finished = FinishReason.LENGTH
            self._done_buffer.append(req)
            return
        self.sched.add(req)

    def abort(self, rid: str) -> bool:
        return self.sched.abort(rid)

    def has_work(self) -> bool:
        return bool(self.sched.waiting or self.sched.running
                    or self._done_buffer)

    def step(self) -> List[Request]:
        """One engine iteration → requests finished this step. Both phases
        end in a host read of the sampled tokens, so their wall times
        include the device work."""
        t0 = time.perf_counter()
        self._admit()
        t1 = time.perf_counter()
        self._decode()
        self.t_extend_s += t1 - t0
        self.t_decode_s += time.perf_counter() - t1
        done, self._done_buffer = self._done_buffer, []
        for req in self.sched.retire_finished():
            self._release(req)
            done.append(req)
        return done

    def flush_cache(self) -> int:
        """Drop every unlocked cached prefix; → the cached tokens left (those
        of locked paths)."""
        self.radix.evict(self.ecfg.num_slots)
        return self.radix.total_cached_tokens()

    def check_memory(self) -> Dict[str, int]:
        """Pool accounting: free slots, cached tokens, tokens in the rows,
        and `leaked` = slots neither free nor cached (0 unless slots leak)."""
        cached = self.radix.total_cached_tokens()
        free = self.alloc.available()
        return {"free": free, "cached": cached,
                "in_flight": sum(r.seq_len for r in self.row_reqs
                                 if r is not None),
                "leaked": self.ecfg.num_slots - free - cached}

    def decode_stats(self) -> Dict[str, float]:
        """Running/queued counts, the pool's used share, generated tokens per
        second since the previous call (0.0 on the first) and the
        cumulative phase times."""
        now = time.perf_counter()
        toks = self._gen_total
        last_t, last_n = getattr(self, "_stats_mark", (now, toks))
        self._stats_mark = (now, toks)
        used = self.ecfg.num_slots - self.alloc.available()
        return {"running": len(self.sched.running),
                "queued": len(self.sched.waiting),
                "slot_usage": round(used / max(self.ecfg.num_slots, 1), 4),
                "gen_tokens_per_s": round(
                    max(toks - last_n, 0) / max(now - last_t, 1e-9), 1),
                "extend_s": round(self.t_extend_s, 3),
                "decode_s": round(self.t_decode_s, 3)}

    # -- admission and extend ------------------------------------------------

    def _free_row(self) -> int:
        for i, r in enumerate(self.row_reqs):
            if r is None:
                return i
        return -1

    def _bucket(self, n: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        raise NotImplementedError("chunked prefill is not ported yet")

    @staticmethod
    def _lane_bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _wave_bucket(self, n: int) -> int:
        return min(self._lane_bucket(n), self.ecfg.max_extend_lanes)

    def _admit(self) -> None:
        free_rows = sum(r is None for r in self.row_reqs)
        admitted = self.sched.get_prefill_batch(
            free_rows * self.ecfg.max_seq_len)
        wave: List[Request] = []
        for req in admitted:
            row = self._free_row()
            if row < 0:
                self.sched.waiting.insert(0, req)
                continue
            try:
                self._prepare(req, row)
            except Exception as e:  # noqa: BLE001 - abort only this request
                self._abort_admission(req, row, e)
                continue
            wave.append(req)
        if wave:
            self._run_wave_chunks(wave)

    def _run_wave_chunks(self, wave: List[Request]) -> None:
        """Sub-waves of ≤ max_extend_lanes; a failure aborts the failing
        sub-wave and every later one (their rows are already claimed)
        before it propagates."""
        cap = max(1, self.ecfg.max_extend_lanes)
        for at in range(0, len(wave), cap):
            try:
                self._run_wave(wave[at:at + cap])
            except Exception as e:
                for req in wave[at + cap:]:
                    self._abort_admission(req, req.batch_row, e)
                raise

    def _run_wave(self, wave: List[Request]) -> None:
        """A failed extend is taken as a failure of the deployment (kernel
        build or launch, device memory), not of a request: the wave is
        aborted and the error reaches the step() caller."""
        try:
            self._extend_wave(wave)
        except Exception as e:
            for req in wave:
                self._abort_admission(req, req.batch_row, e)
            raise
        self.sched.running.extend(wave)

    def _abort_admission(self, req: Request, row: int, e: Exception):
        req.finished = FinishReason.ABORT
        req.error = str(e)
        if 0 <= row < len(self.row_reqs) and self.row_reqs[row] is req:
            self.row_reqs[row] = None
        self._unlock(req)
        self.sched.aborted.append(req)

    def _unlock(self, req: Request) -> None:
        """Drop the prefix lock that _prepare took, if it took one (the LPM
        pre-match sets prefix_node without a lock)."""
        if req.prefix_locked:
            self.radix.lock(req.prefix_node, -1)
            req.prefix_locked = False
        req.prefix_node = None

    def _prepare(self, req: Request, row: int) -> None:
        """Claim a row: match the prompt again (LPM's pre-match held no
        lock, so an eviction since may have freed its slots), lock the
        prefix, copy it into the row, and reset the row's sampler
        histograms. A full hit extends its last token again, so that the
        extend has a token to sample from."""
        ids = req.input_ids
        if len(ids) + req.max_new_tokens > self.ecfg.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(ids)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_seq_len "
                f"{self.ecfg.max_seq_len}")
        req.prefix_slots, req.prefix_node = self.radix.match_prefix(ids)
        self.radix.lock(req.prefix_node, +1)
        req.prefix_locked = True
        n_cached = min(len(req.prefix_slots), len(ids) - 1)
        req.batch_row = row
        req.n_cached = n_cached
        req.extend_len_pending = len(ids) - n_cached
        self.row_reqs[row] = req
        chunk = max(self.ecfg.prefill_buckets)
        for start in range(0, n_cached, chunk):
            n = min(chunk, n_cached - start)
            _load_prefix(self.runner.rows, self.pool.planes,
                         req.prefix_slots[start:start + n], row, start, n)
        prompt_seen = np.zeros((self.cfg.vocab_size,), bool)
        valid = np.asarray([t for t in ids if 0 <= t < self.cfg.vocab_size],
                           np.int64)
        prompt_seen[valid] = True
        self.runner.reset_row_stats(row, prompt_seen)

    def _assemble_wave(self, ids, mm_lanes) -> torch.Tensor:
        """[Bk, T, D] wave embeds: the text-id lookup, with each multimodal
        lane's fused embeds (embed_fn) spliced over its row."""
        embeds = self.runner.embed(ids).to(self.ecfg.kv_dtype)
        for i, req in mm_lanes:
            e = torch.as_tensor(self.embed_fn(req),
                                device=self.runner.device)[req.n_cached:]
            embeds[i, :e.shape[0]] = e.to(embeds.dtype)
        return embeds

    def _extend_wave(self, wave: List[Request]) -> None:
        """One batched extend for every admitted request of the wave."""
        T = self._bucket(max(r.extend_len_pending for r in wave))
        Bk = self._wave_bucket(len(wave))
        ids = np.zeros((Bk, T), np.int64)
        row_ids = np.zeros((Bk,), np.int32)
        offs = np.zeros((Bk,), np.int32)
        lens = np.zeros((Bk,), np.int32)
        mm_lanes = []
        for i, req in enumerate(wave):
            n_new = req.extend_len_pending
            if self.embed_fn is not None and req.pixel_values is not None:
                mm_lanes.append((i, req))
            else:
                ids[i, :n_new] = np.clip(
                    np.asarray(req.input_ids[req.n_cached:], np.int64),
                    0, self.cfg.vocab_size - 1)
            row_ids[i] = req.batch_row
            offs[i] = req.n_cached
            lens[i] = req.n_cached + n_new
        embeds = self._assemble_wave(ids, mm_lanes)
        logits = self.runner.extend(embeds, row_ids, offs, lens)
        self._emit(wave, logits[:len(wave)], row_ids[:len(wave)])

    def _allowed_mask(self, reqs, rows, n) -> Optional[np.ndarray]:
        """[n, V] allowed-token mask while a request is below its
        min_new_tokens (eos suppressed); None when no request needs one."""
        need = any(len(r.output_ids) < r.sampling.min_new_tokens
                   for r in reqs)
        if not need:
            return None
        mask = np.ones((n, self.cfg.vocab_size), bool)
        for r, j in zip(reqs, rows):
            if len(r.output_ids) < r.sampling.min_new_tokens:
                for eos in r.eos_ids:
                    if 0 <= eos < self.cfg.vocab_size:
                        mask[j, eos] = False
        return mask

    def _emit(self, reqs: List[Request], logits, row_ids) -> None:
        """Sample the first token for freshly extended lanes."""
        out = self.runner.sample_after_extend(
            logits, row_ids, _samp_arrays(reqs, len(reqs)),
            self._allowed_mask(reqs, range(len(reqs)), len(reqs)),
            all_greedy=all(r.sampling.temperature <= 0.0 for r in reqs),
            want_logprobs=any(r.logprobs for r in reqs))
        for i, req in enumerate(reqs):
            self._accept_token(req, int(out[0][i]), float(out[1][i]),
                               out[2][i], out[3][i])

    def _accept_token(self, req: Request, tok: int, logprob: float,
                      top_lp, top_ids) -> None:
        req.output_ids.append(tok)
        self._gen_total += 1
        if req.logprobs:
            req.output_logprobs.append(logprob)
            req.output_top_logprobs.append(
                [(int(i), float(v)) for i, v in zip(top_ids, top_lp)])
        req.check_finished()
        self._check_stop_strs(req)

    def _check_stop_strs(self, req: Request) -> None:
        """Finish a request whose output holds one of its stop strings
        (the reference's StopWordStoppingCriteria / OpenAI `stop`). Only a
        bounded tail is decoded a token, as the reference does: a stop of C
        characters spans at most C non-special tokens, and the window is
        padded for tokens of several characters."""
        if req.finished is not None or not req.stop_strs:
            return
        window = 2 * max(len(stop) for stop in req.stop_strs) + 16
        text = self.tokenizer.decode(req.output_ids[-window:],
                                     skip_special_tokens=True)
        for stop in req.stop_strs:
            if stop in text:
                req.finished = FinishReason.EOS
                req.stop_trim = stop
                return

    # -- decode --------------------------------------------------------------

    def _decode(self) -> None:
        active = [r for r in self.row_reqs if r is not None
                  and r.finished is None and r.output_ids]
        if not active:
            return
        B = self.ecfg.max_batch
        tokens = np.zeros((B,), np.int64)
        positions = np.zeros((B,), np.int32)
        act = np.zeros((B,), bool)
        rows = []
        for req in active:
            b = req.batch_row
            pos = req.seq_len - 1          # position of the new token
            if pos >= self.ecfg.s_row:
                req.finished = FinishReason.LENGTH
                continue
            tokens[b] = req.output_ids[-1]
            positions[b] = pos
            act[b] = True
            rows.append(req)
        if not rows:
            return
        row_list = [r.batch_row for r in rows]
        allowed = self._allowed_mask(rows, row_list, B)
        K = self.ecfg.decode_steps
        if allowed is not None:
            K = 1  # a per-step mask cannot lag
        K = max(1, min(K, min(r.max_new_tokens - len(r.output_ids)
                              for r in rows)))
        steps = self.runner.decode_block(
            tokens, positions, act, _samp_arrays(rows, B, row_list), K,
            allowed, all_greedy=all(r.sampling.temperature <= 0.0
                                    for r in rows),
            want_logprobs=any(r.logprobs for r in rows))
        for s, tlp, toplp, topids in steps:
            for req in rows:
                if req.finished is not None:
                    continue  # finished inside the block: discard the rest
                b = req.batch_row
                self._accept_token(req, int(s[b]), float(tlp[b]),
                                   toplp[b], topids[b])
        self._steps += K

    def _release(self, req: Request) -> None:
        """Free the request's row, first caching the prompt KV it extended
        (best effort). The prefix lock is held through the eviction and
        the insert, so that eviction cannot take the very prefix being
        extended; it is dropped whatever happens."""
        row = req.batch_row
        if 0 <= row < len(self.row_reqs) and self.row_reqs[row] is req:
            self.row_reqs[row] = None
        try:
            # a request aborted while waiting, or whose admission failed,
            # holds no lock and extended nothing
            if req.prefix_locked and row >= 0 and self.pool is not None:
                self._cache_prompt(req, row)
        finally:
            self._unlock(req)

    def _cache_prompt(self, req: Request, row: int) -> None:
        """Copy the extended part of the prompt's KV into fresh pool slots
        and insert the prompt into the tree; evict when the pool is short,
        skip when it is full of locked prefixes, and free the slots of a
        prefix that another request cached meanwhile."""
        ids, n_cached = req.input_ids, req.n_cached
        n_new = len(ids) - n_cached
        if n_new <= 0:
            return
        if self.alloc.available() < n_new:
            self.radix.evict(n_new - self.alloc.available())
        slots = self.alloc.alloc(n_new)
        if slots is None:
            return
        chunk = max(self.ecfg.prefill_buckets)
        for start in range(0, n_new, chunk):
            _store_prompt(self.pool.planes, self.runner.rows, row,
                          n_cached + start, slots[start:start + chunk])
        full = np.concatenate([
            np.asarray(req.prefix_slots[:n_cached], np.int32), slots])
        dup = self.radix.insert(ids, full)
        if dup > n_cached:
            self.alloc.free(slots[:dup - n_cached])
