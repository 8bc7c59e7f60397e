"""Llama-family decoder configuration and parameter layout
(aurora_tpu/models/llama.py). Vicuna-7B-v1.5-16k is the AuroraCap LLM.

Only the llama case is ported (RMSNorm, SiLU-gated MLP, rotary with
optional linear scaling, GQA, no biases), with two attention options of
other members of the family: Mistral's sliding window (`sliding_window`,
the same width in every layer) and the tanh softcap of the attention
logits (`attn_logit_softcap`). The reference stacks layers as
[L, ...] arrays with dense kernels [in, out]; here each layer is a module
of `nn.Linear`s ([out, in] weights), or, for W4 serving, of `W4Linear`s
(nibble-packed int4 + group scales, the port's layout of
ops/pallas/quant_matmul.py), or, for W8 serving, of `W8Linear`s (int8 +
per-output-channel scales); both quantized models have an int8
`W8Linear` LM head. A layer
holds either the per-name projections (q, k, v, o, gate, up, down) or the
fused serving streams (qkv, o, gateup, down); a W4 layer may hold its
gateup and down as one `W4FusedMLP` (`mlp`). A sequence-classification
checkpoint adds a `score` head [num_labels, D] (the /v1/classify endpoint
of serve/api.py reads it over `llama_apply(..., return_hidden=True)`).

The serving forward over KV rows lives in serve/engine.py. Here is the
offline forward `llama_apply`, the training and scoring path and, over a
dense KV cache (`init_kv_cache`), the offline generation path of
generate/: attention through `ops.attention.mha` (the flash kernels on
the card for unmasked calls), per-layer remat (models/remat.py), fp32
logits. `llama_lm_loss` is the shifted cross-entropy. Dense bf16/fp32
layers only; W4/W8 layers raise NotImplementedError there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import sdpa_kernel

from aurora_tpu_torch.models.remat import remat_call
from aurora_tpu_torch.ops.attention import REPEATABLE_SDPA, mha
from aurora_tpu_torch.ops.norms import family_act, family_norm
from aurora_tpu_torch.ops.pallas.quant_matmul import (MAX_TOKENS,
                                                      fused_mlp_w4,
                                                      w4_mlp_untile_layout)
from aurora_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from aurora_tpu_torch.utils.constants import IGNORE_INDEX


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 16384
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_linear_scaling: Optional[float] = None
    tie_word_embeddings: bool = False
    # Mistral's sliding window: a query at position p attends to the keys
    # in (p - w, p]; None or 0 is full causal attention
    sliding_window: Optional[int] = None
    # c > 0: each attention score s becomes c * tanh(s / c) before the mask
    attn_logit_softcap: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def attn_scale(self) -> float:
        return float(self.head_dim) ** -0.5

    @classmethod
    def vicuna_7b_v15_16k(cls) -> "LlamaConfig":
        """lmsys/vicuna-7b-v1.5-16k, the AuroraCap-7B decoder."""
        return cls(rope_linear_scaling=4.0)

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        """mistralai/Mistral-7B-v0.1: the llama decoder with GQA 32/8 and
        a sliding window of 4096 in every layer."""
        return cls(vocab_size=32000, hidden_size=4096,
                   intermediate_size=14336, num_hidden_layers=32,
                   num_attention_heads=32, num_key_value_heads=8,
                   max_position_embeddings=32768, rope_theta=10000.0,
                   sliding_window=4096)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "LlamaConfig":
        return cls(vocab_size=vocab_size, hidden_size=64,
                   intermediate_size=128, num_hidden_layers=3,
                   num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=512)


W4_GROUP = 128        # input rows per W4 scale group (the reference's)


def w4_group(in_features: int) -> int:
    """The reference's W4 group size: min(128, in_features)."""
    return min(W4_GROUP, in_features)


class W4Linear(nn.Module):
    """y = x @ W^T with W nibble-packed int4 (even input row in the low
    nibble), in one of two layouts (see ops/pallas/quant_matmul.py):
    the port's stripes, `packed` [out, in/2] int8 and `scale` [out, G]
    fp32 for G groups of in/G input rows; or the reference's flat layout
    (`EngineConfig(w4_tiled=False)`), `packed` [G, g/2, out] and `scale`
    [G, 1, out]. The engine's `_w4dot` computes with either."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale)

    @property
    def flat(self) -> bool:
        return self.packed.dim() == 3

    @classmethod
    def empty(cls, in_features: int, out_features: int,
              device=None) -> "W4Linear":
        group = w4_group(in_features)
        if in_features % group or group % 2:
            raise ValueError(f"in_features={in_features} does not split "
                             f"into groups of {group}")
        return cls(torch.zeros((out_features, in_features // 2),
                               dtype=torch.int8, device=device),
                   torch.zeros((out_features, in_features // group),
                               dtype=torch.float32, device=device))


class W4FusedMLP(nn.Module):
    """A layer's W4 gateup and down in the fused-MLP layout of
    ops/pallas/quant_matmul.py `w4_mlp_tile_layout` (mgu [Ib, 2ti, D/2],
    mgs [Ib, G, 2ti], mdw [Gd, gd/2, D], mds [Gd, 1, D]): decode runs the
    whole MLP as one `fused_mlp_w4` call (`EngineConfig(w4_fused_mlp=
    True)`). It takes the place of the layer's gateup and down."""

    def __init__(self, mgu, mgs, mdw, mds):
        super().__init__()
        for name, t in (("mgu", mgu), ("mgs", mgs), ("mdw", mdw),
                        ("mds", mds)):
            self.register_buffer(name, t)

    def tensors(self):
        return self.mgu, self.mgs, self.mdw, self.mds

    def untile(self) -> Tuple["W4Linear", "W4Linear"]:
        """(gateup, down) as flat W4Linears over the same bytes."""
        gu_pk, gu_s, dn_pk, dn_s = w4_mlp_untile_layout(*self.tensors())
        return W4Linear(gu_pk, gu_s), W4Linear(dn_pk, dn_s)


class W8Linear(nn.Module):
    """y = x @ W^T with W int8 per output channel: `weight` [out, in]
    int8 and `scale` [out] fp32 (the W8 projections and the W8A8 LM head
    of both quantized trees). The engine's `_w8dot` computes with it."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale)

    @classmethod
    def empty(cls, in_features: int, out_features: int,
              device=None) -> "W8Linear":
        return cls(torch.zeros((out_features, in_features), dtype=torch.int8,
                               device=device),
                   torch.zeros((out_features,), dtype=torch.float32,
                               device=device))


def projection_shapes(cfg: LlamaConfig,
                      fused: bool) -> Dict[str, Tuple[int, int]]:
    """(in, out) of each projection of a layer: per name, or the fused
    serving streams (qkv = q ‖ k ‖ v, gateup = gate ‖ up on the output
    axis)."""
    d, i, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    if fused:
        return {"qkv": (d, nq + 2 * nkv), "o": (nq, d),
                "gateup": (d, 2 * i), "down": (i, d)}
    return {"q": (d, nq), "k": (d, nkv), "v": (d, nkv), "o": (nq, d),
            "gate": (d, i), "up": (d, i), "down": (i, d)}


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 weight_quant: str = "none", fused: bool = False):
        super().__init__()
        d = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.input_norm = nn.Parameter(torch.ones(d, **kw))
        self.post_attn_norm = nn.Parameter(torch.ones(d, **kw))
        for name, (n_in, n_out) in projection_shapes(cfg, fused).items():
            if weight_quant == "int4":
                proj = W4Linear.empty(n_in, n_out, device=device)
            elif weight_quant == "int8":
                proj = W8Linear.empty(n_in, n_out, device=device)
            else:
                proj = nn.Linear(n_in, n_out, bias=False, **kw)
            setattr(self, name, proj)


class LlamaModel(nn.Module):
    """Parameters of the decoder; the forward is the serving engine's.
    weight_quant="int4" lays the layers out as W4Linear projections (per
    name, or fused with fused=True), "int8" as W8Linear ones; both with a
    W8Linear LM head. num_labels > 0 adds the classification head `score`
    (LlamaForSequenceClassification's score.weight, [num_labels, D])."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 weight_quant: str = "none", fused: bool = False,
                 num_labels: int = 0):
        super().__init__()
        if cfg.tie_word_embeddings:
            raise NotImplementedError("tied embeddings are not ported")
        if weight_quant not in ("none", "int4", "int8"):
            raise NotImplementedError(
                f"weight_quant={weight_quant!r}: none, int4 or int8")
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.zeros(cfg.vocab_size, d, **kw))
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, weight_quant=weight_quant, fused=fused, **kw)
            for _ in range(cfg.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(d, **kw))
        if weight_quant != "none":
            self.lm_head = W8Linear.empty(d, cfg.vocab_size, device=device)
        else:
            self.lm_head = nn.Linear(d, cfg.vocab_size, bias=False, **kw)
        if num_labels > 0:
            self.score = nn.Linear(d, num_labels, bias=False, **kw)


def _dense(h, proj):
    return proj(h)


def layer_qkv(cfg: LlamaConfig, lp: LlamaLayer, h, dot=_dense):
    """h [B, T, D] → q [B, T, H, hd], k, v [B, T, Hkv, hd] through the
    per-name or the fused (qkv) projections; `dot(h, proj)` computes one
    projection (the serving engine passes its W4-aware one)."""
    B, T, _ = h.shape
    H, Hkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    if hasattr(lp, "qkv"):          # fused stream
        q, k, v = dot(h, lp.qkv).split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
    else:
        q, k, v = dot(h, lp.q), dot(h, lp.k), dot(h, lp.v)
    return (q.reshape(B, T, H, hd), k.reshape(B, T, Hkv, hd),
            v.contiguous().reshape(B, T, Hkv, hd))


def layer_mlp(cfg: LlamaConfig, lp: LlamaLayer, h, dot=_dense):
    """The SiLU-gated MLP, per-name, fused (gateup) or a W4FusedMLP (the
    reference's `_mlp`): with a W4FusedMLP, at most MAX_TOKENS tokens
    run as one `fused_mlp_w4` call; more (prefill) untile the weights and
    run gateup and down through `dot`, silu(gate)·up in h's dtype between
    them."""
    if hasattr(lp, "mlp"):          # fused-MLP W4 layout
        lead = h.shape[:-1]
        if math.prod(lead) <= MAX_TOKENS:
            out = fused_mlp_w4(h.reshape(-1, h.shape[-1]), *lp.mlp.tensors())
            return out.reshape(*lead, -1)
        gateup, down = lp.mlp.untile()
        gate, up = dot(h, gateup).chunk(2, dim=-1)
        return dot(family_act(cfg, gate) * up, down)
    if hasattr(lp, "gateup"):       # fused stream
        gate, up = dot(h, lp.gateup).chunk(2, dim=-1)
    else:
        gate, up = dot(h, lp.gate), dot(h, lp.up)
    return dot(family_act(cfg, gate) * up, lp.down)


def _layer(cfg: LlamaConfig, lp: LlamaLayer, x, cos, sin, mask,
           segment_ids, use_flash, kv=None, cache_len: int = 0):
    """One decoder layer. kv: this layer's (k, v) cache [B, S, Hkv, hd],
    written in place at [cache_len, cache_len + T) and attended whole."""
    B, T, _ = x.shape
    q, k, v = layer_qkv(cfg, lp, family_norm(cfg, x, lp.input_norm))
    q, k = apply_rope(q, k, cos, sin)
    if kv is not None:
        ck, cv = kv
        ck[:, cache_len:cache_len + T] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + T] = v.to(cv.dtype)
        k, v = ck.to(k.dtype), cv.to(v.dtype)
    attn = mha(q, k, v, causal=True, mask=mask, q_segment_ids=segment_ids,
               kv_segment_ids=segment_ids, q_offset=cache_len,
               scale=cfg.attn_scale, logit_cap=cfg.attn_logit_softcap,
               use_flash=use_flash)
    x = x + lp.o(attn.reshape(B, T, -1))
    return x + layer_mlp(cfg, lp, family_norm(cfg, x, lp.post_attn_norm))


class _Fp32Logits(torch.autograd.Function):
    """x [N, D] @ W^T accumulated and returned in fp32 for bf16/fp16 x and
    W, as the reference's dot with preferred_element_type=f32; the
    backward rounds the fp32 cotangent to the input dtype and runs its two
    matmuls in it (what the TPU's default matmul precision does)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = g.t() @ x if ctx.needs_input_grad[1] else None
        return dx, dw


def _head_logits(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Logits in fp32: fp32 inputs through F.linear, narrower ones through
    `_Fp32Logits` (no rounding of the logits to the input dtype)."""
    if x.dtype == torch.float32:
        return F.linear(x, weight)
    lead = x.shape[:-1]
    out = _Fp32Logits.apply(x.reshape(-1, x.shape[-1]), weight)
    return out.reshape(*lead, -1)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """A dense KV cache {"k", "v"}: [L, batch, max_len, Hkv, hd] zeros."""
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def llama_apply(model: LlamaModel, cfg: LlamaConfig, *,
                input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                kv_cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: int = 0,
                remat=False,
                use_flash: Optional[bool] = None,
                return_hidden: bool = False):
    """Forward pass → logits [B, T, V] fp32; with `kv_cache`, (logits,
    kv_cache). return_hidden=True skips the LM head and returns the hidden
    states after the final norm [B, T, D] in their place (the embedding
    and classification endpoints).

    attention_mask bool, True = attend: a key-side padding mask [B, T],
    or [B, S] over the cache's S slots when `kv_cache` is given; it sends
    attention to `mha_reference`, as in the reference. position_ids [B, T]
    (default cache_len..cache_len+T-1); segment_ids [B, T]: packed
    sequences attend within their segment (not with a cache). kv_cache:
    from `init_kv_cache`; the step's K/V are written in place at slots
    [cache_len, cache_len + T) and the queries sit at those slots for the
    causal mask; attention then keeps SDPA off cuDNN (`REPEATABLE_SDPA`).
    remat: False, True/"full" or a policy name (models/remat.py), per
    layer. use_flash: None lets `mha` decide. A sliding window (a key mask on (query - key) slot, as in the
    reference) or a logit softcap keeps attention off the flash kernels,
    which take neither.
    """
    if kv_cache is not None and segment_ids is not None:
        raise ValueError("packed segments over a KV cache are unsupported: "
                         "the cache tracks no segment ids")
    if any(not isinstance(m, nn.Linear) for lp in model.layers
           for m in lp.children()) or not isinstance(model.lm_head,
                                                     nn.Linear):
        raise NotImplementedError("llama_apply runs dense layers only; "
                                  "W4/W8 (QLoRA) layers are not ported")
    x = model.embed_tokens[input_ids] if inputs_embeds is None \
        else inputs_embeds
    B, T, _ = x.shape
    if position_ids is None:
        position_ids = (torch.arange(T, device=x.device)[None]
                        + cache_len).expand(B, T)
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_linear_scaling)
    mask = None
    if attention_mask is not None:
        mask = attention_mask.to(torch.bool)[:, None, None, :]
    if cfg.sliding_window:
        S = T if kv_cache is None else kv_cache["k"].shape[2]
        qpos = torch.arange(T, device=x.device)[:, None] + cache_len
        kpos = torch.arange(S, device=x.device)[None, :]
        wmask = ((qpos - kpos) < cfg.sliding_window)[None, None]
        mask = wmask if mask is None else mask & wmask
    if cfg.sliding_window or cfg.attn_logit_softcap > 0:
        use_flash = False
    if kv_cache is None:
        for lp in model.layers:
            x = remat_call(_layer, remat, cfg, lp, x, cos, sin, mask,
                           segment_ids, use_flash)
    else:
        with sdpa_kernel(REPEATABLE_SDPA):
            for i, lp in enumerate(model.layers):
                x = _layer(cfg, lp, x, cos, sin, mask, None, use_flash,
                           (kv_cache["k"][i], kv_cache["v"][i]), cache_len)
    x = family_norm(cfg, x, model.final_norm)
    out = x if return_hidden else _head_logits(x, model.lm_head.weight)
    return out if kv_cache is None else (out, kv_cache)


def llama_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                  reduce: bool = True):
    """Shifted next-token cross-entropy with IGNORE_INDEX (-100) masking →
    (mean loss over the valid tokens, their count); reduce=False gives the
    per-token losses [B, T-1] instead of the mean."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0)
    logp = torch.log_softmax(shift_logits, dim=-1)
    token_ll = logp.gather(-1, safe[..., None])[..., 0]
    token_loss = torch.where(valid, -token_ll, 0.0)
    n = valid.sum()
    if reduce:
        return token_loss.sum() / n.clamp_min(1), n
    return token_loss, n
