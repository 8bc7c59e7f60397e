"""Gemma-2 decoder (aurora_tpu/models/gemma2.py): its own offline forward,
its HF converter and its mapping onto the serving engine's universal
decoder (models/llama.py).

What sets it apart from the llama family (HF transformers Gemma2): the
embeddings scaled by sqrt(hidden) (the normalizer rounded to the model's
dtype first); RMSNorm multiplying by (1 + weight) in fp32; four norms a
layer (input, on the attention output, before and after the MLP); GeGLU
with the tanh GELU; the attention scale query_pre_attn_scalar ** -0.5;
tanh softcaps on the attention scores and on the final logits; sliding
windows on the even layers, global attention on the odd ones; head_dim
decoupled from hidden / heads; tied embeddings.

`gemma2_apply` computes attention in plain PyTorch (fp32 scores,
softcap, causal + window mask), as the reference's `_attention` does in
XLA: no TPU kernel serves the offline forward. The serving path goes
through `gemma2_serving_config` / `gemma2_serving_params` and the
engine's ragged kernels, which take the window per layer and the cap.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from aurora_tpu_torch.models.init import random_init_
from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel, _head_logits
from aurora_tpu_torch.ops.rope import apply_rope, rope_cos_sin

_NORMS = ("input_norm", "post_attn_norm", "pre_ffw_norm", "post_ffw_norm")
_PROJS = ("q", "k", "v", "o", "gate", "up", "down")


@dataclasses.dataclass(frozen=True)
class Gemma2Config:
    vocab_size: int = 256000
    hidden_size: int = 3584
    intermediate_size: int = 14336
    num_hidden_layers: int = 42
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    sliding_window: int = 4096
    query_pre_attn_scalar: float = 256.0
    attn_logit_softcapping: float = 50.0
    final_logit_softcapping: float = 30.0

    @classmethod
    def gemma2_9b(cls) -> "Gemma2Config":
        """google/gemma-2-9b (its config.json)."""
        return cls()

    @classmethod
    def gemma2_2b(cls) -> "Gemma2Config":
        """google/gemma-2-2b."""
        return cls(hidden_size=2304, intermediate_size=9216,
                   num_hidden_layers=26, num_attention_heads=8,
                   num_key_value_heads=4, query_pre_attn_scalar=256.0)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "Gemma2Config":
        return cls(vocab_size=vocab_size, hidden_size=64,
                   intermediate_size=128, num_hidden_layers=4,
                   num_attention_heads=4, num_key_value_heads=2,
                   head_dim=16, max_position_embeddings=128,
                   sliding_window=8, query_pre_attn_scalar=16.0)


class Gemma2Layer(nn.Module):
    def __init__(self, cfg: Gemma2Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, i, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
        nq, nkv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
        for name in _NORMS:         # HF's parameters: (1 + w) at use
            setattr(self, name, nn.Parameter(torch.zeros(d, **kw)))
        for name, (n_in, n_out) in (("q", (d, nq)), ("k", (d, nkv)),
                                    ("v", (d, nkv)), ("o", (nq, d)),
                                    ("gate", (d, i)), ("up", (d, i)),
                                    ("down", (i, d))):
            setattr(self, name, nn.Linear(n_in, n_out, bias=False, **kw))


class Gemma2Model(nn.Module):
    """Gemma2ForCausalLM's parameters: embed_tokens (also the head),
    layers of four norms and seven projections, final_norm."""

    def __init__(self, cfg: Gemma2Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(
            torch.zeros(cfg.vocab_size, cfg.hidden_size, **kw))
        self.layers = nn.ModuleList(Gemma2Layer(cfg, **kw)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.zeros(cfg.hidden_size, **kw))


@torch.no_grad()
def init_gemma2(cfg: Gemma2Config, generator: torch.Generator, device=None,
                dtype=None) -> Gemma2Model:
    """The reference's init_gemma2_params scheme from `generator`: every
    matrix and the embedding ~ N(0, 0.02²), the norm weights zero (so
    (1 + w) is one)."""
    model = Gemma2Model(cfg, device="meta", dtype=dtype).to_empty(
        device=device or "cuda")
    random_init_(model, generator)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in _NORMS + ("final_norm",):
            p.zero_()
    return model


def _gemma_norm(x, w, eps):
    """Gemma's RMSNorm: fp32 statistics, times (1 + w) in fp32."""
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + w.to(torch.float32))).to(x.dtype)


def _softcap(x, cap):
    return cap * torch.tanh(x / cap)


def _attention(cfg: Gemma2Config, q, k, v, sliding: bool, positions,
               kv_len: int, attention_mask, segment_ids, kv_segment_ids):
    """Softcapped attention in fp32 with the layer's window. q [B, T, Hq,
    hd]; k, v [B, S, Hkv, hd]; positions [B, T] global query positions."""
    B, T, Hq, hd = q.shape
    S = k.shape[1]
    if k.shape[2] != Hq:
        rep = Hq // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = cfg.query_pre_attn_scalar ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    logits = _softcap(logits, cfg.attn_logit_softcapping)
    qpos = positions[:, None, :, None]
    kpos = torch.arange(S, device=q.device)[None, None, None, :]
    mask = (kpos <= qpos) & (kpos < kv_len)
    # sliding layers see the trailing `sliding_window` tokens, the last
    # one included
    window = cfg.sliding_window if sliding else S + 1
    mask = mask & ((qpos - kpos) < window)
    if attention_mask is not None:
        mask = mask & attention_mask.to(torch.bool)[:, None, None, :]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, :, None]
                       == kv_segment_ids[:, None, None, :])
    logits = torch.where(mask, logits, torch.tensor(-2.38e38,
                                                    device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return out.to(q.dtype)


def gemma2_apply(model: Gemma2Model, cfg: Gemma2Config, *,
                 input_ids: Optional[torch.Tensor] = None,
                 inputs_embeds: Optional[torch.Tensor] = None,
                 attention_mask: Optional[torch.Tensor] = None,
                 position_ids: Optional[torch.Tensor] = None,
                 segment_ids: Optional[torch.Tensor] = None,
                 kv_cache: Optional[Dict[str, torch.Tensor]] = None,
                 cache_len: int = 0):
    """Forward → logits [B, T, V] fp32 (with `kv_cache`: (logits,
    kv_cache), the step's K/V written in place at [cache_len, cache_len +
    T)), the contract of models/llama.py `llama_apply`."""
    if kv_cache is not None and segment_ids is not None:
        raise ValueError("packed segments over a KV cache are unsupported: "
                         "the cache tracks no segment ids")
    x = model.embed_tokens[input_ids] if inputs_embeds is None \
        else inputs_embeds
    x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype,
                         device=x.device)
    B, T, _ = x.shape
    if position_ids is None:
        position_ids = (torch.arange(T, device=x.device)[None]
                        + cache_len).expand(B, T)
    cos, sin = rope_cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
    hq, hkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    eps = cfg.rms_norm_eps
    for l, lp in enumerate(model.layers):
        h = _gemma_norm(x, lp.input_norm, eps)
        q = lp.q(h).reshape(B, T, hq, hd)
        k = lp.k(h).reshape(B, T, hkv, hd)
        v = lp.v(h).reshape(B, T, hkv, hd)
        q, k = apply_rope(q, k, cos, sin)
        kv_len = T
        if kv_cache is not None:
            ck, cv = kv_cache["k"][l], kv_cache["v"][l]
            ck[:, cache_len:cache_len + T] = k.to(ck.dtype)
            cv[:, cache_len:cache_len + T] = v.to(cv.dtype)
            k, v = ck.to(k.dtype), cv.to(v.dtype)
            kv_len = cache_len + T
        attn = _attention(cfg, q, k, v, l % 2 == 0, position_ids, kv_len,
                          attention_mask, segment_ids, segment_ids)
        attn = lp.o(attn.reshape(B, T, hq * hd))
        x = x + _gemma_norm(attn, lp.post_attn_norm, eps)
        h = _gemma_norm(x, lp.pre_ffw_norm, eps)
        act = F.gelu(lp.gate(h).float(), approximate="tanh") * lp.up(h).float()
        x = x + _gemma_norm(lp.down(act.to(h.dtype)), lp.post_ffw_norm, eps)
    x = _gemma_norm(x, model.final_norm, eps)
    logits = _softcap(_head_logits(x, model.embed_tokens),
                      cfg.final_logit_softcapping)
    return logits if kv_cache is None else (logits, kv_cache)


# ---------------------------------------------------------------------------
# HF weight conversion
# ---------------------------------------------------------------------------

def gemma2_config_from_hf(cfg: Dict[str, Any]) -> Gemma2Config:
    return Gemma2Config(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim", 256),
        max_position_embeddings=cfg.get("max_position_embeddings", 8192),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 10000.0),
        sliding_window=cfg.get("sliding_window", 4096),
        query_pre_attn_scalar=cfg.get("query_pre_attn_scalar", 256.0),
        attn_logit_softcapping=cfg.get("attn_logit_softcapping", 50.0),
        final_logit_softcapping=cfg.get("final_logit_softcapping", 30.0))


def gemma2_params_from_hf(sd: Dict[str, torch.Tensor], cfg: Gemma2Config,
                          dtype=torch.bfloat16, device=None) -> Gemma2Model:
    """HF Gemma2ForCausalLM names → Gemma2Model (HF's [out, in] layout,
    nothing transposed)."""
    from aurora_tpu_torch.bridge import _load
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}
    out = {"embed_tokens": sd["embed_tokens.weight"],
           "final_norm": sd["norm.weight"]}
    names = (("input_norm", "input_layernorm.weight"),
             ("post_attn_norm", "post_attention_layernorm.weight"),
             ("pre_ffw_norm", "pre_feedforward_layernorm.weight"),
             ("post_ffw_norm", "post_feedforward_layernorm.weight"),
             ("q.weight", "self_attn.q_proj.weight"),
             ("k.weight", "self_attn.k_proj.weight"),
             ("v.weight", "self_attn.v_proj.weight"),
             ("o.weight", "self_attn.o_proj.weight"),
             ("gate.weight", "mlp.gate_proj.weight"),
             ("up.weight", "mlp.up_proj.weight"),
             ("down.weight", "mlp.down_proj.weight"))
    for i in range(cfg.num_hidden_layers):
        for ours, theirs in names:
            out[f"layers.{i}.{ours}"] = sd[f"layers.{i}.{theirs}"]
    return _load(Gemma2Model(cfg, device="meta", dtype=dtype), out, device)


# ---------------------------------------------------------------------------
# Serving-engine mapping (the universal decoder's config and layout)
# ---------------------------------------------------------------------------

def gemma2_serving_config(cfg: Gemma2Config) -> LlamaConfig:
    """Gemma2Config → the engine's LlamaConfig view."""
    return LlamaConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads,
        head_dim_override=cfg.head_dim,
        max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=cfg.rope_theta,
        tie_word_embeddings=True,
        sliding_window=cfg.sliding_window,
        swa_every_other=True,
        attn_logit_softcap=cfg.attn_logit_softcapping,
        final_logit_softcap=cfg.final_logit_softcapping,
        scale_embeddings=True,
        hidden_act="gelu_tanh",
        query_pre_attn_scalar=cfg.query_pre_attn_scalar,
        norm_upcast_mul=True)


def _one(w: nn.Parameter) -> nn.Parameter:
    """(1 + w) in fp32, rounded to w's dtype."""
    return nn.Parameter((1.0 + w.detach().float()).to(w.dtype),
                        requires_grad=False)


@torch.no_grad()
def gemma2_serving_params(model: Gemma2Model,
                          free_source: bool = False) -> LlamaModel:
    """Gemma2Model → the engine's LlamaModel. The (1 + w) norms are
    absorbed into new weights (the engine multiplies by w in fp32,
    norm_upcast_mul), and the four norms map to input_norm,
    post_attn_out_norm (the attention output), post_attn_norm (the MLP's
    input) and post_ffw_norm; the projections and the embedding are
    shared, not copied (free_source drops them from `model` as they
    move)."""
    cfg = gemma2_serving_config(model.cfg)
    out = LlamaModel(cfg, device="meta",
                     extras=("post_attn_out_norm", "post_ffw_norm"))
    out.embed_tokens = model.embed_tokens
    out.final_norm = _one(model.final_norm)
    for src, dst in zip(model.layers, out.layers):
        dst.input_norm = _one(src.input_norm)
        dst.post_attn_out_norm = _one(src.post_attn_norm)
        dst.post_attn_norm = _one(src.pre_ffw_norm)
        dst.post_ffw_norm = _one(src.post_ffw_norm)
        for name in _PROJS:
            setattr(dst, name, getattr(src, name))
            if free_source:
                setattr(src, name, None)
    return out
