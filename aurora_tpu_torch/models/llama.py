"""Llama-family decoder configuration and parameter layout
(aurora_tpu/models/llama.py), the universal dense decoder of the model
zoo. Vicuna-7B-v1.5-16k is the AuroraCap LLM.

`LlamaConfig` carries every dense knob of the reference's config: qkv
biases (Qwen2), per-head q/k norms (Qwen3, Cohere), the norm kind
(RMSNorm, LayerNorm with or without a bias, Cohere's), partial and
interleaved rotary (StableLM, GLM), OLMo's qkv clamp, the non-gated MLP
(StarCoder2, GPT-BigCode), a head_dim decoupled from hidden / heads,
Gemma's GeGLU, (1 + w) norms, embedding scale, query_pre_attn_scalar,
alternating sliding windows and logit softcaps, Cohere's parallel block
and logit scale, GPT-BigCode's learned positions, MiniCPM's embedding,
residual and logit scales, and tied embeddings; the sparse-MoE knobs
(experts, top-k, the router's mode, renormalization and softcap, the
dense prefix of DeepSeek v1); and the MLA and YaRN knobs of DeepSeek-V2's
serving config (serve/mla.py runs those models).

A MoE layer (every layer from `first_k_dense` on when num_experts > 0)
holds, in place of gate/up/down, the router `moe_router` [D, E] and the
expert stacks `moe_gate`, `moe_up` [E, D, F] and `moe_down` [E, F, D]
(ops/moe.py `ExpertStack`: float, or int8 with per-(expert, channel)
scales in both quantized layouts), and, where the family has one, the
shared expert as one-expert stacks `moe_shared_gate`/`_up`/`_down` with
Qwen2-MoE's scalar gate `moe_shared_gate_w` [D, 1]; the router and that
gate stay float. The expert width F and the shared width come from the
checkpoint (`moe_layout`), by default the config's intermediate_size and
no shared expert, as the reference's initializer makes them.

The reference stacks layers as [L, ...] arrays with dense kernels [in,
out]; here each layer is a module of `nn.Linear`s ([out, in] weights),
or, for W4 serving, of `W4Linear`s (nibble-packed int4 + group scales,
the port's layout of ops/pallas/quant_matmul.py), or, for W8 serving, of
`W8Linear`s (int8 + per-output-channel scales); both quantized models
have an int8 `W8Linear` LM head unless the head is tied to the
embeddings. A layer holds either the per-name projections (q, k, v, o,
gate, up, down; no gate for a non-gated MLP) or the fused serving streams
(qkv, o, gateup, down); a W4 layer may hold its gateup and down as one
`W4FusedMLP` (`mlp`). The family's extra parameters carry the
reference's names (`LAYER_EXTRAS`, `TOP_EXTRAS`: biases, q/k norms, norm
biases, Gemma-2's `post_attn_out_norm` and `post_ffw_norm`, `wpe`) and
stay in the model's dtype whatever the weights' quantization. A
sequence-classification checkpoint adds a `score` head [num_labels, D]
(the /v1/classify endpoint of serve/api.py reads it over
`llama_apply(..., return_hidden=True)`).

The serving forward over KV rows lives in serve/engine.py; it shares
`layer_qkv`, `layer_attn_out`, `layer_mlp` and `dnorm` with the offline
forward here, `llama_apply`, the training and scoring path and, over a
dense KV cache (`init_kv_cache`), the offline generation path of
generate/: attention through `ops.attention.mha` (the flash kernels on
the card for unmasked calls), per-layer remat (models/remat.py), fp32
logits. `llama_lm_loss` is the shifted cross-entropy. There a
projection is any module that maps h to h @ W: an `nn.Linear`, or the
training modules that stand in for one, train/lora.py's `LoraLinear` (W
plus the adapter's delta) and train/quant.py's `QuantLinear` (a frozen
int8/int4 weight dequantized when the layer runs, so one projection's
float weight exists at a time, plus the LoRA delta); the serving W4/W8
layouts raise NotImplementedError there.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import sdpa_kernel

from aurora_tpu_torch.models.remat import remat_call
from aurora_tpu_torch.ops.attention import REPEATABLE_SDPA, mha
from aurora_tpu_torch.ops.moe import (ExpertStack, moe_mlp, moe_mlp_grouped,
                                     shared_expert_mlp)
from aurora_tpu_torch.ops.norms import (cohere_layer_norm, family_act,
                                       family_norm, rms_norm)
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
    qkv_bias: bool = False          # Qwen2: q/k/v projection biases
    qk_norm: bool = False           # Qwen3 / Cohere: per-head q/k norm
    # "rmsnorm"; "layernorm": torch LayerNorm with a `<norm>_bias` param
    # (OLMo's non-parametric LN holds ones and zeros); "cohere"
    norm_type: str = "rmsnorm"
    partial_rotary_factor: float = 1.0  # rotate the first rd dims only
    rope_interleaved: bool = False      # GLM / Cohere adjacent-pair lanes
    clip_qkv: Optional[float] = None    # OLMo: q, k, v clamped to ±c
    mlp_style: str = "gated"            # "mlp": up → act → down
    # Mistral's sliding window: a query at position p attends to the keys
    # in (p - w, p]; None or 0 is full causal attention
    sliding_window: Optional[int] = None
    head_dim_override: Optional[int] = None  # head_dim ≠ hidden / heads
    # c > 0: each attention score s becomes c * tanh(s / c) before the mask
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0    # the same on the LM head's logits
    scale_embeddings: bool = False      # Gemma: embeds * sqrt(hidden)
    hidden_act: str = "silu"            # "gelu_tanh" (GeGLU), "gelu"
    query_pre_attn_scalar: Optional[float] = None  # scale = this ** -0.5
    swa_every_other: bool = False       # Gemma-2: even layers slide
    norm_upcast_mul: bool = False       # RMSNorm weight multiply in fp32
    parallel_block: bool = False        # Cohere: x + attn(h) + mlp(h)
    logit_scale: Optional[float] = None  # Cohere / MiniCPM logit scale
    learned_pos: bool = False           # GPT-BigCode: wpe, no rotary
    embed_scale: Optional[float] = None     # MiniCPM scale_emb
    residual_scale: Optional[float] = None  # MiniCPM scale_depth/sqrt(L)
    # --- sparse MoE (Mixtral, Qwen-MoE, DBRX, Grok-1, DeepSeek v1) ---
    num_experts: int = 0                # > 0: the layers' MLP is routed
    num_experts_per_tok: int = 2
    # "mixtral": top-k of the logits, softmax over them; "softmax_topk":
    # fp32 softmax over every expert, then top-k; "deepseek": the MLA
    # serving config's routing (serve/mla.py)
    moe_router_mode: str = "mixtral"
    moe_routed_scaling: float = 1.0     # DeepSeek: routed weights × this
    moe_norm_topk: bool = False         # renormalize the top-k weights
    moe_topk_method: str = "greedy"     # or "group_limited_greedy"
    moe_n_group: int = 1
    moe_topk_group: int = 1
    first_k_dense: int = 0              # DeepSeek v1: dense leading layers
    moe_router_logit_softcap: float = 0.0   # Grok-1: c·tanh(l/c) routing
    # --- DeepSeek-V2's multi-head latent attention (serve/mla.py maps a
    # DeepseekV2Config here): with mla_kv_lora_rank set the engine caches
    # one latent + rope vector a token (num_key_value_heads 1, head_dim
    # rank + rope) and runs the absorbed attention ---
    mla_kv_lora_rank: Optional[int] = None
    mla_q_lora_rank: Optional[int] = None
    mla_qk_nope_head_dim: int = 0
    mla_qk_rope_head_dim: int = 0
    mla_v_head_dim: int = 0
    mla_first_k_dense: int = 0
    # YaRN: explicit rotary frequencies and the cos/sin scale
    # (ops/rope.py `yarn_inv_freq`); MLA's interleaved rotary reads them
    rope_inv_freq: Optional[tuple] = None
    rope_attention_scaling: float = 1.0

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)

    @property
    def attn_scale(self) -> float:
        base = (self.query_pre_attn_scalar
                if self.query_pre_attn_scalar is not None
                else self.head_dim)
        return float(base) ** -0.5

    @classmethod
    def vicuna_7b_v15_16k(cls) -> "LlamaConfig":
        """lmsys/vicuna-7b-v1.5-16k, the AuroraCap-7B decoder."""
        return cls(rope_linear_scaling=4.0)

    @classmethod
    def qwen2_7b(cls) -> "LlamaConfig":
        """Qwen/Qwen2-7B-Instruct: the llama decoder with qkv biases and
        GQA 28/4 (G 7), rope theta 1e6."""
        return cls(vocab_size=152064, hidden_size=3584,
                   intermediate_size=18944, num_hidden_layers=28,
                   num_attention_heads=28, num_key_value_heads=4,
                   max_position_embeddings=32768, rms_norm_eps=1e-6,
                   rope_theta=1e6, qkv_bias=True)

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


def projection_shapes(cfg: LlamaConfig, fused: bool,
                      moe: bool = False) -> Dict[str, Tuple[int, int]]:
    """(in, out) of each projection of a layer: per name, or the fused
    serving streams (qkv = q ‖ k ‖ v, gateup = gate ‖ up on the output
    axis); a non-gated MLP has up and down only, a MoE layer (moe) the
    attention's alone (its experts are ExpertStacks)."""
    d, i, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    gated = cfg.mlp_style == "gated"
    if moe:
        return ({"qkv": (d, nq + 2 * nkv), "o": (nq, d)} if fused else
                {"q": (d, nq), "k": (d, nkv), "v": (d, nkv), "o": (nq, d)})
    if fused:
        mlp = {"gateup": (d, 2 * i)} if gated else {"up": (d, i)}
        return {"qkv": (d, nq + 2 * nkv), "o": (nq, d), **mlp,
                "down": (i, d)}
    mlp = {"gate": (d, i), "up": (d, i)} if gated else {"up": (d, i)}
    return {"q": (d, nq), "k": (d, nkv), "v": (d, nkv), "o": (nq, d),
            **mlp, "down": (i, d)}


def extra_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the family parameters a layer (LAYER_EXTRAS) or the model
    (TOP_EXTRAS) may hold, by the reference's names."""
    d, i, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    H, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    per_head = cfg.norm_type == "cohere"
    return {"q_bias": (H * hd,), "k_bias": (Hkv * hd,),
            "v_bias": (Hkv * hd,), "qkv_bias": ((H + 2 * Hkv) * hd,),
            "o_bias": (d,), "up_bias": (i,), "down_bias": (d,),
            "q_norm": (H, hd) if per_head else (hd,),
            "k_norm": (Hkv, hd) if per_head else (hd,),
            "input_norm_bias": (d,), "post_attn_norm_bias": (d,),
            "post_attn_out_norm": (d,), "post_ffw_norm": (d,),
            "final_norm_bias": (d,),
            "wpe": (cfg.max_position_embeddings, d)}


LAYER_EXTRAS = ("q_bias", "k_bias", "v_bias", "qkv_bias", "o_bias",
                "up_bias", "down_bias", "q_norm", "k_norm",
                "input_norm_bias", "post_attn_norm_bias",
                "post_attn_out_norm", "post_ffw_norm")
TOP_EXTRAS = ("final_norm_bias", "wpe")


def default_extras(cfg: LlamaConfig, fused: bool = False) -> Tuple[str, ...]:
    """The family parameters the reference's converters give a config:
    qkv biases; q/k norms; LayerNorm biases; a biased non-gated MLP (o, up
    and down biases, StarCoder2 / GPT-BigCode); learned positions.
    Gemma-2's output norms come with its serving mapping
    (models/gemma2.py `gemma2_serving_params`)."""
    out = []
    if cfg.qkv_bias:
        out += ["qkv_bias"] if fused else ["q_bias", "k_bias", "v_bias"]
        if cfg.mlp_style == "mlp":
            out += ["o_bias", "up_bias", "down_bias"]
    if cfg.qk_norm:
        out += ["q_norm", "k_norm"]
    if cfg.norm_type == "layernorm":
        out += ["input_norm_bias", "final_norm_bias"]
        if not cfg.parallel_block:
            out += ["post_attn_norm_bias"]
    if cfg.learned_pos:
        out += ["wpe"]
    return tuple(out)


def extras_of(model: nn.Module) -> Tuple[str, ...]:
    """The family parameters `model` (a LlamaModel) holds."""
    names = {n for n, _ in model.named_parameters(recurse=False)}
    for lp in (model.layers[0], model.layers[-1]):
        names |= {n for n, _ in lp.named_parameters(recurse=False)}
    return tuple(n for n in LAYER_EXTRAS + TOP_EXTRAS if n in names)


def is_moe_layer(cfg: LlamaConfig, l: int) -> bool:
    """Layer l routes its MLP: every layer past the dense prefix of a
    config with experts."""
    return cfg.num_experts > 0 and l >= cfg.first_k_dense


def moe_layout(model: nn.Module) -> Dict[str, int]:
    """The MoE widths of `model` (LlamaModel's moe_inter, shared_inter and
    shared_gate), read from its last layer; {} for a dense model."""
    lp = model.layers[-1]
    if not hasattr(lp, "moe_router"):
        return {}
    shared = getattr(lp, "moe_shared_gate", None)
    return {"moe_inter": lp.moe_gate.weight.shape[2],
            "shared_inter": 0 if shared is None else
            shared.weight.shape[2],
            "shared_gate": hasattr(lp, "moe_shared_gate_w")}


def _extra_param(shape, name, kw) -> nn.Parameter:
    fill = torch.zeros if name.endswith("bias") or name == "wpe" \
        else torch.ones
    return nn.Parameter(fill(shape, **kw))


class LlamaLayer(nn.Module):
    """One decoder layer's parameters. moe: the routed layout (router,
    expert stacks of width moe_inter, the shared expert of width
    shared_inter > 0 with its scalar gate if shared_gate); its experts are
    int8 under either weight_quant."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 weight_quant: str = "none", fused: bool = False,
                 extras: Tuple[str, ...] = (), moe: bool = False,
                 moe_inter: Optional[int] = None, shared_inter: int = 0,
                 shared_gate: bool = False):
        super().__init__()
        d = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.input_norm = nn.Parameter(torch.ones(d, **kw))
        if not cfg.parallel_block:    # Cohere: one norm feeds both
            self.post_attn_norm = nn.Parameter(torch.ones(d, **kw))
        shapes = extra_shapes(cfg)
        for name in extras:
            if name in LAYER_EXTRAS:
                setattr(self, name, _extra_param(shapes[name], name, kw))
        if moe:
            E, F_ = cfg.num_experts, moe_inter or cfg.intermediate_size
            q = weight_quant != "none"
            self.moe_router = nn.Parameter(torch.zeros(d, E, **kw))
            self.moe_gate = ExpertStack.empty(E, d, F_, q, **kw)
            self.moe_up = ExpertStack.empty(E, d, F_, q, **kw)
            self.moe_down = ExpertStack.empty(E, F_, d, q, **kw)
            if shared_inter:
                self.moe_shared_gate = ExpertStack.empty(1, d, shared_inter,
                                                         q, **kw)
                self.moe_shared_up = ExpertStack.empty(1, d, shared_inter,
                                                       q, **kw)
                self.moe_shared_down = ExpertStack.empty(1, shared_inter, d,
                                                         q, **kw)
                if shared_gate:
                    self.moe_shared_gate_w = nn.Parameter(
                        torch.zeros(d, 1, **kw))
        for name, (n_in, n_out) in projection_shapes(cfg, fused,
                                                     moe).items():
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
    W8Linear LM head, none with tied embeddings (the head is then
    `embed_tokens`). extras: the family parameters to hold (LAYER_EXTRAS
    and TOP_EXTRAS names; default `default_extras(cfg, fused)`).
    num_labels > 0 adds the classification head `score`
    (LlamaForSequenceClassification's score.weight, [num_labels, D]).
    With experts, layers from cfg.first_k_dense on are MoE layers
    (moe_inter, shared_inter, shared_gate: see LlamaLayer); the dense
    prefix before them (`dense_layers`) stays float and per-name under
    any weight_quant, as the reference leaves its `dense_layers`."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 weight_quant: str = "none", fused: bool = False,
                 num_labels: int = 0, extras=None,
                 moe_inter: Optional[int] = None, shared_inter: int = 0,
                 shared_gate: bool = False):
        super().__init__()
        if weight_quant not in ("none", "int4", "int8"):
            raise NotImplementedError(
                f"weight_quant={weight_quant!r}: none, int4 or int8")
        extras = default_extras(cfg, fused) if extras is None \
            else tuple(extras)
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.zeros(cfg.vocab_size, d, **kw))
        shapes = extra_shapes(cfg)
        for name in extras:
            if name in TOP_EXTRAS:
                setattr(self, name, _extra_param(shapes[name], name, kw))
        prefix = cfg.first_k_dense if cfg.num_experts > 0 else 0
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, weight_quant=weight_quant if l >= prefix
                       else "none", fused=fused and l >= prefix,
                       extras=extras, moe=is_moe_layer(cfg, l),
                       moe_inter=moe_inter, shared_inter=shared_inter,
                       shared_gate=shared_gate, **kw)
            for l in range(cfg.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(d, **kw))
        if cfg.tie_word_embeddings:
            pass                      # the head is embed_tokens
        elif weight_quant != "none":
            self.lm_head = W8Linear.empty(d, cfg.vocab_size, device=device)
        else:
            self.lm_head = nn.Linear(d, cfg.vocab_size, bias=False, **kw)
        if num_labels > 0:
            self.score = nn.Linear(d, num_labels, bias=False, **kw)

    @property
    def dense_layers(self):
        """DeepSeek v1's dense leading layers (the reference's
        `dense_layers`): the first cfg.first_k_dense of `layers`, which
        keep their absolute indexes there."""
        k = self.cfg.first_k_dense if self.cfg.num_experts > 0 else 0
        return self.layers[:k]


# the serving engine's weight layouts, which only serve/engine.py computes
_SERVING_LAYOUTS = (W4Linear, W8Linear, W4FusedMLP)


def _dense(h, proj):
    return proj(h)


def dnorm(cfg: LlamaConfig, x, owner, key: str):
    """The family norm `key` of a layer or the model, with its
    `<key>_bias` where the family has one (ops/norms.py family_norm)."""
    return family_norm(cfg, x, getattr(owner, key),
                       getattr(owner, key + "_bias", None))


def _qknorm(cfg: LlamaConfig, x, w):
    """Per-head q/k norm before rotary: Qwen3's RMSNorm ([hd] weight) or
    Cohere's LayerNorm ([H, hd] per-head weights)."""
    if cfg.norm_type == "cohere":
        return cohere_layer_norm(x, w, cfg.rms_norm_eps)
    return rms_norm(x, w, cfg.rms_norm_eps)


def layer_qkv(cfg: LlamaConfig, lp: LlamaLayer, h, dot=_dense):
    """h [B, T, D] → q [B, T, H, hd], k, v [B, T, Hkv, hd] through the
    per-name or the fused (qkv) projections, with the family's biases,
    clamp and per-head norms; `dot(h, proj)` computes one projection (the
    serving engine passes its W4-aware one)."""
    B, T, _ = h.shape
    H, Hkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    if hasattr(lp, "qkv"):          # fused stream
        fused = dot(h, lp.qkv)
        if getattr(lp, "qkv_bias", None) is not None:
            fused = fused + lp.qkv_bias
        q, k, v = fused.split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
    else:
        q, k, v = dot(h, lp.q), dot(h, lp.k), dot(h, lp.v)
        if getattr(lp, "q_bias", None) is not None:     # Qwen2 family
            q, k, v = q + lp.q_bias, k + lp.k_bias, v + lp.v_bias
    if cfg.clip_qkv:                # OLMo's activation clamp
        c = cfg.clip_qkv
        q, k, v = q.clamp(-c, c), k.clamp(-c, c), v.clamp(-c, c)
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, Hkv, hd)
    v = v.contiguous().reshape(B, T, Hkv, hd)
    if getattr(lp, "q_norm", None) is not None:
        q, k = _qknorm(cfg, q, lp.q_norm), _qknorm(cfg, k, lp.k_norm)
    return q, k, v


def layer_attn_out(cfg: LlamaConfig, lp: LlamaLayer, attn, dot=_dense):
    """The attention output [B, T, H·hd] through o (and its bias), then
    Gemma-2's output norm and MiniCPM's residual scale: the branch that
    joins the residual."""
    return attn_out_tail(cfg, lp, dot(attn, lp.o))


def attn_out_tail(cfg: LlamaConfig, lp: LlamaLayer, out):
    """What follows the o product: its bias, Gemma-2's output norm and
    MiniCPM's residual scale. Under tensor parallelism (serve/tp.py) `out`
    is the sum of the shards' partial products, so the bias adds once."""
    if getattr(lp, "o_bias", None) is not None:
        out = out + lp.o_bias
    if getattr(lp, "post_attn_out_norm", None) is not None:
        out = dnorm(cfg, out, lp, "post_attn_out_norm")
    if cfg.residual_scale is not None:
        out = out * cfg.residual_scale
    return out


def moe_layer_mlp(cfg: LlamaConfig, lp: LlamaLayer, h,
                  grouped: bool = False, shared: bool = True, **kw):
    """A MoE layer's MLP on the normed input h: the routed experts in the
    config's router mode (a "deepseek" router routes as Mixtral's here,
    as in the reference's llama path) through the grouped form (grouped)
    or the dense one, plus (shared) the shared expert where the layer has
    one, in h's dtype. kw: moe_mlp's expert_offset (tensor parallelism)."""
    fn = moe_mlp_grouped if grouped else moe_mlp
    out = fn({"router": lp.moe_router, "gate": lp.moe_gate,
              "up": lp.moe_up, "down": lp.moe_down}, h,
             cfg.num_experts_per_tok,
             router_mode=("softmax_topk"
                          if cfg.moe_router_mode == "softmax_topk"
                          else "mixtral"),
             norm_topk=cfg.moe_norm_topk,
             router_logit_softcap=cfg.moe_router_logit_softcap, **kw)
    if shared and hasattr(lp, "moe_shared_gate"):
        out = out + shared_expert_mlp(lp, h)
    return out


def layer_mlp(cfg: LlamaConfig, lp: LlamaLayer, h, dot=_dense,
              moe_grouped: bool = False):
    """The MLP branch on the normed input h (the reference's `_mlp`
    without the residual): `mlp_product`, then `mlp_tail`."""
    return mlp_tail(cfg, lp, mlp_product(cfg, lp, h, dot, moe_grouped))


def mlp_product(cfg: LlamaConfig, lp: LlamaLayer, h, dot=_dense,
                moe_grouped: bool = False, down_dot=None):
    """The MLP up to its down product: a MoE layer's experts
    (`moe_layer_mlp`, the grouped form with moe_grouped, else the dense
    one); gated (SiLU or GeGLU) per-name, fused (gateup) or a W4FusedMLP,
    or non-gated (up → act → down, the up bias). With a W4FusedMLP, at
    most MAX_TOKENS tokens run as one `fused_mlp_w4` call; more (prefill)
    untile the weights and run gateup and down through `dot`, act(gate)·up
    in h's dtype between them. Under tensor parallelism each shard's is a
    partial sum over its slice of the MLP width, its down product through
    `down_dot` (default `dot`)."""
    ddot = down_dot or dot
    if hasattr(lp, "moe_router"):   # Mixtral / Qwen-MoE / DeepSeek v1
        out = moe_layer_mlp(cfg, lp, h, moe_grouped)
    elif hasattr(lp, "mlp"):        # fused-MLP W4 layout
        lead = h.shape[:-1]
        if math.prod(lead) <= MAX_TOKENS:
            out = fused_mlp_w4(h.reshape(-1, h.shape[-1]), *lp.mlp.tensors())
            out = out.reshape(*lead, -1)
        else:
            gateup, down = lp.mlp.untile()
            gate, up = dot(h, gateup).chunk(2, dim=-1)
            out = ddot(family_act(cfg, gate) * up, down)
    elif hasattr(lp, "gateup"):     # fused stream
        gate, up = dot(h, lp.gateup).chunk(2, dim=-1)
        out = ddot(family_act(cfg, gate) * up, lp.down)
    elif hasattr(lp, "gate"):
        out = ddot(family_act(cfg, dot(h, lp.gate)) * dot(h, lp.up),
                   lp.down)
    else:                           # non-gated: StarCoder2, GPT-BigCode
        up = dot(h, lp.up)
        if getattr(lp, "up_bias", None) is not None:
            up = up + lp.up_bias
        out = ddot(family_act(cfg, up), lp.down)
    return out


def mlp_tail(cfg: LlamaConfig, lp: LlamaLayer, out):
    """What follows the down product: its bias (once, after the shards'
    sum under tensor parallelism), Gemma-2's output norm and MiniCPM's
    residual scale."""
    if getattr(lp, "down_bias", None) is not None:
        out = out + lp.down_bias
    if getattr(lp, "post_ffw_norm", None) is not None:
        out = dnorm(cfg, out, lp, "post_ffw_norm")
    if cfg.residual_scale is not None:
        out = out * cfg.residual_scale
    return out


def scale_embeds(cfg: LlamaConfig, x):
    """Gemma's sqrt(hidden) and MiniCPM's scale_emb, each a scalar
    rounded to x's dtype first (as HF and the reference do)."""
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype,
                             device=x.device)
    if cfg.embed_scale is not None:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype, device=x.device)
    return x


def _tp_mlp(cfg: LlamaConfig, lp: LlamaLayer, h, tp):
    """The MLP branch under tensor parallelism: this rank's slice of the
    MLP width (or its experts, with the routing over all of them), the
    partial products summed over tp before `mlp_tail`; a shared expert
    runs whole on h, outside the sum."""
    hp = tp.enter(h)
    if hasattr(lp, "moe_router"):
        local = lp.moe_gate.weight.shape[0]
        out = tp.reduce(moe_layer_mlp(cfg, lp, hp, shared=False,
                                      expert_offset=tp.axis.index * local))
        if hasattr(lp, "moe_shared_gate"):
            out = out + shared_expert_mlp(lp, h)
    else:
        out = tp.reduce(mlp_product(cfg, lp, hp))
    return mlp_tail(cfg, lp, out)


def _layer(cfg: LlamaConfig, lp: LlamaLayer, *args, **kw):
    """One decoder layer (`_layer_body`). A layer laid out over fsdp
    (parallel/mesh.py `FlatUnit`) gathers its parameters first and drops
    them when it ends, also where a remat recompute stops early inside it:
    the autograd graph (or, under remat, the recompute) holds what the
    backward needs, so one layer's whole parameters are live at a time."""
    unit = getattr(lp, "flat_unit", None)
    if unit is None:
        return _layer_body(cfg, lp, *args, **kw)
    unit.gather()
    try:
        return _layer_body(cfg, lp, *args, **kw)
    finally:
        unit.release()


def _layer_body(cfg: LlamaConfig, lp: LlamaLayer, x, cos, sin, mask,
                segment_ids, use_flash, kv=None, cache_len: int = 0,
                sp_attn=None, tp=None):
    """kv: this layer's (k, v) cache [B, S, Hkv, hd], written in place at
    [cache_len, cache_len + T) and attended whole. sp_attn(q, k, v,
    segment_ids, scale): sequence-parallel attention over this rank's
    block (training, no cache; the mask is not needed: right padding sits
    after every valid query). tp: the tensor-parallel hooks
    (parallel/collectives.py `TensorParallel`) of a layer whose branches
    `tp.cut` names are cut over tp (cfg its local view); the others run
    whole on every tp rank."""
    tpa = tp if tp is not None and "attn" in tp.cut else None
    B, T, _ = x.shape
    h = dnorm(cfg, x, lp, "input_norm")
    q, k, v = layer_qkv(cfg, lp, h if tpa is None else tpa.enter(h))
    if not cfg.learned_pos:
        q, k = apply_rope(q, k, cos, sin, interleaved=cfg.rope_interleaved)
    if kv is not None:
        ck, cv = kv
        ck[:, cache_len:cache_len + T] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + T] = v.to(cv.dtype)
        k, v = ck.to(k.dtype), cv.to(v.dtype)
    if sp_attn is not None and kv is None:
        attn = sp_attn(q, k, v, segment_ids, scale=cfg.attn_scale)
    else:
        attn = mha(q, k, v, causal=True, mask=mask,
                   q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
                   q_offset=cache_len, scale=cfg.attn_scale,
                   logit_cap=cfg.attn_logit_softcap, use_flash=use_flash)
    if tpa is None:
        attn = layer_attn_out(cfg, lp, attn.reshape(B, T, -1))
    else:
        attn = attn_out_tail(cfg, lp, tpa.reduce(_dense(
            attn.reshape(B, T, -1), lp.o)))
    mlp = layer_mlp
    if tp is not None and ("experts" if hasattr(lp, "moe_router")
                           else "mlp") in tp.cut:
        mlp = functools.partial(_tp_mlp, tp=tp)
    if cfg.parallel_block:          # Cohere: the MLP reads the same h
        return x + attn + mlp(cfg, lp, h)
    x = x + attn
    return x + mlp(cfg, lp, dnorm(cfg, x, lp, "post_attn_norm"))


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


_SP_WINDOW_CAP = (
    "sequence-parallel attention (sp_attn: ring, Ulysses, hybrid) takes "
    "neither a sliding window nor an attention logit softcap, and a model "
    "with either would train on other attention than its own; the "
    "reference's step drops both silently (ROADMAP queue 3). Train such a "
    "model without sp_mode")


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
                return_hidden: bool = False,
                sp_attn=None, tp=None):
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
    layer. use_flash: None lets `mha` decide. A sliding window (a key
    mask on (query - key) slot, in every layer, as in the reference's
    llama_apply) or a logit softcap keeps attention off the flash kernels,
    which take neither. The family knobs act as in the reference's
    `_layer` and `llama_apply`; like it, this applies no final logit
    softcap (Gemma-2's offline forward is models/gemma2.py).

    Training on a mesh (parallel/mesh.py): sp_attn(q, k, v, segment_ids,
    scale) replaces `mha` without a KV cache, as in the reference (x is
    then this rank's block of the sequence and position_ids its global
    positions), and raises NotImplementedError for a sliding window or an
    attention softcap, which it does not apply (the reference drops them);
    tp (`TensorParallel`) runs the decoder layers cut over tp, cfg their
    local view.
    """
    if kv_cache is not None and segment_ids is not None:
        raise ValueError("packed segments over a KV cache are unsupported: "
                         "the cache tracks no segment ids")
    head = (model.embed_tokens if cfg.tie_word_embeddings
            else getattr(model.lm_head, "weight", None))
    if any(isinstance(m, _SERVING_LAYOUTS) for lp in model.layers
           for m in lp.children()) or not (
               cfg.tie_word_embeddings
               or isinstance(model.lm_head, nn.Linear)):
        raise NotImplementedError(
            "llama_apply runs dense, (Q)LoRA or quantized-base layers "
            "(train/lora.py, train/quant.py) under a float LM head; the "
            "serving engine's W4/W8 layouts run in serve/engine.py")
    x = model.embed_tokens[input_ids] if inputs_embeds is None \
        else inputs_embeds
    x = scale_embeds(cfg, x)
    B, T, _ = x.shape
    if position_ids is None:
        position_ids = (torch.arange(T, device=x.device)[None]
                        + cache_len).expand(B, T)
    cos = sin = None
    if cfg.learned_pos:             # GPT-BigCode: wpe, no rotary
        x = x + model.wpe[position_ids]
    else:
        cos, sin = rope_cos_sin(position_ids, cfg.rotary_dim,
                                cfg.rope_theta, cfg.rope_linear_scaling)
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
        if sp_attn is not None and kv_cache is None:
            raise NotImplementedError(_SP_WINDOW_CAP)
        use_flash = False
    if kv_cache is None:
        layer = (_layer if sp_attn is None and tp is None else
                 functools.partial(_layer, sp_attn=sp_attn, tp=tp))
        for lp in model.layers:
            x = remat_call(layer, remat, cfg, lp, x, cos, sin, mask,
                           segment_ids, use_flash)
    else:
        with sdpa_kernel(REPEATABLE_SDPA):
            for i, lp in enumerate(model.layers):
                x = _layer(cfg, lp, x, cos, sin, mask, None, use_flash,
                           (kv_cache["k"][i], kv_cache["v"][i]), cache_len)
    x = dnorm(cfg, x, model, "final_norm")
    if return_hidden:
        out = x
    else:
        out = _head_logits(x, head)
        if cfg.logit_scale is not None:   # Cohere / MiniCPM
            out = out * cfg.logit_scale
    return out if kv_cache is None else (out, kv_cache)


def token_losses(logits: torch.Tensor, targets: torch.Tensor):
    """Cross-entropy of each position's logits [B, T, V] against its
    target [B, T] (no shift), 0 where the target is IGNORE_INDEX → (the
    per-token losses [B, T] fp32, the count of valid targets)."""
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_ll = logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, -token_ll, 0.0), valid.sum()


def llama_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                  reduce: bool = True):
    """Shifted next-token cross-entropy with IGNORE_INDEX (-100) masking →
    (mean loss over the valid tokens, their count); reduce=False gives the
    per-token losses [B, T-1] instead of the mean."""
    token_loss, n = token_losses(logits[:, :-1], labels[:, 1:])
    if reduce:
        return token_loss.sum() / n.clamp_min(1), n
    return token_loss, n
