"""DeepSeek-V2 decoder family (aurora_tpu/models/deepseek_v2.py):
multi-head latent attention (MLA) and the shared-expert MoE.

* MLA: queries direct (V2-Lite) or low-rank (q_a → RMSNorm → q_b); keys
  and values decompress from a kv_lora_rank latent (kv_a → RMSNorm →
  kv_b); one shared rope sub-head a token, broadcast over the heads;
  attention over qk_nope + qk_rope features, values of v_head_dim;
* DeepSeek's complex-pair rotary on the rope sub-heads (ops/rope.py
  `rope_pairs`), YaRN's explicit frequencies and cos/sin scaling from
  the config (`rope_inv_freq`, `rope_attention_scaling`);
* the MoE: an fp32 softmax gate over every expert, greedy or
  group-limited greedy top-k, optional renormalization, the routed
  scaling factor, every expert weighted into an fp32 sum (this offline
  model's dense form, as in the reference), plus the always-on shared
  experts; the first `first_k_dense_replace` layers are dense.

Layers are heterogeneous, so the model is a list of `DeepseekV2Layer`s
(linear weights in the nn.Linear [out, in] layout, expert stacks in
ops/moe.py's [E, in, out] `ExpertStack`), and `deepseek_v2_apply` a
Python loop with fp32 attention, as the reference's. The serving engine
runs the same modules through serve/mla.py (latent rows, absorbed
attention, the grouped-expert kernel on the card). Built on the card
unless the caller passes a device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from aurora_tpu_torch.ops.moe import ExpertStack, top_k
from aurora_tpu_torch.ops.norms import rms_norm
from aurora_tpu_torch.ops.rope import rope_pairs, yarn_inv_freq


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None      # None: V2-Lite's direct q
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    max_position_embeddings: int = 163840
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # YaRN (ops/rope.py yarn_inv_freq): per-pair inverse frequencies and
    # the cos/sin scale, from the checkpoint's rope_scaling
    rope_inv_freq: Optional[tuple] = None
    rope_attention_scaling: float = 1.0
    topk_method: str = "greedy"            # or "group_limited_greedy"
    n_group: int = 1
    topk_group: int = 1

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe_layer(self, idx: int) -> bool:
        return (self.n_routed_experts > 0
                and idx >= self.first_k_dense_replace
                and idx % self.moe_layer_freq == 0)

    @classmethod
    def v2_lite(cls) -> "DeepseekV2Config":
        """deepseek-ai/DeepSeek-V2-Lite's widths (27 layers, the first
        dense; 64 routed experts top-6 and 2 shared; rank 512, rope 64);
        its checkpoint's YaRN comes with `deepseek_v2_config_from_hf`."""
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "DeepseekV2Config":
        return cls(vocab_size=vocab_size, hidden_size=64,
                   intermediate_size=128, moe_intermediate_size=32,
                   num_hidden_layers=3, num_attention_heads=4,
                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                   v_head_dim=16, kv_lora_rank=32, q_lora_rank=None,
                   n_routed_experts=4, n_shared_experts=1,
                   num_experts_per_tok=2, first_k_dense_replace=1,
                   max_position_embeddings=256)


def _linear(n_in, n_out, kw):
    return nn.Linear(n_in, n_out, bias=False, **kw)


class DeepseekV2Layer(nn.Module):
    """One layer: norms, the MLA projections (q or q_a/q_a_norm/q_b,
    kv_a, kv_a_norm, kv_b, o) and either the dense MLP (gate, up, down) or
    the MoE: the gate `moe_gate_w` [E, D] (HF's mlp.gate.weight), expert
    stacks moe_gate / moe_up [E, D, F] and moe_down [E, F, D], and the
    shared experts shared_gate / shared_up / shared_down."""

    def __init__(self, cfg: DeepseekV2Config, moe: bool, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        D, H = cfg.hidden_size, cfg.num_attention_heads
        r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        self.input_norm = nn.Parameter(torch.ones(D, **kw))
        self.post_attn_norm = nn.Parameter(torch.ones(D, **kw))
        if cfg.q_lora_rank:
            self.q_a = _linear(D, cfg.q_lora_rank, kw)
            self.q_a_norm = nn.Parameter(torch.ones(cfg.q_lora_rank, **kw))
            self.q_b = _linear(cfg.q_lora_rank, H * cfg.qk_head_dim, kw)
        else:
            self.q = _linear(D, H * cfg.qk_head_dim, kw)
        self.kv_a = _linear(D, r + dr, kw)
        self.kv_a_norm = nn.Parameter(torch.ones(r, **kw))
        self.kv_b = _linear(r, H * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                            kw)
        self.o = _linear(H * cfg.v_head_dim, D, kw)
        if moe:
            E, Fm = cfg.n_routed_experts, cfg.moe_intermediate_size
            Fs = Fm * cfg.n_shared_experts
            self.moe_gate_w = nn.Parameter(torch.zeros(E, D, **kw))
            self.moe_gate = ExpertStack.empty(E, D, Fm, **kw)
            self.moe_up = ExpertStack.empty(E, D, Fm, **kw)
            self.moe_down = ExpertStack.empty(E, Fm, D, **kw)
            self.shared_gate = _linear(D, Fs, kw)
            self.shared_up = _linear(D, Fs, kw)
            self.shared_down = _linear(Fs, D, kw)
        else:
            self.gate = _linear(D, cfg.intermediate_size, kw)
            self.up = _linear(D, cfg.intermediate_size, kw)
            self.down = _linear(cfg.intermediate_size, D, kw)


class DeepseekV2Model(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                     cfg.hidden_size, **kw))
        self.layers = nn.ModuleList(
            DeepseekV2Layer(cfg, cfg.is_moe_layer(i), **kw)
            for i in range(cfg.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.hidden_size, **kw))
        self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, kw)


def init_deepseek_v2(cfg: DeepseekV2Config, generator: torch.Generator,
                     device=None, dtype=torch.float32) -> DeepseekV2Model:
    """Random weights with the reference's scheme (models/init.py: every
    matrix and the expert stacks ~ N(0, 0.02²), norms one), from
    `generator` on `device`."""
    from aurora_tpu_torch.models.init import build
    return build(DeepseekV2Model, cfg, device=device, dtype=dtype,
                 generator=generator)


def _mlp(x, gate, up, down):
    """SiLU MLP in x's dtype, each product summed in fp32."""
    g = (x.float() @ gate.float()).to(x.dtype)
    u = (x.float() @ up.float()).to(x.dtype)
    return ((F.silu(g) * u).float() @ down.float()).to(x.dtype)


def route(scores: torch.Tensor, k: int, topk_method: str, n_group: int,
          topk_group: int, norm_topk: bool, scaling: float):
    """DeepSeek's routing of fp32 softmax scores [N, E] → (weights [N, k],
    experts [N, k]): greedy top-k, or group-limited greedy (only the
    topk_group groups of the highest max score compete); renormalized
    with norm_topk (sum floored at 1e-20), then times the routed scaling
    factor."""
    if topk_method == "group_limited_greedy" and n_group > 1:
        N, E = scores.shape
        g = scores.reshape(N, n_group, E // n_group)
        _, gidx = top_k(g.amax(dim=-1), topk_group)
        gmask = torch.zeros((N, n_group), dtype=scores.dtype,
                            device=scores.device).scatter(1, gidx, 1.0)
        scores = (g * gmask[..., None]).reshape(N, E)
    w, idx = top_k(scores, k)
    if norm_topk:
        w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return w * scaling, idx


def _moe(cfg: DeepseekV2Config, lp: DeepseekV2Layer, x):
    """The reference's offline `_moe`: every expert's MLP (in x's dtype)
    weighted into an fp32 sum by the routing weights (0 where not
    picked), plus the shared experts' MLP."""
    B, T, D = x.shape
    flat = x.reshape(-1, D)
    scores = torch.softmax(flat.float() @ lp.moe_gate_w.float().t(), dim=-1)
    w, idx = route(scores, cfg.num_experts_per_tok, cfg.topk_method,
                   cfg.n_group, cfg.topk_group, cfg.norm_topk_prob,
                   cfg.routed_scaling_factor)
    combine = torch.zeros_like(scores).scatter(1, idx, w)
    out = torch.zeros(flat.shape, dtype=torch.float32, device=x.device)
    wg, wu, wd = (s.dequantized(x.dtype) for s in (lp.moe_gate, lp.moe_up,
                                                   lp.moe_down))
    for e in range(wg.shape[0]):
        out = out + combine[:, e:e + 1] * _mlp(flat, wg[e], wu[e],
                                               wd[e]).float()
    out = out.to(x.dtype).reshape(B, T, D)
    return out + _mlp(x, lp.shared_gate.weight.t(), lp.shared_up.weight.t(),
                      lp.shared_down.weight.t())


def _mla(cfg: DeepseekV2Config, lp: DeepseekV2Layer, h, positions):
    """h [B, T, D] → (q [B, T, H, qk], k [B, T, H, qk], v [B, T, H, dv])
    with the rope sub-heads rotated and k's shared one broadcast."""
    B, T, _ = h.shape
    H, dn, dr = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                 cfg.qk_rope_head_dim)
    if hasattr(lp, "q_a"):
        q = lp.q_b(rms_norm(lp.q_a(h), lp.q_a_norm, cfg.rms_norm_eps))
    else:
        q = lp.q(h)
    q = q.reshape(B, T, H, cfg.qk_head_dim)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = lp.kv_a(h)
    latent = ckv[..., :cfg.kv_lora_rank]
    k_pe = ckv[..., cfg.kv_lora_rank:][:, :, None, :]
    kv = lp.kv_b(rms_norm(latent, lp.kv_a_norm, cfg.rms_norm_eps))
    kv = kv.reshape(B, T, H, dn + cfg.v_head_dim)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    rot = dict(theta=cfg.rope_theta, inv_freq=cfg.rope_inv_freq,
               attention_scaling=cfg.rope_attention_scaling)
    q_pe = rope_pairs(q_pe, positions, **rot)
    k_pe = rope_pairs(k_pe, positions, **rot).expand(B, T, H, dr)
    return (torch.cat([q_nope, q_pe], dim=-1),
            torch.cat([k_nope, k_pe], dim=-1), v)


def _attend(cfg: DeepseekV2Config, q, k, v, mask):
    """fp32 softmax attention, masked positions at -2.38e38."""
    scale = cfg.qk_head_dim ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, k.float())
    logits = torch.where(mask, logits, torch.tensor(-2.38e38,
                                                    device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(v.dtype)


def init_deepseek_v2_kv_cache(cfg: DeepseekV2Config, batch: int,
                              max_len: int, dtype=torch.bfloat16,
                              device=None) -> Dict[str, torch.Tensor]:
    """The per-head cache of the offline forward: k [L, B, S, H, qk], v
    [L, B, S, H, dv] zeros (the latent cache is the serving engine's)."""
    L, H = cfg.num_hidden_layers, cfg.num_attention_heads
    return {"k": torch.zeros((L, batch, max_len, H, cfg.qk_head_dim),
                             dtype=dtype, device=device),
            "v": torch.zeros((L, batch, max_len, H, cfg.v_head_dim),
                             dtype=dtype, device=device)}


@torch.no_grad()
def deepseek_v2_apply(model: DeepseekV2Model, cfg: DeepseekV2Config, *,
                      input_ids: Optional[torch.Tensor] = None,
                      inputs_embeds: Optional[torch.Tensor] = None,
                      attention_mask: Optional[torch.Tensor] = None,
                      position_ids: Optional[torch.Tensor] = None,
                      kv_cache: Optional[Dict[str, torch.Tensor]] = None,
                      cache_len: int = 0):
    """Forward → (logits [B, T, V] fp32, kv_cache or None), the
    reference's contract (models/llama.py llama_apply's): with kv_cache the
    step's K/V are written in place at [cache_len, cache_len + T) and the
    queries attend over the cache's valid slots."""
    x = model.embed_tokens[input_ids] if inputs_embeds is None \
        else inputs_embeds
    B, T, _ = x.shape
    if position_ids is None:
        position_ids = (torch.arange(T, device=x.device)[None]
                        + cache_len).expand(B, T)
    eps = cfg.rms_norm_eps
    for i, lp in enumerate(model.layers):
        h = rms_norm(x, lp.input_norm, eps)
        q, k, v = _mla(cfg, lp, h, position_ids)
        if kv_cache is not None:
            ck, cv = kv_cache["k"][i], kv_cache["v"][i]
            ck[:, cache_len:cache_len + T] = k.to(ck.dtype)
            cv[:, cache_len:cache_len + T] = v.to(cv.dtype)
            k, v = ck.to(q.dtype), cv.to(q.dtype)
            S, kv_len = k.shape[1], cache_len + T
        else:
            S, kv_len = T, T
        qpos = position_ids[:, None, :, None]
        kpos = torch.arange(S, device=x.device)[None, None, None, :]
        mask = (kpos <= qpos) & (kpos < kv_len)
        if attention_mask is not None:
            mask = mask & attention_mask.to(torch.bool)[:, None, None, :]
        attn = _attend(cfg, q, k, v, mask)
        attn = (attn.reshape(B, T, -1).float()
                @ lp.o.weight.float().t()).to(x.dtype)
        x = x + attn
        h = rms_norm(x, lp.post_attn_norm, eps)
        x = x + (_moe(cfg, lp, h) if cfg.is_moe_layer(i)
                 else _mlp(h, lp.gate.weight.t(), lp.up.weight.t(),
                           lp.down.weight.t()))
    x = rms_norm(x, model.final_norm, eps)
    logits = x.float() @ model.lm_head.weight.float().t()
    return logits, kv_cache


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------

def _yarn_from_hf(cfg: Dict[str, Any]):
    """(inv_freq, attention_scaling) of a HF DeepSeek-V2 config: YaRN's
    from its rope_scaling (the rope dims, rope_theta and the context of
    transformers' DeepseekV2Config defaults), or (None, 1.0) without
    one; other rope types raise NotImplementedError."""
    rs = cfg.get("rope_scaling")
    if not rs:
        return None, 1.0
    kind = rs.get("rope_type", rs.get("type", "yarn"))
    if kind != "yarn":
        raise NotImplementedError(f"DeepSeek-V2 rope_scaling {kind!r}: "
                                  "only yarn is ported")
    return yarn_inv_freq(rs, cfg.get("qk_rope_head_dim", 64),
                         cfg.get("rope_theta", 10000.0),
                         cfg.get("max_position_embeddings", 2048))


def deepseek_v2_config_from_hf(cfg: Dict[str, Any]) -> DeepseekV2Config:
    """A HF DeepseekV2 config dict → DeepseekV2Config, with the
    reference's defaults for absent fields."""
    inv_freq, scaling = _yarn_from_hf(cfg)
    return DeepseekV2Config(
        rope_inv_freq=inv_freq,
        rope_attention_scaling=scaling,
        topk_method=cfg.get("topk_method", "greedy"),
        n_group=cfg.get("n_group", 1) or 1,
        topk_group=cfg.get("topk_group", 1) or 1,
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg.get("moe_intermediate_size", 1408),
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        qk_nope_head_dim=cfg.get("qk_nope_head_dim", 128),
        qk_rope_head_dim=cfg.get("qk_rope_head_dim", 64),
        v_head_dim=cfg.get("v_head_dim", 128),
        kv_lora_rank=cfg.get("kv_lora_rank", 512),
        q_lora_rank=cfg.get("q_lora_rank"),
        n_routed_experts=cfg.get("n_routed_experts", 0) or 0,
        n_shared_experts=cfg.get("n_shared_experts", 0) or 0,
        num_experts_per_tok=cfg.get("num_experts_per_tok", 6) or 6,
        routed_scaling_factor=cfg.get("routed_scaling_factor", 1.0),
        norm_topk_prob=cfg.get("norm_topk_prob", False),
        first_k_dense_replace=cfg.get("first_k_dense_replace", 1),
        moe_layer_freq=cfg.get("moe_layer_freq", 1),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 10000.0))


def deepseek_v2_state_dict(sd: Dict[str, torch.Tensor],
                           cfg: DeepseekV2Config) -> Dict[str, torch.Tensor]:
    """HF DeepseekV2ForCausalLM names → DeepseekV2Model's (the routed
    experts' [out, in] weights stacked as [E, in, out])."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}
    out = {"embed_tokens": sd["embed_tokens.weight"],
           "final_norm": sd["norm.weight"],
           "lm_head.weight": sd["lm_head.weight"]}
    names = (("input_norm", "input_layernorm.weight"),
             ("post_attn_norm", "post_attention_layernorm.weight"),
             ("kv_a.weight", "self_attn.kv_a_proj_with_mqa.weight"),
             ("kv_a_norm", "self_attn.kv_a_layernorm.weight"),
             ("kv_b.weight", "self_attn.kv_b_proj.weight"),
             ("o.weight", "self_attn.o_proj.weight"))
    for i in range(cfg.num_hidden_layers):
        p, q = f"layers.{i}.", f"layers.{i}."
        for ours, theirs in names:
            out[p + ours] = sd[q + theirs]
        if cfg.q_lora_rank:
            out[p + "q_a.weight"] = sd[q + "self_attn.q_a_proj.weight"]
            out[p + "q_a_norm"] = sd[q + "self_attn.q_a_layernorm.weight"]
            out[p + "q_b.weight"] = sd[q + "self_attn.q_b_proj.weight"]
        else:
            out[p + "q.weight"] = sd[q + "self_attn.q_proj.weight"]
        if cfg.is_moe_layer(i):
            out[p + "moe_gate_w"] = sd[q + "mlp.gate.weight"]
            for ours, theirs in (("moe_gate", "gate_proj"),
                                 ("moe_up", "up_proj"),
                                 ("moe_down", "down_proj")):
                out[p + ours + ".weight"] = torch.stack(
                    [sd[f"{q}mlp.experts.{e}.{theirs}.weight"].t()
                     for e in range(cfg.n_routed_experts)])
            for ours, theirs in (("shared_gate", "gate_proj"),
                                 ("shared_up", "up_proj"),
                                 ("shared_down", "down_proj")):
                out[p + ours + ".weight"] = \
                    sd[f"{q}mlp.shared_experts.{theirs}.weight"]
        else:
            for ours, theirs in (("gate", "gate_proj"), ("up", "up_proj"),
                                 ("down", "down_proj")):
                out[p + ours + ".weight"] = sd[f"{q}mlp.{theirs}.weight"]
    return out


def deepseek_v2_params_from_hf(sd: Dict[str, torch.Tensor],
                               cfg: DeepseekV2Config, dtype=torch.bfloat16,
                               device=None) -> DeepseekV2Model:
    """A HF DeepseekV2ForCausalLM state dict → DeepseekV2Model in dtype
    (the one cast, in load_state_dict), on the card unless `device`."""
    from aurora_tpu_torch.bridge import _load
    return _load(DeepseekV2Model(cfg, device="meta", dtype=dtype),
                 deepseek_v2_state_dict(sd, cfg), device)
