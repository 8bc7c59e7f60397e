"""Multi-head latent attention serving: the DeepSeek-V2 engine path
(aurora_tpu/serve/mla.py).

* The rows and the prefix pool hold one latent vector a token: rows
  {"k": [L, B, 1, S, rank + rope]} (num_key_value_heads 1 and head_dim
  rank + rope in the serving config), so the radix cache, `_load_prefix`
  / `_store_prompt` and the memory sizing of serve/engine.py work on
  them unchanged;
* attention is absorbed into the latent space: q_lat = q_nope · W_uk,
  scores = q_lat · latent + q_pe · k_pe, out = (p · latent) · W_uv; the
  per-head keys and values are never built. These are fp32 einsums in
  plain torch (TF32 off, PyTorch's default for matmuls), as the
  reference's are XLA einsums with no kernel of their own;
* the layers keep their absolute index into the rows; the dense prefix
  runs the dense MLP, the MoE tail `_ds_moe`: models/deepseek_v2.py's
  routing (fp32 softmax, greedy or group-limited top-k, renormalization,
  routed scaling) and shared experts, all in fp32 as the reference
  computes it. On the card the routed experts run the grouped-expert
  kernel (ops/moe.py): gate and up take the bf16 rows and return fp32,
  and the fp32 silu(gate)·up, which the reference never rounds to bf16,
  goes into the down product as a bf16 high part plus a bf16 low part
  (two kernel passes summed in fp32), which keeps about 16 of its 24
  mantissa bits; on the CPU the reference's all-expert fp32 form runs.

The serving model is the offline DeepseekV2Model's layers and weights
(`deepseek_serving_params` shares them, nothing is copied) under the
engine-facing LlamaConfig of `deepseek_serving_config`. MLA serving
takes bf16 latents and weights on one device (serve/engine.py refuses
kv_quant and weight_quant for it), as the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aurora_tpu_torch.models.deepseek_v2 import (DeepseekV2Config,
                                                 DeepseekV2Model, route)
from aurora_tpu_torch.models.llama import LlamaConfig
from aurora_tpu_torch.ops import moe as moe_ops
from aurora_tpu_torch.ops.moe import combine_sorted, sort_by_expert
from aurora_tpu_torch.ops.norms import rms_norm
from aurora_tpu_torch.ops.rope import rope_pairs


def deepseek_serving_config(d: DeepseekV2Config) -> LlamaConfig:
    """DeepseekV2Config → the engine-facing universal LlamaConfig: one
    latent "head" of rank + rope, the attention scale of qk_head_dim, the
    MLA and DeepSeek routing knobs."""
    return LlamaConfig(
        vocab_size=d.vocab_size,
        hidden_size=d.hidden_size,
        intermediate_size=d.intermediate_size,
        num_hidden_layers=d.num_hidden_layers,
        num_attention_heads=d.num_attention_heads,
        num_key_value_heads=1,
        head_dim_override=d.kv_lora_rank + d.qk_rope_head_dim,
        max_position_embeddings=d.max_position_embeddings,
        rms_norm_eps=d.rms_norm_eps,
        rope_theta=d.rope_theta,
        rope_inv_freq=d.rope_inv_freq,
        rope_attention_scaling=d.rope_attention_scaling,
        query_pre_attn_scalar=float(d.qk_head_dim),
        mla_kv_lora_rank=d.kv_lora_rank,
        mla_q_lora_rank=d.q_lora_rank,
        mla_qk_nope_head_dim=d.qk_nope_head_dim,
        mla_qk_rope_head_dim=d.qk_rope_head_dim,
        mla_v_head_dim=d.v_head_dim,
        mla_first_k_dense=(d.first_k_dense_replace if d.n_routed_experts > 0
                           else d.num_hidden_layers),
        num_experts=d.n_routed_experts,
        num_experts_per_tok=d.num_experts_per_tok,
        moe_router_mode="deepseek",
        moe_routed_scaling=d.routed_scaling_factor,
        moe_norm_topk=d.norm_topk_prob,
        moe_topk_method=d.topk_method,
        moe_n_group=d.n_group,
        moe_topk_group=d.topk_group)


class MLAServingModel(nn.Module):
    """A DeepseekV2Model's embeddings, layers, final norm and head under
    the serving config `cfg` (what ServeEngine reads: embed_tokens,
    layers, lm_head, cfg)."""

    def __init__(self, model: DeepseekV2Model, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = model.embed_tokens
        self.layers = model.layers
        self.final_norm = model.final_norm
        self.lm_head = model.lm_head


def deepseek_serving_params(model: DeepseekV2Model,
                            d: DeepseekV2Config) -> MLAServingModel:
    """The serving model over `model`'s own tensors. As the reference, a
    MoE tail must be uniform (every layer past the dense prefix routed)."""
    first_k = (d.first_k_dense_replace if d.n_routed_experts > 0
               else d.num_hidden_layers)
    if not all(d.is_moe_layer(i)
               for i in range(first_k, d.num_hidden_layers)):
        raise NotImplementedError("a non-uniform MoE tail (moe_layer_freq "
                                  "!= 1) is not served, as in the "
                                  "reference")
    return MLAServingModel(model, deepseek_serving_config(d))


def _routing(cfg: LlamaConfig, lp, flat):
    """fp32 softmax scores of flat [N, D] over the experts → (weights
    [N, k] fp32, experts [N, k])."""
    scores = torch.softmax(flat.float() @ lp.moe_gate_w.float().t(), dim=-1)
    return route(scores, cfg.num_experts_per_tok, cfg.moe_topk_method,
                 cfg.moe_n_group, cfg.moe_topk_group, cfg.moe_norm_topk,
                 cfg.moe_routed_scaling)


def _shared_fp32(lp, xf):
    """The shared experts' MLP on fp32 rows, all in fp32."""
    g = xf @ lp.shared_gate.weight.float().t()
    u = xf @ lp.shared_up.weight.float().t()
    return (F.silu(g) * u) @ lp.shared_down.weight.float().t()


def ds_moe_dense(cfg: LlamaConfig, lp, x):
    """The reference's `_ds_moe`: every expert in fp32 on every token
    (weights and rows upcast), weighted by the routing weights (0 where
    not picked), plus the shared experts, cast to x's dtype."""
    B, T, D = x.shape
    xf = x.reshape(-1, D).float()
    w, idx = _routing(cfg, lp, xf)
    combine = torch.zeros((xf.shape[0], cfg.num_experts),
                          device=x.device).scatter(1, idx, w)
    gate = torch.einsum("nd,edi->eni", xf, lp.moe_gate.weight.float())
    up = torch.einsum("nd,edi->eni", xf, lp.moe_up.weight.float())
    down = torch.einsum("eni,eid->end", F.silu(gate) * up,
                        lp.moe_down.weight.float())
    routed = torch.einsum("end,ne->nd", down, combine)
    return (routed + _shared_fp32(lp, xf)).to(x.dtype).reshape(B, T, D)


def _split_bf16(x: torch.Tensor):
    """fp32 x → (hi, lo) bf16 with hi + lo ≈ x to about 16 mantissa bits:
    hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def ds_moe_grouped(cfg: LlamaConfig, lp, x):
    """`ds_moe_dense`'s function through the grouped products: each
    token's k copies sorted by expert, gate and up from x's rows with fp32
    outputs, silu(gate)·up in fp32, down in fp32 (on the card over the
    bf16 high and low parts of that product, two kernel passes; on the CPU
    over the fp32 product itself), weighted and summed per token in
    expert order, plus the shared experts in fp32."""
    B, T, D = x.shape
    flat = x.reshape(-1, D)
    w, idx = _routing(cfg, lp, flat)
    k = idx.shape[1]
    order, offsets = sort_by_expert(idx, cfg.num_experts)
    xs = flat.index_select(0, order // k)

    def gmm(rows, stack):
        return moe_ops.moe_grouped_mm(rows, stack.weight, offsets,
                                      stack.scale, out_dtype=torch.float32)

    act = F.silu(gmm(xs, lp.moe_gate)) * gmm(xs, lp.moe_up)
    if act.is_cuda:
        hi, lo = _split_bf16(act)
        down = gmm(hi, lp.moe_down) + gmm(lo, lp.moe_down)
    else:
        down = gmm(act, lp.moe_down)
    routed = combine_sorted(down * w.reshape(-1)[order][:, None], order, k)
    out = routed + _shared_fp32(lp, flat.float())
    return out.to(x.dtype).reshape(B, T, D)


def _dense_mlp(lp, x):
    """The dense prefix's SiLU MLP in x's dtype (fp32 sums)."""
    g = (x.float() @ lp.gate.weight.float().t()).to(x.dtype)
    u = (x.float() @ lp.up.weight.float().t()).to(x.dtype)
    return ((F.silu(g) * u).float()
            @ lp.down.weight.float().t()).to(x.dtype)


def _write_latent(rows, l: int, new, row_ids, q_offsets, kv_lens,
                  kv_write):
    """Write the step's latent vectors new [Bk, T, rank + rope] into layer
    l's rows: an extend through its host-built write plan (the positions
    in [q_offset, kv_len) of each lane); a decode (T == 1) on the device,
    each lane's one position where it is below kv_len (a lane of kv_len 0
    writes nothing)."""
    buf = rows["k"][l]                                  # [B, 1, S, r+dr]
    if kv_write is not None:
        buf[kv_write.row_idx, 0, kv_write.pos_idx] = \
            new[kv_write.lane_idx, kv_write.t_idx].to(buf.dtype)
        return
    r = row_ids.long()
    pos = q_offsets.long().clamp(0, buf.shape[2] - 1)
    keep = buf[r, 0, pos]
    valid = (q_offsets < kv_lens)[:, None]
    buf[r, 0, pos] = torch.where(valid, new[:, 0].to(buf.dtype), keep)


def _mla_layer(cfg: LlamaConfig, lp, l: int, x, rows, row_ids, positions,
               q_offsets, kv_lens, kv_write, moe: bool):
    """One MLA decoder layer over the latent rows (layer index l)."""
    Bk, T, D = x.shape
    S = rows["k"].shape[3]
    r = cfg.mla_kv_lora_rank
    dn, dv = cfg.mla_qk_nope_head_dim, cfg.mla_v_head_dim
    H, eps = cfg.num_attention_heads, cfg.rms_norm_eps
    rot = dict(theta=cfg.rope_theta, inv_freq=cfg.rope_inv_freq,
               attention_scaling=cfg.rope_attention_scaling)

    h = rms_norm(x, lp.input_norm, eps)
    if hasattr(lp, "q_a"):
        q = lp.q_b(rms_norm(lp.q_a(h), lp.q_a_norm, eps))
    else:
        q = lp.q(h)
    q = q.reshape(Bk, T, H, -1)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = lp.kv_a(h)
    lat = rms_norm(ckv[..., :r], lp.kv_a_norm, eps)
    k_pe = rope_pairs(ckv[..., r:][:, :, None, :], positions, **rot)[:, :, 0]
    q_pe = rope_pairs(q_pe, positions, **rot)
    _write_latent(rows, l, torch.cat([lat, k_pe], dim=-1), row_ids,
                  q_offsets, kv_lens, kv_write)

    # absorbed attention over the latent rows, in fp32
    W = lp.kv_b.weight.float().t().reshape(r, H, dn + dv)
    W_uk, W_uv = W[..., :dn], W[..., dn:]
    cache = rows["k"][l][row_ids.long(), 0]            # [Bk, S, r+dr]
    lat_c, pe_c = cache[..., :r].float(), cache[..., r:].float()
    q_lat = torch.einsum("bthd,rhd->bthr", q_nope.float(), W_uk)
    logits = (torch.einsum("bthr,bsr->bhts", q_lat, lat_c)
              + torch.einsum("bthd,bsd->bhts", q_pe.float(), pe_c))
    logits = logits * cfg.attn_scale
    qpos = positions[:, None, :, None]
    kpos = torch.arange(S, device=x.device)[None, None, None, :]
    mask = (kpos <= qpos) & (kpos < kv_lens.long()[:, None, None, None])
    logits = torch.where(mask, logits,
                         torch.tensor(-2.38e38, device=x.device))
    p = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bhts,bsr->bthr", p, lat_c)
    attn = torch.einsum("bthr,rhd->bthd", o_lat, W_uv)
    attn = (attn.reshape(Bk, T, H * dv).to(x.dtype).float()
            @ lp.o.weight.float().t()).to(x.dtype)
    x = x + attn
    h2 = rms_norm(x, lp.post_attn_norm, eps)
    if moe:
        out = ds_moe_grouped(cfg, lp, h2) if x.is_cuda \
            else ds_moe_dense(cfg, lp, h2)
    else:
        out = _dense_mlp(lp, h2)
    return x + out


def forward_rows_mla(model, cfg: LlamaConfig, embeds, rows, row_ids,
                     q_offsets, kv_lens, kv_write=None):
    """serve/engine.py `_forward_rows` for MLA configs, the same contract
    (the last valid token's final hidden state per lane, [Bk, D]; the
    rows written in place): embeds [Bk, T, D], rows {"k": [L, B, 1, S,
    rank + rope]}, row_ids / q_offsets / kv_lens [Bk] int32 device
    tensors, kv_write the extend's write plan (None for a decode)."""
    x = embeds
    Bk, T, _ = x.shape
    positions = q_offsets[:, None].long() + torch.arange(T, device=x.device)
    for l, lp in enumerate(model.layers):
        x = _mla_layer(cfg, lp, l, x, rows, row_ids, positions, q_offsets,
                       kv_lens, kv_write, hasattr(lp, "moe_gate_w"))
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps)
    last = (kv_lens.long() - q_offsets.long() - 1).clamp(0, T - 1)
    return x[torch.arange(Bk, device=x.device), last]
