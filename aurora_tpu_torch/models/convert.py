"""Checkpoint loading: HF / xtuner directories → the port's modules
(aurora_tpu/models/convert.py, its load half).

An xtuner-format AuroraCap directory (the reference's inference.py:42-57)
holds the HF Llama at its root plus `visual_encoder/` (a CLIPVisionModel
or a SiglipVisionModel) and `projector/` (xtuner's ProjectorModel); a
llava-hf directory holds LlavaForConditionalGeneration. HF names map
straight onto `VisionTransformer`, `LlamaModel` and `Projector`, whose
weights share HF's [out, in] layout, so nothing is transposed.

Weights are read without the safetensors or transformers packages:
`.safetensors` by `read_safetensors` (an 8-byte little-endian header
length, a JSON header, then the raw bytes, viewed as tensors with
`torch.frombuffer`), `.bin` by `torch.load(weights_only=True)`, each as a
single file or as shards named by an `*.index.json`. Every tensor keeps
the file's dtype until `load_state_dict` copies it into the module, which
is the one cast to the model's dtype (a bf16 7B checkpoint is never
widened to fp32 on the host).

The decoder families of the reference's converter are mapped: the dense
ones (`DENSE_TYPES`: llama, mistral, qwen2, qwen3, gemma, phi3,
internlm2, stablelm, olmo, glm, starcoder2, cohere, gpt_bigcode, qwen
v1, exaone, chatglm, minicpm), with its fused-weight remaps (Phi-3's qkv
and gate_up, InternLM2's group-interleaved wqkv, Qwen v1's c_attn,
ChatGLM's query_key_value, GPT-BigCode's c_attn and wpe), Gemma's
(1 + w) norms absorbed, OLMo's non-parametric norms synthesized and tied
heads; the sparse-MoE ones (`MOE_TYPES`: Mixtral's block_sparse_moe
experts, Qwen2-MoE's and Qwen3-MoE's mlp.experts with the singular
gated or plural ungated shared expert, DBRX's fused Wqkv and w1/v1/w2
expert slabs, Grok-1's four norms and softcaps, DeepSeek v1's dense
prefix); the CLIP and SigLIP towers, and Yi-VL's projector LayerNorms.
DeepSeek-V2 loads through models/deepseek_v2.py (`load_serving_dir`),
InternVL through models/internvl.py. What the reference refuses (a
Qwen-MoE with dense layers between its sparse ones, DeepSeek v1 with
moe_layer_freq > 1, DBRX's expert-weight norms other than 1) and rope
scalings other than linear raise NotImplementedError. Gemma-2 has its
own module (models/gemma2.py).
`llama_params_from_hf(..., weight_quant=)` quantizes each layer as it
reaches the device (serve/engine.py `build_quantized`), so a checkpoint
larger than the card in bf16 (Mixtral-8x7B, 93 GB) loads as W8 or W4.
Modules are built on the card unless the caller passes a device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import torch

from aurora_tpu_torch.bridge import _load
from aurora_tpu_torch.models.llama import (LAYER_EXTRAS, TOP_EXTRAS,
                                           LlamaConfig, LlamaLayer,
                                           LlamaModel, is_moe_layer)
from aurora_tpu_torch.models.projector import Projector, ProjectorConfig
from aurora_tpu_torch.models.vit import ViTConfig, VisionTransformer

StateDict = Dict[str, torch.Tensor]

_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32, "F64": torch.float64,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}

# the dense families of the universal decoder (models/llama.py)
DENSE_TYPES = ("llama", "mistral", "qwen2", "qwen3", "gemma", "phi3",
               "internlm2", "stablelm", "olmo", "glm", "starcoder2",
               "cohere", "gpt_bigcode", "qwen", "exaone", "chatglm",
               "minicpm")
# the sparse-MoE families of the universal decoder
MOE_TYPES = ("mixtral", "qwen2_moe", "qwen3_moe", "dbrx", "deepseek",
             "grok-1", "grok1", "grok")


# ---------------------------------------------------------------------------
# State-dict IO
# ---------------------------------------------------------------------------

def read_safetensors(path: str) -> StateDict:
    """One `.safetensors` file → {name: CPU tensor in the file's dtype}.
    The tensors are views of one buffer holding the file's data section;
    a tensor whose offset is not a multiple of its item size gets a copy
    of its own bytes."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: truncated data section")
    header.pop("__metadata__", None)
    out: StateDict = {}
    for name, info in header.items():
        if info["dtype"] not in _ST_DTYPES:
            raise NotImplementedError(f"{path}: {name} has dtype "
                                      f"{info['dtype']}")
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        item = torch.empty((), dtype=dtype).element_size()
        if end == start:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        buf, off = data, start
        if start % item:
            buf, off = bytearray(data[start:end]), 0
        out[name] = torch.frombuffer(buf, dtype=dtype, count=(end - start)
                                     // item, offset=off).reshape(
                                         info["shape"])
    return out


def _read_bin(path: str) -> StateDict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_torch_state_dict(model_dir: str) -> StateDict:
    """A HF model directory (safetensors or .bin, one file or shards named
    by an index) → {name: CPU tensor in the file's dtype}."""
    for index, single, read in (
            ("model.safetensors.index.json", "model.safetensors",
             read_safetensors),
            ("pytorch_model.bin.index.json", "pytorch_model.bin", _read_bin)):
        index_path = os.path.join(model_dir, index)
        if os.path.exists(index_path):
            with open(index_path) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
            sd: StateDict = {}
            for fn in files:
                sd.update(read(os.path.join(model_dir, fn)))
            return sd
        if os.path.exists(os.path.join(model_dir, single)):
            return read(os.path.join(model_dir, single))
    raise FileNotFoundError(f"no weights found under {model_dir}")


# ---------------------------------------------------------------------------
# Config parsing
# ---------------------------------------------------------------------------

def _read_config(model_dir: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def vit_config_from_hf(cfg: Dict[str, Any]) -> ViTConfig:
    """A CLIP or SigLIP vision config (top level or under
    `vision_config`)."""
    v = cfg.get("vision_config", cfg)
    model_type = cfg.get("model_type", "clip")
    return ViTConfig(
        hidden_size=v["hidden_size"],
        intermediate_size=v["intermediate_size"],
        num_hidden_layers=v["num_hidden_layers"],
        num_attention_heads=v["num_attention_heads"],
        image_size=v.get("image_size", 378),
        patch_size=v.get("patch_size", 14),
        layer_norm_eps=v.get("layer_norm_eps", 1e-5),
        hidden_act=v.get("hidden_act",
                         "quick_gelu" if "clip" in model_type
                         else "gelu_pytorch_tanh"),
        model_type="siglip" if "siglip" in model_type else "clip")


def llama_config_from_hf(cfg: Dict[str, Any]) -> LlamaConfig:
    """A HF config of a dense or sparse-MoE family → LlamaConfig, the
    reference's llama_config_from_hf (convert.py:112-320), with its
    defaults for absent fields. What the reference refuses, DeepSeek-V2
    (models/deepseek_v2.py) and rope scalings other than linear raise
    NotImplementedError."""
    mt = cfg.get("model_type")
    if mt == "deepseek_v2":
        raise NotImplementedError(
            "model_type='deepseek_v2' is MLA: models/deepseek_v2.py "
            "`deepseek_v2_config_from_hf` (load_serving_dir loads it)")
    if mt not in DENSE_TYPES + MOE_TYPES:
        raise NotImplementedError(
            f"model_type={mt!r}: the port's families are "
            f"{', '.join(DENSE_TYPES + MOE_TYPES)}")
    scaling = cfg.get("rope_scaling") or {}
    kind = scaling.get("rope_type", scaling.get("type"))
    if scaling and kind != "linear":
        raise NotImplementedError(f"rope_scaling {kind!r}: only linear "
                                  "scaling is ported")
    if mt == "dbrx":        # nested attention / ffn knobs, fused experts
        a, f = cfg["attn_config"], cfg["ffn_config"]
        norm_w = f.get("moe_normalize_expert_weights")
        if norm_w not in (None, 1, 1.0):
            raise NotImplementedError(
                f"dbrx moe_normalize_expert_weights={norm_w}: only 1 (as "
                "in the reference)")
        cfg = dict(cfg,
                   hidden_size=cfg["d_model"],
                   num_attention_heads=cfg["n_heads"],
                   num_hidden_layers=cfg["n_layers"],
                   max_position_embeddings=cfg["max_seq_len"],
                   intermediate_size=f["ffn_hidden_size"],
                   num_key_value_heads=a["kv_n_heads"],
                   clip_qkv=a["clip_qkv"],
                   rope_theta=a.get("rope_theta", 10000.0),
                   num_experts=f["moe_num_experts"],
                   num_experts_per_tok=f["moe_top_k"],
                   norm_topk_prob=norm_w is not None)
    if mt == "deepseek":    # v1: a dense prefix, ungated shared experts
        if cfg.get("moe_layer_freq", 1) != 1:
            raise NotImplementedError("deepseek v1 with dense layers "
                                      "between its MoE ones (as in the "
                                      "reference)")
        cfg = dict(cfg,
                   num_experts=cfg.get("n_routed_experts") or 0,
                   first_k_dense=(cfg.get("first_k_dense_replace", 0)
                                  if cfg.get("n_routed_experts") else 0))
    if mt in ("grok-1", "grok1", "grok"):   # caps 30 on attention and
        cfg = dict(cfg,                     # router, scaled embeds/logits
                   model_type="grok",
                   attn_logit_softcap=30.0,
                   moe_router_logit_softcap=30.0,
                   embed_scale=float(
                       cfg.get("embedding_multiplier_scale", 1.0)),
                   logit_scale=float(
                       cfg.get("output_multiplier_scale", 1.0)),
                   head_dim=cfg.get("head_dim", 128))
    if mt in ("qwen2_moe", "qwen3_moe") and (
            cfg.get("decoder_sparse_step", 1) != 1
            or cfg.get("mlp_only_layers")):
        raise NotImplementedError("a Qwen-MoE with dense layers between "
                                  "its sparse ones (as in the reference)")
    if mt == "exaone":      # llama under renamed fields
        cfg = dict(cfg, num_hidden_layers=cfg["num_layers"],
                   rms_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
                   hidden_act=cfg.get("activation_function", "silu"))
    if mt == "qwen":        # v1: fused c_attn with bias, half-width ffn
        cfg = dict(cfg,
                   intermediate_size=cfg["intermediate_size"] // 2,
                   rms_norm_eps=cfg.get("layer_norm_epsilon", 1e-6),
                   rope_theta=cfg.get("rotary_emb_base", 10000.0),
                   max_position_embeddings=cfg.get(
                       "seq_length",
                       cfg.get("max_position_embeddings", 8192)),
                   attention_bias=True)
    if mt == "chatglm":     # GLM structure: interleaved half rotary, MQA
        mqa = cfg.get("multi_query_attention", False)
        cfg = dict(cfg,
                   model_type="glm",
                   intermediate_size=cfg["ffn_hidden_size"],
                   num_hidden_layers=cfg["num_layers"],
                   num_key_value_heads=(cfg["multi_query_group_num"]
                                        if mqa
                                        else cfg["num_attention_heads"]),
                   head_dim=cfg.get("kv_channels"),
                   rms_norm_eps=cfg.get("layernorm_epsilon", 1e-5),
                   partial_rotary_factor=0.5,
                   rope_theta=10000.0 * cfg.get("rope_ratio", 1.0),
                   max_position_embeddings=cfg.get("seq_length", 8192),
                   attention_bias=cfg.get("add_qkv_bias",
                                          cfg.get("add_bias_linear",
                                                  False)))
    if mt == "minicpm":     # embeds, residual branches and logits scaled
        cfg = dict(cfg,
                   embed_scale=float(cfg.get("scale_emb", 1.0)),
                   residual_scale=(float(cfg.get("scale_depth", 1.0))
                                   / cfg["num_hidden_layers"] ** 0.5),
                   logit_scale=(float(cfg.get("dim_model_base",
                                              cfg["hidden_size"]))
                                / cfg["hidden_size"]))
    if mt == "gpt_bigcode":  # GPT-2 names, MQA, learned positions
        cfg = dict(cfg,
                   hidden_size=cfg["n_embd"],
                   num_attention_heads=cfg["n_head"],
                   num_hidden_layers=cfg["n_layer"],
                   intermediate_size=(cfg.get("n_inner")
                                      or 4 * cfg["n_embd"]),
                   max_position_embeddings=cfg["n_positions"],
                   num_key_value_heads=(1 if cfg.get("multi_query", True)
                                        else cfg["n_head"]),
                   layer_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
                   hidden_act=cfg.get("activation_function",
                                      "gelu_pytorch_tanh"))
    if mt == "internlm2" and cfg.get("bias", False):
        raise NotImplementedError("internlm2 with attention bias (as in "
                                  "the reference)")
    mt = cfg.get("model_type")
    gemma = mt == "gemma"
    layernorm = mt in ("stablelm", "olmo", "starcoder2", "gpt_bigcode")
    act_map = {"gelu_pytorch_tanh": "gelu_tanh", "gelu_new": "gelu_tanh",
               "gelu_tanh": "gelu_tanh", "gelu": "gelu"}
    return LlamaConfig(
        qkv_bias=(mt in ("qwen2", "qwen2_moe")
                  or cfg.get("attention_bias", False)
                  or (mt == "stablelm" and cfg.get("use_qkv_bias",
                                                   False))
                  or (mt == "starcoder2" and cfg.get("use_bias", True))
                  or mt == "gpt_bigcode"),
        learned_pos=mt == "gpt_bigcode",
        qk_norm=(mt in ("qwen3", "qwen3_moe")
                 or (mt == "cohere" and cfg.get("use_qk_norm", False))),
        parallel_block=mt == "cohere",
        logit_scale=(cfg.get("logit_scale")
                     if mt in ("cohere", "minicpm", "grok") else None),
        attn_logit_softcap=cfg.get("attn_logit_softcap", 0.0),
        moe_router_logit_softcap=cfg.get("moe_router_logit_softcap", 0.0),
        embed_scale=cfg.get("embed_scale"),
        residual_scale=cfg.get("residual_scale"),
        scale_embeddings=gemma,
        hidden_act=("gelu_tanh" if gemma else
                    act_map.get(cfg.get("hidden_act") or "silu",
                                "silu")),
        norm_upcast_mul=gemma,
        norm_type=("cohere" if mt == "cohere"
                   else "layernorm" if (layernorm or mt == "dbrx")
                   else "rmsnorm"),
        partial_rotary_factor=cfg.get("partial_rotary_factor", 1.0),
        rope_interleaved=mt in ("glm", "cohere"),
        clip_qkv=cfg.get("clip_qkv"),
        mlp_style=("mlp" if mt in ("starcoder2", "gpt_bigcode")
                   else "gated"),
        head_dim_override=cfg.get("head_dim"),
        num_experts=cfg.get("num_local_experts",
                            cfg.get("num_experts", 0)) or 0,
        num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
        moe_router_mode=("softmax_topk"
                         if mt in ("qwen2_moe", "qwen3_moe", "dbrx",
                                   "deepseek", "grok") else "mixtral"),
        first_k_dense=cfg.get("first_k_dense", 0),
        moe_norm_topk=cfg.get("norm_topk_prob", False),
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg.get("num_key_value_heads",
                                    cfg["num_attention_heads"]),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        rms_norm_eps=(cfg.get("rms_norm_eps")
                      or cfg.get("layer_norm_eps")
                      or cfg.get("norm_epsilon") or 1e-5),
        rope_theta=cfg.get("rope_theta", 10000.0),
        rope_linear_scaling=scaling.get("factor") if scaling else None,
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        sliding_window=(cfg.get("sliding_window")
                        if mt in ("mistral", "phi3", "starcoder2")
                        else None))


# ---------------------------------------------------------------------------
# HF names → the port's modules
# ---------------------------------------------------------------------------

def _strip_prefix(sd: StateDict, prefixes=("model.", "vision_model.",
                                           "visual_encoder.")) -> StateDict:
    """Drop wrapper prefixes, so one mapping serves HF standalone models
    and xtuner composite state dicts."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            while k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def vit_params_from_hf(sd: StateDict, cfg: ViTConfig, dtype=torch.float32,
                       device=None) -> VisionTransformer:
    """CLIPVisionModel or SiglipVisionModel names → VisionTransformer
    (the unused post_layernorm, SigLIP's pooling head and HF's
    position_ids buffer are dropped)."""
    sd = _strip_prefix(sd)
    out = {"patch_embed.weight": sd["embeddings.patch_embedding.weight"],
           "position_embedding":
               sd["embeddings.position_embedding.weight"]}
    if not cfg.class_token:
        out["patch_embed.bias"] = sd["embeddings.patch_embedding.bias"]
    else:
        pre = ("pre_layrnorm" if "pre_layrnorm.weight" in sd
               else "pre_layernorm")
        out.update({"class_embedding":
                        sd["embeddings.class_embedding"].reshape(-1),
                    "pre_layernorm.weight": sd[f"{pre}.weight"],
                    "pre_layernorm.bias": sd[f"{pre}.bias"]})
    names = (("ln1", "layer_norm1"), ("ln2", "layer_norm2"),
             ("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
             ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj"),
             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))
    for i in range(cfg.num_hidden_layers):
        for ours, theirs in names:
            for suf in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{suf}"] = \
                    sd[f"encoder.layers.{i}.{theirs}.{suf}"]
    return _load(VisionTransformer(cfg, device="meta", dtype=dtype), out,
                 device)


def _canonical(sd: StateDict, cfg: LlamaConfig) -> StateDict:
    """A dense family's HF names → the llama names (`layers.{i}.self_attn.
    q_proj.weight`, ...), with the reference's remaps of fused and renamed
    weights (convert.py:393-670)."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items() if not k.endswith(".inv_freq")}
    L = cfg.num_hidden_layers
    hq, hkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    nq, nkv = hq * hd, hkv * hd

    if "transformer.blocks.0.norm_attn_norm.attn.Wqkv.weight" in sd:
        # DBRX: fused Wqkv, bias-free LayerNorms, the experts as slabs
        # w1 / v1 / w2 [E·F, D] (w2 applied as x @ w2_e)
        E, F_ = cfg.num_experts, cfg.intermediate_size
        out = {"embed_tokens.weight": sd["transformer.wte.weight"],
               "norm.weight": sd["transformer.norm_f.weight"],
               "lm_head.weight": sd["lm_head.weight"]}
        for i in range(L):
            b, o = f"transformer.blocks.{i}", f"layers.{i}."
            for a, c in (("norm_attn_norm.attn.Wqkv",
                          "self_attn.qkv_proj"),
                         ("norm_attn_norm.attn.out_proj",
                          "self_attn.o_proj"),
                         ("norm_attn_norm.norm_1", "input_layernorm"),
                         ("norm_attn_norm.norm_2",
                          "post_attention_layernorm"),
                         ("ffn.router.layer", "mlp.gate")):
                out[f"{o}{c}.weight"] = sd[f"{b}.{a}.weight"]
            w1, v1, w2 = (sd[f"{b}.ffn.experts.mlp.{n}"].reshape(E, F_, -1)
                          for n in ("w1", "v1", "w2"))
            for e in range(E):
                x = f"{o}mlp.experts.{e}."
                out[x + "gate_proj.weight"] = w1[e]
                out[x + "up_proj.weight"] = v1[e]
                out[x + "down_proj.weight"] = w2[e].t()
        sd = out

    if "layers.0.pre_moe_norm.weight" in sd:
        # Grok-1's four norms: the pre-norms in the input / MLP slots, the
        # output norms in Gemma-2's post_attn_out_norm / post_ffw_norm
        for i in range(L):
            for a, b in (("pre_attn_norm", "input_layernorm"),
                         ("post_attn_norm", "post_attn_out_norm"),
                         ("pre_moe_norm", "post_attention_layernorm"),
                         ("post_moe_norm", "post_ffw_norm")):
                sd[f"layers.{i}.{b}.weight"] = \
                    sd.pop(f"layers.{i}.{a}.weight")

    def split3(out, i, fused, suf, n_k):
        out[f"layers.{i}.self_attn.q_proj.{suf}"] = fused[:nq]
        out[f"layers.{i}.self_attn.k_proj.{suf}"] = fused[nq:nq + n_k]
        out[f"layers.{i}.self_attn.v_proj.{suf}"] = fused[nq + n_k:]

    if "layers.0.attention.wqkv.weight" in sd:
        # InternLM2: wqkv [Hkv, q_per_kv + 2, hd, hidden], each group's q
        # heads, then its k, then its v
        qpk = hq // hkv
        for i in range(L):
            w = sd.pop(f"layers.{i}.attention.wqkv.weight")
            w = w.reshape(hkv, qpk + 2, hd, -1)
            sd[f"layers.{i}.self_attn.q_proj.weight"] = \
                w[:, :qpk].reshape(nq, -1)
            sd[f"layers.{i}.self_attn.k_proj.weight"] = \
                w[:, qpk].reshape(nkv, -1)
            sd[f"layers.{i}.self_attn.v_proj.weight"] = \
                w[:, qpk + 1].reshape(nkv, -1)
            for a, b in (("attention.wo", "self_attn.o_proj"),
                         ("feed_forward.w1", "mlp.gate_proj"),
                         ("feed_forward.w3", "mlp.up_proj"),
                         ("feed_forward.w2", "mlp.down_proj"),
                         ("attention_norm", "input_layernorm"),
                         ("ffn_norm", "post_attention_layernorm")):
                sd[f"layers.{i}.{b}.weight"] = \
                    sd.pop(f"layers.{i}.{a}.weight")
        sd["embed_tokens.weight"] = sd.pop("tok_embeddings.weight")
        if "output.weight" in sd:
            sd["lm_head.weight"] = sd.pop("output.weight")

    if ("transformer.h.0.attn.c_attn.weight" in sd
            and "transformer.wpe.weight" in sd):
        # GPT-BigCode: c_attn (q + MQA kv) with bias, wpe, LayerNorms
        out = {"embed_tokens.weight": sd["transformer.wte.weight"],
               "wpe.weight": sd["transformer.wpe.weight"],
               "norm.weight": sd["transformer.ln_f.weight"],
               "norm.bias": sd["transformer.ln_f.bias"]}
        for i in range(L):
            b = f"transformer.h.{i}"
            for suf in ("weight", "bias"):
                split3(out, i, sd[f"{b}.attn.c_attn.{suf}"], suf, nkv)
                for a, c in (("attn.c_proj", "self_attn.o_proj"),
                             ("mlp.c_fc", "mlp.up_proj"),
                             ("mlp.c_proj", "mlp.down_proj"),
                             ("ln_1", "input_layernorm"),
                             ("ln_2", "post_attention_layernorm")):
                    out[f"layers.{i}.{c}.{suf}"] = sd[f"{b}.{a}.{suf}"]
        sd = out

    if "transformer.h.0.mlp.w1.weight" in sd:
        # Qwen v1: c_attn with bias (MHA thirds), w2 = gate, w1 = up
        out = {"embed_tokens.weight": sd["transformer.wte.weight"],
               "norm.weight": sd["transformer.ln_f.weight"],
               "lm_head.weight": sd["lm_head.weight"]}
        for i in range(L):
            b = f"transformer.h.{i}"
            for suf in ("weight", "bias"):
                if f"{b}.attn.c_attn.{suf}" in sd:
                    split3(out, i, sd[f"{b}.attn.c_attn.{suf}"], suf, nq)
            for a, c in (("attn.c_proj", "self_attn.o_proj"),
                         ("mlp.w2", "mlp.gate_proj"),
                         ("mlp.w1", "mlp.up_proj"),
                         ("mlp.c_proj", "mlp.down_proj"),
                         ("ln_1", "input_layernorm"),
                         ("ln_2", "post_attention_layernorm")):
                out[f"layers.{i}.{c}.weight"] = sd[f"{b}.{a}.weight"]
        sd = out

    if "transformer.h.0.attn.attention.q_proj.weight" in sd:
        # EXAONE: llama under transformer.h names
        out = {"embed_tokens.weight": sd["transformer.wte.weight"],
               "norm.weight": sd["transformer.ln_f.weight"],
               "lm_head.weight": sd["lm_head.weight"]}
        for i in range(L):
            b = f"transformer.h.{i}"
            for a, c in (("attn.attention.q_proj", "self_attn.q_proj"),
                         ("attn.attention.k_proj", "self_attn.k_proj"),
                         ("attn.attention.v_proj", "self_attn.v_proj"),
                         ("attn.attention.out_proj", "self_attn.o_proj"),
                         ("mlp.c_fc_0", "mlp.gate_proj"),
                         ("mlp.c_fc_1", "mlp.up_proj"),
                         ("mlp.c_proj", "mlp.down_proj"),
                         ("ln_1", "input_layernorm"),
                         ("ln_2", "post_attention_layernorm")):
                out[f"layers.{i}.{c}.weight"] = sd[f"{b}.{a}.weight"]
        sd = out

    if "transformer.encoder.layers.0.self_attention.query_key_value." \
            "weight" in sd:
        # ChatGLM-2/3: query_key_value (+bias), dense_h_to_4h [gate; up]
        out = {"embed_tokens.weight":
               sd["transformer.embedding.word_embeddings.weight"],
               "norm.weight":
               sd["transformer.encoder.final_layernorm.weight"],
               "lm_head.weight": sd["transformer.output_layer.weight"]}
        for i in range(L):
            b = f"transformer.encoder.layers.{i}"
            for suf in ("weight", "bias"):
                key = f"{b}.self_attention.query_key_value.{suf}"
                if key in sd:
                    split3(out, i, sd[key], suf, nkv)
            gu = sd[f"{b}.mlp.dense_h_to_4h.weight"]
            F = gu.shape[0] // 2
            out[f"layers.{i}.mlp.gate_proj.weight"] = gu[:F]
            out[f"layers.{i}.mlp.up_proj.weight"] = gu[F:]
            for a, c in (("self_attention.dense", "self_attn.o_proj"),
                         ("mlp.dense_4h_to_h", "mlp.down_proj"),
                         ("input_layernorm", "input_layernorm"),
                         ("post_attention_layernorm",
                          "post_attention_layernorm")):
                out[f"layers.{i}.{c}.weight"] = sd[f"{b}.{a}.weight"]
        sd = out

    if "layers.0.mlp.c_fc.weight" in sd:    # StarCoder2: c_fc / c_proj
        for i in range(L):
            for a, b in (("c_fc", "up_proj"), ("c_proj", "down_proj")):
                for suf in ("weight", "bias"):
                    key = f"layers.{i}.mlp.{a}.{suf}"
                    if key in sd:
                        sd[f"layers.{i}.mlp.{b}.{suf}"] = sd.pop(key)

    if "layers.0.self_attn.qkv_proj.weight" in sd:      # Phi-3
        for i in range(L):
            split3(sd, i, sd.pop(f"layers.{i}.self_attn.qkv_proj.weight"),
                   "weight", nkv)
    if "layers.0.mlp.gate_up_proj.weight" in sd:
        for i in range(L):
            gu = sd.pop(f"layers.{i}.mlp.gate_up_proj.weight")
            inter = gu.shape[0] // 2
            sd[f"layers.{i}.mlp.gate_proj.weight"] = gu[:inter]
            sd[f"layers.{i}.mlp.up_proj.weight"] = gu[inter:]
    return sd


def _plus_one(w: torch.Tensor, dtype) -> torch.Tensor:
    """Gemma's (1 + w) norm weight in `dtype`, as the reference absorbs
    it: w rounded to dtype, 1 added in fp32, rounded again."""
    return (w.to(dtype).float() + 1.0).to(dtype)


def _moe_params(out, sd, pre, src, cfg):
    """A MoE layer's HF weights → LlamaLayer names: Qwen's / DeepSeek's
    mlp.gate router and mlp.experts.{e}.*_proj with the singular
    (Qwen2-MoE, with its scalar shared_expert_gate) or plural (DeepSeek)
    shared expert, or Mixtral's / Grok's block_sparse_moe gate and
    experts.{e}.w1 (gate) / w3 (up) / w2 (down); [out, in] weights become
    [E, in, out] stacks (the shared expert one expert)."""
    E = cfg.num_experts
    if src + "mlp.gate.weight" in sd:
        out[pre + "moe_router"] = sd[src + "mlp.gate.weight"].t()
        names = (("moe_gate", "gate_proj"), ("moe_up", "up_proj"),
                 ("moe_down", "down_proj"))
        expert = src + "mlp.experts.{}.{}.weight"
        shared = next((p for p in ("mlp.shared_expert.",
                                   "mlp.shared_experts.")
                       if f"{src}{p}gate_proj.weight" in sd), None)
    else:
        out[pre + "moe_router"] = sd[src + "block_sparse_moe.gate.weight"].t()
        names = (("moe_gate", "w1"), ("moe_up", "w3"), ("moe_down", "w2"))
        expert = src + "block_sparse_moe.experts.{}.{}.weight"
        shared = None
    for ours, theirs in names:
        out[pre + ours + ".weight"] = torch.stack(
            [sd[expert.format(e, theirs)].t() for e in range(E)])
        if shared:
            out[pre + "moe_shared_" + ours[4:] + ".weight"] = \
                sd[f"{src}{shared}{theirs}.weight"].t()[None]
    if shared and src + "mlp.shared_expert_gate.weight" in sd:
        out[pre + "moe_shared_gate_w"] = \
            sd[src + "mlp.shared_expert_gate.weight"].t()


# a llama layer's names in the port ↔ in HF checkpoints (the module, its
# `.weight` / `.bias` after it); models/export.py writes by the same table
HF_LAYER_NORMS = (("input_norm", "input_layernorm"),
                  ("post_attn_norm", "post_attention_layernorm"))
HF_LAYER_PROJS = (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                  ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                  ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
                  ("down", "mlp.down_proj"))


def llama_params_from_hf(sd: StateDict, cfg: LlamaConfig,
                         dtype=torch.bfloat16, device=None,
                         weight_quant: str = "none") -> LlamaModel:
    """A dense or MoE family's HF names → LlamaModel (the reference's
    llama_params_from_hf, convert.py:393-806). A
    LlamaForSequenceClassification checkpoint's `score.weight` becomes the
    `score` head; such a checkpoint has no lm_head, and its embedding is
    copied into the LM head (the reference's tied fallback, convert.py:
    748-749), so that it still loads for generation. A tied head (Gemma,
    Cohere, GPT-BigCode) is the embedding itself. weight_quant "int8" or
    "int4": the model in that layout (unfused), each layer quantized as it
    reaches the device (serve/engine.py `build_quantized`)."""
    sd = _canonical(sd, cfg)
    L, d = cfg.num_hidden_layers, cfg.hidden_size
    out = {"embed_tokens": sd["embed_tokens.weight"],
           "final_norm": sd.get("norm.weight", torch.ones(d))}
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = sd.get("lm_head.weight",
                                       sd["embed_tokens.weight"])
    num_labels = 0
    if "score.weight" in sd:
        out["score.weight"] = sd["score.weight"]
        num_labels = sd["score.weight"].shape[0]
    if "wpe.weight" in sd:
        out["wpe"] = sd["wpe.weight"]
    norms = HF_LAYER_NORMS
    if cfg.parallel_block:          # Cohere: one norm a layer
        norms = norms[:1]
    for i in range(L):
        pre, src = f"layers.{i}.", f"layers.{i}."
        for ours, theirs in norms:
            out[pre + ours] = sd.get(src + theirs + ".weight",
                                     torch.ones(d))
            if cfg.norm_type == "layernorm":   # OLMo: zeros synthesized
                out[pre + ours + "_bias"] = sd.get(
                    src + theirs + ".bias", torch.zeros(d))
        for name, key in HF_LAYER_PROJS:
            if src + key + ".weight" not in sd:
                continue        # a non-gated MLP has no gate
            out[pre + name + ".weight"] = sd[src + key + ".weight"]
            bias = src + key + ".bias"
            if bias in sd and (name in ("o", "up", "down")
                               or cfg.qkv_bias and name in "qkv"):
                out[pre + name + "_bias"] = sd[bias]
        if src + "self_attn.q_norm.weight" in sd:      # Qwen3, Cohere
            out[pre + "q_norm"] = sd[src + "self_attn.q_norm.weight"]
            out[pre + "k_norm"] = sd[src + "self_attn.k_norm.weight"]
        for name in ("post_attn_out_norm", "post_ffw_norm"):   # Grok-1
            if src + name + ".weight" in sd:
                out[pre + name] = sd[src + name + ".weight"]
        if is_moe_layer(cfg, i):
            _moe_params(out, sd, pre, src, cfg)
    if cfg.norm_type == "layernorm":
        out["final_norm_bias"] = sd.get("norm.bias", torch.zeros(d))
    if cfg.norm_upcast_mul:         # Gemma's (1 + w): absorb the 1
        for k in [k for k in out if k.endswith("_norm")
                  and not k.endswith(("q_norm", "k_norm"))]:
            out[k] = _plus_one(out[k], dtype)
    extras = {k.rsplit(".", 1)[-1] for k in out} | set(out)
    kw = dict(extras=[n for n in LAYER_EXTRAS + TOP_EXTRAS if n in extras])
    last = f"layers.{L - 1}."
    if last + "moe_gate.weight" in out:
        shared = out.get(last + "moe_shared_gate.weight")
        kw.update(moe_inter=out[last + "moe_gate.weight"].shape[2],
                  shared_inter=0 if shared is None else shared.shape[2],
                  shared_gate=last + "moe_shared_gate_w" in out)
    if weight_quant == "none":
        return _load(LlamaModel(cfg, device="meta", dtype=dtype,
                                num_labels=num_labels, **kw), out, device)
    from aurora_tpu_torch.serve.engine import build_quantized
    device = device or "cuda"

    def dense_layer(l):
        pre = f"layers.{l}."
        layer = LlamaLayer(cfg, device="meta", dtype=dtype,
                           extras=tuple(kw["extras"]),
                           moe=is_moe_layer(cfg, l),
                           **{k: v for k, v in kw.items() if k != "extras"})
        return _load(layer, {k[len(pre):]: v for k, v in out.items()
                             if k.startswith(pre)}, device)

    return build_quantized(cfg, weight_quant, dense_layer,
                           {k: v for k, v in out.items()
                            if not k.startswith("layers.")}, device, dtype,
                           num_labels=num_labels, **kw)


def projector_params_from_hf(sd: StateDict, cfg: ProjectorConfig,
                             dtype=torch.float32, device=None) -> Projector:
    """xtuner's ProjectorModel (Sequential `model.{0,2,...}`, GELUs in the
    odd slots) → Projector."""
    sd = _strip_prefix(sd, ("projector.", "model."))
    out = {}
    for i in range(cfg.depth):
        for suf in ("weight", "bias"):
            out[f"layers.{i}.{suf}"] = sd[f"{2 * i}.{suf}"]
    return _load(Projector(cfg, device="meta", dtype=dtype), out, device)


# ---------------------------------------------------------------------------
# Directory loaders
# ---------------------------------------------------------------------------

def load_serving_dir(model_path: str, dtype=torch.bfloat16, device=None,
                     weight_quant: str = "none"):
    """A HF decoder directory → (model, serving LlamaConfig) as the
    serving engine runs it (the reference's cli/serve.py:94-131):
    Gemma2ForCausalLM through models/gemma2.py and its serving mapping;
    DeepseekV2ForCausalLM through models/deepseek_v2.py and serve/mla.py
    (an MLAServingModel; bf16 only, so weight_quant other than "none"
    raises NotImplementedError); every other model_type through
    `llama_config_from_hf` and `llama_params_from_hf`, with weight_quant
    "int8" / "int4" quantizing each layer as it reaches the device (the
    caller fuses the streams). Gemma-2 loads in dtype and is quantized by
    the caller."""
    hf_cfg = _read_config(model_path)
    archs = " ".join(hf_cfg.get("architectures") or [])
    if "DeepseekV2" in archs or hf_cfg.get("model_type") == "deepseek_v2":
        if weight_quant != "none":
            raise NotImplementedError(
                f"weight_quant={weight_quant!r}: MLA (DeepSeek-V2) serves "
                "bf16 weights and latents, as in the reference")
        from aurora_tpu_torch.models.deepseek_v2 import (
            deepseek_v2_config_from_hf, deepseek_v2_params_from_hf)
        from aurora_tpu_torch.serve.mla import deepseek_serving_params
        dcfg = deepseek_v2_config_from_hf(hf_cfg)
        model = deepseek_serving_params(deepseek_v2_params_from_hf(
            load_torch_state_dict(model_path), dcfg, dtype, device), dcfg)
        return model, model.cfg
    if "Gemma2" in archs or hf_cfg.get("model_type") == "gemma2":
        from aurora_tpu_torch.models.gemma2 import (gemma2_config_from_hf,
                                                    gemma2_params_from_hf,
                                                    gemma2_serving_params)
        model = gemma2_serving_params(gemma2_params_from_hf(
            load_torch_state_dict(model_path),
            gemma2_config_from_hf(hf_cfg), dtype, device))
        return model, model.cfg
    cfg = llama_config_from_hf(hf_cfg)
    return llama_params_from_hf(load_torch_state_dict(model_path), cfg,
                                dtype, device, weight_quant), cfg


Loaded = Tuple[LlamaModel, LlamaConfig, VisionTransformer, ViTConfig,
               Projector, ProjectorConfig]


def load_llava_hf_dir(model_dir: str, llm_dtype=torch.bfloat16,
                      vit_dtype=torch.float32, device=None) -> Loaded:
    """A llava-hf directory (LlavaForConditionalGeneration, the 4.52+ key
    layout or the legacy one; Yi-VL's projector LayerNorms `ln_1`/`ln_2`
    where present) → the same tuple as load_auroracap_dir; at
    token_kept_ratio 1.0 the AuroraCap pipeline is LLaVA-1.5's."""
    cfg = _read_config(model_dir)
    if cfg.get("model_type") not in ("llava", "llava_next"):
        raise ValueError(f"not a llava checkpoint: {cfg.get('model_type')}")
    if cfg.get("vision_feature_select_strategy", "default") != "default":
        raise NotImplementedError("only the CLS-dropping 'default' feature "
                                  "strategy is ported")
    sel = cfg.get("vision_feature_layer", -2)
    if sel != -2:
        raise NotImplementedError(f"vision_feature_layer={sel} (-2 only)")
    llm_cfg = llama_config_from_hf(cfg["text_config"])
    vit_cfg = vit_config_from_hf({"vision_config": cfg["vision_config"],
                                  "model_type": "clip"})
    sd = load_torch_state_dict(model_dir)

    def split(marker):
        return {k.split(marker, 1)[1]: v for k, v in sd.items()
                if marker in k}

    proj_sd = split("multi_modal_projector.")
    llm_sd = split("language_model.")
    if "lm_head.weight" in sd:      # 4.52+ layout: the head at top level
        llm_sd["lm_head.weight"] = sd["lm_head.weight"]
    llm = llama_params_from_hf(llm_sd, llm_cfg, llm_dtype, device)
    vit = vit_params_from_hf(split("vision_tower."), vit_cfg, vit_dtype,
                             device)
    pj_cfg = ProjectorConfig(visual_hidden_size=vit_cfg.hidden_size,
                             llm_hidden_size=llm_cfg.hidden_size, depth=2)
    pj_sd = {f"layers.{i - 1}.{suf}": proj_sd[f"linear_{i}.{suf}"]
             for i in (1, 2) for suf in ("weight", "bias")}
    # Yi-VL: a LayerNorm after each linear (ln_1, ln_2)
    norms = [i - 1 for i in (1, 2) if f"ln_{i}.weight" in proj_sd]
    pj_sd.update({f"norms.ln{i}.{suf}": proj_sd[f"ln_{i + 1}.{suf}"]
                  for i in norms for suf in ("weight", "bias")})
    pj = _load(Projector(pj_cfg, device="meta", dtype=vit_dtype,
                         norm_layers=norms), pj_sd, device)
    return llm, llm_cfg, vit, vit_cfg, pj, pj_cfg


def load_auroracap_dir(model_dir: str, llm_dtype=torch.bfloat16,
                       vit_dtype=torch.float32, device=None) -> Loaded:
    """An xtuner-format AuroraCap directory: the HF llama at the root,
    `visual_encoder/` (CLIP or SigLIP) and `projector/`
    (inference.py:42-57)."""
    llm_cfg = llama_config_from_hf(_read_config(model_dir))
    llm = llama_params_from_hf(load_torch_state_dict(model_dir), llm_cfg,
                               llm_dtype, device)
    ve_dir = os.path.join(model_dir, "visual_encoder")
    vit_cfg = vit_config_from_hf(_read_config(ve_dir))
    vit = vit_params_from_hf(load_torch_state_dict(ve_dir), vit_cfg,
                             vit_dtype, device)
    pj_dir = os.path.join(model_dir, "projector")
    pj_raw = _read_config(pj_dir)
    pj_cfg = ProjectorConfig(
        visual_hidden_size=pj_raw.get("visual_hidden_size",
                                      vit_cfg.hidden_size),
        llm_hidden_size=pj_raw.get("llm_hidden_size", llm_cfg.hidden_size),
        depth=pj_raw.get("depth", 2))
    pj = projector_params_from_hf(load_torch_state_dict(pj_dir), pj_cfg,
                                  vit_dtype, device)
    return llm, llm_cfg, vit, vit_cfg, pj, pj_cfg
