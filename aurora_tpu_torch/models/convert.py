"""Checkpoint loading: HF / xtuner directories → the port's modules
(aurora_tpu/models/convert.py, its load half).

An xtuner-format AuroraCap directory (the reference's inference.py:42-57)
holds the HF Llama at its root plus `visual_encoder/` (a CLIPVisionModel)
and `projector/` (xtuner's ProjectorModel); a llava-hf directory holds
LlavaForConditionalGeneration. HF names map straight onto
`VisionTransformer`, `LlamaModel` and `Projector`, whose weights share
HF's [out, in] layout, so nothing is transposed.

Weights are read without the safetensors or transformers packages:
`.safetensors` by `read_safetensors` (an 8-byte little-endian header
length, a JSON header, then the raw bytes, viewed as tensors with
`torch.frombuffer`), `.bin` by `torch.load(weights_only=True)`, each as a
single file or as shards named by an `*.index.json`. Every tensor keeps
the file's dtype until `load_state_dict` copies it into the module, which
is the one cast to the model's dtype (a bf16 7B checkpoint is never
widened to fp32 on the host).

The dense decoder families of the reference's converter are mapped
(`DENSE_TYPES`: llama, mistral, qwen2, qwen3, gemma, phi3, internlm2,
stablelm, olmo, glm, starcoder2, cohere, gpt_bigcode, qwen v1, exaone,
chatglm, minicpm), with its fused-weight remaps (Phi-3's qkv and
gate_up, InternLM2's group-interleaved wqkv, Qwen v1's c_attn, ChatGLM's
query_key_value, GPT-BigCode's c_attn and wpe), Gemma's (1 + w) norms
absorbed, OLMo's non-parametric norms synthesized and tied heads; and the
CLIP tower. MoE and MLA model types (`NOT_PORTED_TYPES`), rope scalings
other than linear and the Yi-VL projector LayerNorms raise
NotImplementedError. Gemma-2 has its own module (models/gemma2.py).
Modules are built on the card unless the caller passes a device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import torch

from aurora_tpu_torch.bridge import NOT_PORTED, _load
from aurora_tpu_torch.models.llama import (LAYER_EXTRAS, TOP_EXTRAS,
                                           LlamaConfig, LlamaModel)
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
# MoE and MLA families of the reference, not ported yet
NOT_PORTED_TYPES = ("mixtral", "qwen2_moe", "qwen3_moe", "dbrx", "grok-1",
                    "grok1", "grok", "deepseek", "deepseek_v2")


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
    """A CLIP vision config (top level or under `vision_config`). Other
    towers raise NotImplementedError in ViTConfig."""
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
    """A HF config of a dense family → LlamaConfig, the reference's
    llama_config_from_hf (convert.py:112-320) on its dense branches, with
    its defaults for absent fields. MoE and MLA types and rope scalings
    other than linear raise NotImplementedError."""
    mt = cfg.get("model_type")
    if mt in NOT_PORTED_TYPES or (cfg.get("num_local_experts")
                                  or cfg.get("num_experts")):
        raise NotImplementedError(f"model_type={mt!r}: not ported yet, "
                                  f"{NOT_PORTED}")
    if mt not in DENSE_TYPES:
        raise NotImplementedError(
            f"model_type={mt!r}: the port's dense families are "
            f"{', '.join(DENSE_TYPES)}")
    scaling = cfg.get("rope_scaling") or {}
    kind = scaling.get("type", scaling.get("rope_type"))
    if scaling and kind != "linear":
        raise NotImplementedError(f"rope_scaling {kind!r}: only linear "
                                  "scaling is ported")
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
        qkv_bias=(mt == "qwen2"
                  or cfg.get("attention_bias", False)
                  or (mt == "stablelm" and cfg.get("use_qkv_bias",
                                                   False))
                  or (mt == "starcoder2" and cfg.get("use_bias", True))
                  or mt == "gpt_bigcode"),
        learned_pos=mt == "gpt_bigcode",
        qk_norm=(mt == "qwen3"
                 or (mt == "cohere" and cfg.get("use_qk_norm", False))),
        parallel_block=mt == "cohere",
        logit_scale=(cfg.get("logit_scale")
                     if mt in ("cohere", "minicpm") else None),
        attn_logit_softcap=cfg.get("attn_logit_softcap", 0.0),
        embed_scale=cfg.get("embed_scale"),
        residual_scale=cfg.get("residual_scale"),
        scale_embeddings=gemma,
        hidden_act=("gelu_tanh" if gemma else
                    act_map.get(cfg.get("hidden_act") or "silu",
                                "silu")),
        norm_upcast_mul=gemma,
        norm_type=("cohere" if mt == "cohere"
                   else "layernorm" if layernorm else "rmsnorm"),
        partial_rotary_factor=cfg.get("partial_rotary_factor", 1.0),
        rope_interleaved=mt in ("glm", "cohere"),
        clip_qkv=cfg.get("clip_qkv"),
        mlp_style=("mlp" if mt in ("starcoder2", "gpt_bigcode")
                   else "gated"),
        head_dim_override=cfg.get("head_dim"),
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
    """CLIPVisionModel names → VisionTransformer (the unused
    post_layernorm is dropped; so is HF's position_ids buffer)."""
    sd = _strip_prefix(sd)
    if "embeddings.patch_embedding.bias" in sd:
        raise NotImplementedError("a patch-embedding bias is not ported")
    pre = ("pre_layrnorm" if "pre_layrnorm.weight" in sd
           else "pre_layernorm")
    out = {"patch_embed.weight": sd["embeddings.patch_embedding.weight"],
           "class_embedding": sd["embeddings.class_embedding"].reshape(-1),
           "position_embedding":
               sd["embeddings.position_embedding.weight"],
           "pre_layernorm.weight": sd[f"{pre}.weight"],
           "pre_layernorm.bias": sd[f"{pre}.bias"]}
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


def llama_params_from_hf(sd: StateDict, cfg: LlamaConfig,
                         dtype=torch.bfloat16, device=None) -> LlamaModel:
    """A dense family's HF names → LlamaModel (the reference's
    llama_params_from_hf, convert.py:393-750, on the dense families). A
    LlamaForSequenceClassification checkpoint's `score.weight` becomes the
    `score` head; such a checkpoint has no lm_head, and its embedding is
    copied into the LM head (the reference's tied fallback, convert.py:
    748-749), so that it still loads for generation. A tied head (Gemma,
    Cohere, GPT-BigCode) is the embedding itself."""
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
    norms = (("input_norm", "input_layernorm"),
             ("post_attn_norm", "post_attention_layernorm"))
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
        for name, key in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                          ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                          ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
                          ("down", "mlp.down_proj")):
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
    if cfg.norm_type == "layernorm":
        out["final_norm_bias"] = sd.get("norm.bias", torch.zeros(d))
    if cfg.norm_upcast_mul:         # Gemma's (1 + w): absorb the 1
        for k in [k for k in out if k.endswith("_norm")
                  and not k.endswith(("q_norm", "k_norm"))]:
            out[k] = _plus_one(out[k], dtype)
    extras = {k.rsplit(".", 1)[-1] for k in out} | set(out)
    return _load(LlamaModel(cfg, device="meta", dtype=dtype,
                            num_labels=num_labels,
                            extras=[n for n in LAYER_EXTRAS + TOP_EXTRAS
                                    if n in extras]), out, device)


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

def load_serving_dir(model_path: str, dtype=torch.bfloat16, device=None):
    """A HF decoder directory → (LlamaModel, LlamaConfig) as the serving
    engine runs it: Gemma2ForCausalLM through models/gemma2.py and its
    serving mapping (the reference's cli/serve.py:94-104), every dense
    model_type through `llama_config_from_hf`. DeepseekV2 (MLA) raises
    NotImplementedError naming its ROADMAP item."""
    hf_cfg = _read_config(model_path)
    archs = " ".join(hf_cfg.get("architectures") or [])
    if "DeepseekV2" in archs:
        raise NotImplementedError(f"{archs}: not ported yet, {NOT_PORTED}")
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
                                dtype, device), cfg


Loaded = Tuple[LlamaModel, LlamaConfig, VisionTransformer, ViTConfig,
               Projector, ProjectorConfig]


def load_llava_hf_dir(model_dir: str, llm_dtype=torch.bfloat16,
                      vit_dtype=torch.float32, device=None) -> Loaded:
    """A llava-hf directory (LlavaForConditionalGeneration, the 4.52+ key
    layout or the legacy one) → the same tuple as load_auroracap_dir; at
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
    if any(k.startswith("ln_") for k in proj_sd):
        raise NotImplementedError("projector LayerNorms (Yi-VL) are not "
                                  "ported")
    llm_sd = split("language_model.")
    if "lm_head.weight" in sd:      # 4.52+ layout: the head at top level
        llm_sd["lm_head.weight"] = sd["lm_head.weight"]
    llm = llama_params_from_hf(llm_sd, llm_cfg, llm_dtype, device)
    vit = vit_params_from_hf(split("vision_tower."), vit_cfg, vit_dtype,
                             device)
    pj_cfg = ProjectorConfig(visual_hidden_size=vit_cfg.hidden_size,
                             llm_hidden_size=llm_cfg.hidden_size, depth=2)
    pj = _load(Projector(pj_cfg, device="meta", dtype=vit_dtype),
               {f"layers.{i - 1}.{suf}": proj_sd[f"linear_{i}.{suf}"]
                for i in (1, 2) for suf in ("weight", "bias")}, device)
    return llm, llm_cfg, vit, vit_cfg, pj, pj_cfg


def load_auroracap_dir(model_dir: str, llm_dtype=torch.bfloat16,
                       vit_dtype=torch.float32, device=None) -> Loaded:
    """An xtuner-format AuroraCap directory: the HF llama at the root,
    `visual_encoder/` and `projector/` (inference.py:42-57)."""
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
