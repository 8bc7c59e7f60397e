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

Only the families `bridge.llama_config_from` accepts (llama, with Vicuna
under it, and mistral) and the CLIP tower are mapped. Other model types,
tied embeddings, rope scalings other than linear and the Yi-VL projector
LayerNorms raise NotImplementedError. Modules are built on the card
unless the caller passes a device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import torch

from aurora_tpu_torch.bridge import _load
from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
from aurora_tpu_torch.models.projector import Projector, ProjectorConfig
from aurora_tpu_torch.models.vit import ViTConfig, VisionTransformer

StateDict = Dict[str, torch.Tensor]

_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32, "F64": torch.float64,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}

# the llama families of the port's decoder (bridge.llama_config_from)
_LLAMA_TYPES = ("llama", "mistral")


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
    """A HF llama or mistral config → LlamaConfig, with the reference's
    defaults for absent fields (convert.py:112); anything the port's
    decoder does not carry raises NotImplementedError."""
    mt = cfg.get("model_type")
    if mt not in _LLAMA_TYPES:
        raise NotImplementedError(
            f"model_type={mt!r}: the port serves the llama family only "
            f"({', '.join(_LLAMA_TYPES)})")
    if cfg.get("tie_word_embeddings", False):
        raise NotImplementedError("tied embeddings are not ported")
    for key, off in (("attention_bias", False), ("mlp_bias", False),
                     ("hidden_act", "silu")):
        if cfg.get(key, off) != off:
            raise NotImplementedError(f"{key}={cfg[key]!r} is not ported")
    heads = cfg["num_attention_heads"]
    head_dim = cfg.get("head_dim")
    if head_dim is not None and head_dim != cfg["hidden_size"] // heads:
        raise NotImplementedError(f"head_dim={head_dim} other than "
                                  "hidden_size / heads is not ported")
    scaling = cfg.get("rope_scaling") or {}
    kind = scaling.get("type", scaling.get("rope_type"))
    if scaling and kind != "linear":
        raise NotImplementedError(f"rope_scaling {kind!r}: only linear "
                                  "scaling is ported")
    return LlamaConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=heads,
        num_key_value_heads=cfg.get("num_key_value_heads", heads),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        rms_norm_eps=cfg.get("rms_norm_eps") or 1e-5,
        rope_theta=cfg.get("rope_theta", 10000.0),
        rope_linear_scaling=scaling.get("factor") if scaling else None,
        sliding_window=(cfg.get("sliding_window") if mt == "mistral"
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


def llama_params_from_hf(sd: StateDict, cfg: LlamaConfig,
                         dtype=torch.bfloat16, device=None) -> LlamaModel:
    """LlamaForCausalLM / MistralForCausalLM names → LlamaModel."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}
    out = {"embed_tokens": sd["embed_tokens.weight"],
           "final_norm": sd["norm.weight"],
           "lm_head.weight": sd["lm_head.weight"]}
    names = (("input_norm", "input_layernorm.weight"),
             ("post_attn_norm", "post_attention_layernorm.weight"),
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
    return _load(LlamaModel(cfg, device="meta", dtype=dtype), out, device)


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
