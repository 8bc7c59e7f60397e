"""Checkpoint export: the port's modules → HF-style directories
(aurora_tpu/models/export.py), the write half of models/convert.py.

Three layouts of an AuroraModel, as the reference writes them:
  * 'xtuner'      the HF llama at the root, `visual_encoder/` and
                  `projector/` beside it; `load_auroracap_dir` reads it;
  * 'huggingface' LlavaForConditionalGeneration's keys (language_model.*,
                  vision_tower.*, multi_modal_projector.linear_{1,2}.*),
                  the vocabulary padded to a multiple of 64 with rows
                  sampled from a normal of the existing rows' mean and
                  covariance (`np.random.default_rng(0)`);
                  `load_llava_hf_dir` reads it;
  * 'official'    the LLaVA repository's layout: llama keys at the root,
                  the tower under model.vision_tower.vision_tower.*, the
                  projector as model.mm_projector.{0,2}, LLaVA's config
                  fields on the llama config.

Tensors are written in float32 by default, as the reference writes them,
or in the `dtype` asked for. Safetensors files are written with
the standard library (`write_safetensors`: an 8-byte little-endian header
length, the JSON header padded with spaces to 8 bytes, then the raw
bytes), the mirror of models/convert.py `read_safetensors`; above
`max_shard_bytes` a directory is split into shards named by an HF-style
`model.safetensors.index.json`.

Only the reference's llama keys are written (embeddings, norms, head,
q/k/v/o/gate/up/down and q/k/v biases); a fused, quantized or routed
model, or a projector with LayerNorms, raises. The tower's unused
post_layernorm, which the port does not hold, is written as HF's
LayerNorm starts it (ones, zeros).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from aurora_tpu_torch.models.convert import HF_LAYER_NORMS, HF_LAYER_PROJS
from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
from aurora_tpu_torch.models.projector import Projector, ProjectorConfig
from aurora_tpu_torch.models.vit import ViTConfig, VisionTransformer

StateDict = Dict[str, torch.Tensor]

_ST_CODES = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32", torch.float64: "F64",
             torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
             torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}

# the reference's order (name by name), which decides where a sharded
# write splits: the norms, then the projections (models/convert.py's
# name table, which the loader reads)
_LAYER_NAMES = (tuple((ours, theirs + ".weight")
                      for ours, theirs in HF_LAYER_NORMS)
                + tuple((ours + ".weight", theirs + ".weight")
                        for ours, theirs in HF_LAYER_PROJS))


def _host(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.detach().to("cpu", dtype).contiguous()


# ---------------------------------------------------------------------------
# modules → HF state dicts
# ---------------------------------------------------------------------------

def llama_state_dict(model: LlamaModel, cfg: LlamaConfig,
                     dtype=torch.float32) -> StateDict:
    """A per-name dense LlamaModel → HF LlamaForCausalLM names."""
    own = model.state_dict()
    sd = {"model.embed_tokens.weight": own["embed_tokens"],
          "model.norm.weight": own["final_norm"]}
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = own["lm_head.weight"]
    L = cfg.num_hidden_layers
    for ours, theirs in _LAYER_NAMES:       # each name over the layers
        for i in range(L):
            key = f"layers.{i}.{ours}"
            if key not in own:
                raise NotImplementedError(
                    f"{key}: only a per-name dense llama is exported (not "
                    "a fused, quantized, routed or non-gated model)")
            sd[f"model.layers.{i}.{theirs}"] = own[key]
    for name, theirs in HF_LAYER_PROJS[:3]:     # q, k, v
        if f"layers.0.{name}_bias" in own:
            for i in range(L):
                sd[f"model.layers.{i}.{theirs}.bias"] = \
                    own[f"layers.{i}.{name}_bias"]
    return {k: _host(v, dtype) for k, v in sd.items()}


def vit_state_dict(vit: VisionTransformer, cfg: ViTConfig,
                   dtype=torch.float32) -> StateDict:
    """CLIPVisionModel / SiglipVisionModel names (CLIP: class embedding
    and pre-LayerNorm; SigLIP: the patch bias)."""
    own = vit.state_dict()
    D = cfg.hidden_size
    e = "vision_model.embeddings."
    sd = {e + "patch_embedding.weight": own["patch_embed.weight"],
          e + "position_embedding.weight": own["position_embedding"],
          "vision_model.post_layernorm.weight": torch.ones(D),
          "vision_model.post_layernorm.bias": torch.zeros(D)}
    if cfg.class_token:
        sd[e + "class_embedding"] = own["class_embedding"]
        sd["vision_model.pre_layrnorm.weight"] = own["pre_layernorm.weight"]
        sd["vision_model.pre_layrnorm.bias"] = own["pre_layernorm.bias"]
    if "patch_embed.bias" in own:
        sd[e + "patch_embedding.bias"] = own["patch_embed.bias"]
    for i in range(cfg.num_hidden_layers):
        p, q = f"vision_model.encoder.layers.{i}.", f"layers.{i}."
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2"),
                             ("q", "self_attn.q_proj"),
                             ("k", "self_attn.k_proj"),
                             ("v", "self_attn.v_proj"),
                             ("o", "self_attn.out_proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            for suf in ("weight", "bias"):
                sd[f"{p}{theirs}.{suf}"] = own[f"{q}{ours}.{suf}"]
    return {k: _host(v, dtype) for k, v in sd.items()}


def projector_state_dict(pj: Projector, dtype=torch.float32) -> StateDict:
    """xtuner's ProjectorModel names: model.{0, 2, ...}.{weight, bias}."""
    if len(pj.norms):
        raise NotImplementedError("a projector with LayerNorms (Yi-VL) has "
                                  "no xtuner layout")
    sd = {}
    for i, layer in enumerate(pj.layers):
        sd[f"model.{2 * i}.weight"] = layer.weight
        sd[f"model.{2 * i}.bias"] = layer.bias
    return {k: _host(v, dtype) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Config dicts
# ---------------------------------------------------------------------------

def llama_config_dict(cfg: LlamaConfig) -> Dict[str, Any]:
    d = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
         "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
         "intermediate_size": cfg.intermediate_size,
         "num_hidden_layers": cfg.num_hidden_layers,
         "num_attention_heads": cfg.num_attention_heads,
         "num_key_value_heads": cfg.num_key_value_heads,
         "max_position_embeddings": cfg.max_position_embeddings,
         "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
         "tie_word_embeddings": cfg.tie_word_embeddings,
         "hidden_act": "silu", "torch_dtype": "float16",
         "bos_token_id": 1, "eos_token_id": 2}
    if cfg.rope_linear_scaling:
        d["rope_scaling"] = {"type": "linear",
                             "factor": cfg.rope_linear_scaling}
    return d


def vit_config_dict(cfg: ViTConfig) -> Dict[str, Any]:
    """CLIPVisionConfig's fields (SiglipVisionConfig's for a SigLIP
    tower)."""
    arch = "CLIPVisionModel" if cfg.class_token else "SiglipVisionModel"
    return {"architectures": [arch],
            "model_type": f"{cfg.model_type}_vision_model",
            "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "image_size": cfg.image_size, "patch_size": cfg.patch_size,
            "layer_norm_eps": cfg.layer_norm_eps,
            "hidden_act": cfg.hidden_act,
            "projection_dim": cfg.hidden_size}


def projector_config_dict(cfg: ProjectorConfig) -> Dict[str, Any]:
    return {"model_type": "projector",
            "visual_hidden_size": cfg.visual_hidden_size,
            "llm_hidden_size": cfg.llm_hidden_size,
            "depth": cfg.depth, "hidden_act": "gelu", "bias": True}


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------

def write_safetensors(path: str, tensors: StateDict) -> int:
    """{name: tensor} → one .safetensors file (tensors in their dtype, in
    the dict's order) → bytes written."""
    tensors = {k: t.detach().cpu().contiguous() for k, t in tensors.items()}
    header, off = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _ST_CODES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())
    return 8 + len(raw) + off


def _write(sd: StateDict, cfg_dict: Dict[str, Any], out_dir: str,
           max_shard_bytes: int = 5 * 1024 ** 3) -> int:
    """Write config.json and the safetensors, split above max_shard_bytes
    into `model-0000i-of-0000n.safetensors` shards named by an HF-style
    model.safetensors.index.json (the reference's `xtuner convert split`
    folded into export) → bytes of tensor files written."""
    os.makedirs(out_dir, exist_ok=True)
    total = sum(v.numel() * v.element_size() for v in sd.values())
    written = 0
    if total <= max_shard_bytes:
        written += write_safetensors(
            os.path.join(out_dir, "model.safetensors"), sd)
    else:
        shards, cur, cur_bytes = [], {}, 0
        for k, v in sd.items():
            n = v.numel() * v.element_size()
            if cur and cur_bytes + n > max_shard_bytes:
                shards.append(cur)
                cur, cur_bytes = {}, 0
            cur[k] = v
            cur_bytes += n
        if cur:
            shards.append(cur)
        weight_map = {}
        for i, shard in enumerate(shards):
            fn = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            written += write_safetensors(os.path.join(out_dir, fn), shard)
            weight_map.update({k: fn for k in shard})
        with open(os.path.join(out_dir,
                               "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f, indent=2)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)
    return written


def export_xtuner_dir(model, out_dir: str, tokenizer=None,
                      dtype=torch.float32,
                      max_shard_bytes: int = 5 * 1024 ** 3) -> int:
    """An AuroraModel → the xtuner checkpoint layout (to_xtuner_llava
    parity) → bytes written. tokenizer: saved beside the LLM when given
    (anything with save_pretrained)."""
    cfg = model.cfg
    n = _write(llama_state_dict(model.llm, cfg.llm, dtype),
               llama_config_dict(cfg.llm), out_dir, max_shard_bytes)
    n += _write(vit_state_dict(model.visual_encoder, cfg.vit, dtype),
                vit_config_dict(cfg.vit),
                os.path.join(out_dir, "visual_encoder"), max_shard_bytes)
    n += _write(projector_state_dict(model.projector, dtype),
                projector_config_dict(cfg.projector),
                os.path.join(out_dir, "projector"), max_shard_bytes)
    if tokenizer is not None:
        tokenizer.save_pretrained(out_dir)
    return n


def _resize_vocab_mvn(embed: np.ndarray, head: np.ndarray, pad_to: int,
                      seed: int = 0):
    """Vocab rows to pad_to, each new row mean + z · chol(cov + 1e-5 I) of
    the existing rows, z ~ N(0, I) from default_rng(seed) (the reference's
    float32 numpy, the head's rows drawn after the embedding's)."""
    v, d = embed.shape
    n_new = pad_to - v
    if n_new <= 0:
        return embed, head
    rng = np.random.default_rng(seed)

    def sample(mat):
        mu = mat.mean(axis=0)
        centered = mat - mu
        cov = centered.T @ centered / mat.shape[0]
        L = np.linalg.cholesky(cov + 1e-5 * np.eye(d, dtype=mat.dtype))
        z = rng.standard_normal((n_new, d)).astype(mat.dtype)
        return np.concatenate([mat, mu + z @ L.T], axis=0)

    return sample(embed), sample(head)


def export_hf_llava(model, out_dir: str, pad_vocab_multiple: int = 64,
                    dtype=torch.float32) -> int:
    """An AuroraModel → LlavaForConditionalGeneration's layout
    (to_huggingface_llava parity), the vocabulary padded to a multiple of
    pad_vocab_multiple (`_resize_vocab_mvn`, in float32, then cast to
    dtype) → bytes written."""
    cfg = model.cfg
    llm_sd = llama_state_dict(model.llm, cfg.llm, dtype)
    pad_to = -(-cfg.llm.vocab_size // pad_vocab_multiple) * \
        pad_vocab_multiple
    emb = llm_sd["model.embed_tokens.weight"]
    head = llm_sd.get("lm_head.weight", emb)
    if pad_to > cfg.llm.vocab_size:
        # the head in the reference's memory order, the transpose of a
        # [D, V] kernel, so that the float32 sums of its sampled rows match
        h = head.float().numpy()
        if "lm_head.weight" in llm_sd:
            h = np.ascontiguousarray(h.T).T
        e, h = _resize_vocab_mvn(emb.float().numpy(), h, pad_to)
        emb, head = (torch.from_numpy(x).to(emb.dtype) for x in (e, h))
    llm_sd["model.embed_tokens.weight"] = emb
    llm_sd["lm_head.weight"] = head
    sd: StateDict = {}
    for k, v in llm_sd.items():
        sd[("language_model.model." + k[len("model."):])
           if k.startswith("model.") else "language_model." + k] = v
    for k, v in vit_state_dict(model.visual_encoder, cfg.vit, dtype).items():
        sd["vision_tower." + k] = v
    pj_sd = projector_state_dict(model.projector, dtype)
    for i in range(cfg.projector.depth):
        for suf in ("weight", "bias"):
            sd[f"multi_modal_projector.linear_{i + 1}.{suf}"] = \
                pj_sd[f"model.{2 * i}.{suf}"]
    cfg_dict = {
        "architectures": ["LlavaForConditionalGeneration"],
        "model_type": "llava",
        "text_config": llama_config_dict(cfg.llm) | {"vocab_size": pad_to},
        "vision_config": vit_config_dict(cfg.vit),
        "vision_feature_layer": -2,
        "vision_feature_select_strategy": "default",
        "image_token_index": 32000,
    }
    return _write(sd, cfg_dict, out_dir)


def export_official_llava(model, out_dir: str,
                          visual_select_layer: Optional[int] = None,
                          dtype=torch.float32) -> int:
    """An AuroraModel → the LLaVA repository's layout (to_official_llava
    parity): llama keys at the root, the tower under
    model.vision_tower.vision_tower.*, the projector as
    model.mm_projector.{0,2}.*, LlavaConfig's fields on the llama config
    (mm_vision_select_layer: visual_select_layer, by default the model
    config's) → bytes written."""
    cfg = model.cfg
    if visual_select_layer is None:
        visual_select_layer = cfg.visual_select_layer
    sd = llama_state_dict(model.llm, cfg.llm, dtype)
    for k, v in vit_state_dict(model.visual_encoder, cfg.vit, dtype).items():
        sd["model.vision_tower.vision_tower." + k] = v
    for k, v in projector_state_dict(model.projector, dtype).items():
        sd["model.mm_projector." + k[len("model."):]] = v
    cfg_dict = llama_config_dict(cfg.llm)
    cfg_dict.update({
        "model_type": "llava",
        "architectures": ["LlavaLlamaForCausalLM"],
        "image_aspect_ratio": "pad",
        "mm_hidden_size": cfg.vit.hidden_size,
        "mm_projector_type": f"mlp{cfg.projector.depth}x_gelu",
        "mm_use_im_patch_token": False,
        "mm_use_im_start_end": False,
        "mm_vision_select_feature": "patch",
        "mm_vision_select_layer": visual_select_layer,
        "unfreeze_mm_vision_tower": True,
        "use_cache": True,
        "use_mm_proj": True,
    })
    return _write(sd, cfg_dict, out_dir)


EXPORTERS = {"xtuner": export_xtuner_dir, "huggingface": export_hf_llava,
             "official": export_official_llava}
