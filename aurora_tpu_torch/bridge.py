"""Weight and config bridge from the JAX package's trees to the port.

The JAX package keeps parameters as nested dicts of arrays: dense kernels
[in, out], LLM layers stacked [L, ...], the ViT patch embedding as an
unfold kernel [p·p·C, D]. The functions here take such a tree with numpy
leaves (e.g. `jax.device_get(params)`) and return the port's modules:
transposed into `nn.Linear` weights [out, in], the LLM layers unstacked,
the patch kernel reshaped into a conv weight [D, C, p, p]. Configs cross
by field name from any object with the same attributes; reference
settings the port does not carry raise NotImplementedError. The modules
are built on the card unless the caller passes a device (the CPU tests
pass device="cpu").

The reference's W4 trees (quantize_weights_int4, optionally
fuse_serving_weights and w4_decode_layout_params) cross with their bytes
and scales unchanged: flat [L, G, g/2, O] or tile-contiguous
[L, Nb, Kb, bk, bn] packed stacks with their `<name>_scale4`, per-name or
fused qkv/gateup, the fused-MLP tiles `mlp_gu/mlp_gs/mlp_dw/mlp_ds`
(AURORA_W4_FUSED_MLP=1, untiled back into gateup/down), and the int8
`lm_head` with its `lm_head_scale`. They become W4Linear/W8Linear modules
in the port's layout. So do its W8 trees
(quantize_weights_int8, optionally fused): int8 `<name>` stacks [L, in,
out] with `<name>_scale` [L, 1, out], and the int8 head.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from aurora_tpu_torch.models.aurora import AuroraConfig, AuroraModel
from aurora_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                           projection_shapes)
from aurora_tpu_torch.models.projector import Projector, ProjectorConfig
from aurora_tpu_torch.models.vit import ViTConfig, VisionTransformer
from aurora_tpu_torch.ops.pallas.quant_matmul import (
    w4_from_flat, w4_mlp_untile_reference)

# reference LlamaConfig knobs of other families, with the value at which
# they are off; the port's decoder is the llama case with Mistral's
# sliding window and the attention logit softcap (LlamaConfig's fields)
_LLAMA_FAMILY_OFF = {
    "qkv_bias": False, "qk_norm": False, "norm_type": "rmsnorm",
    "partial_rotary_factor": 1.0, "rope_interleaved": False,
    "clip_qkv": None, "mlp_style": "gated",
    "num_experts": 0, "head_dim_override": None,
    "final_logit_softcap": 0.0,
    "scale_embeddings": False, "hidden_act": "silu",
    "query_pre_attn_scalar": None, "swa_every_other": False,
    "norm_upcast_mul": False, "mla_kv_lora_rank": None,
    "parallel_block": False, "logit_scale": None, "learned_pos": False,
    "embed_scale": None, "residual_scale": None, "first_k_dense": 0,
    "rope_inv_freq": None,
}


def _config_from(ref, cls):
    return cls(**{f.name: getattr(ref, f.name)
                  for f in dataclasses.fields(cls) if hasattr(ref, f.name)})


def llama_config_from(ref) -> LlamaConfig:
    for name, off in _LLAMA_FAMILY_OFF.items():
        val = getattr(ref, name, off)
        if name == "head_dim_override" and val == (
                ref.hidden_size // ref.num_attention_heads):
            continue    # HF configs name the llama head_dim explicitly
        if val != off:
            raise NotImplementedError(
                f"{name}={val!r}: the port serves the llama family only "
                "(MLA, MoE, Gemma2, Qwen, ... are not ported yet)")
    return _config_from(ref, LlamaConfig)


def aurora_config_from(ref) -> AuroraConfig:
    return AuroraConfig(vit=_config_from(ref.vit, ViTConfig),
                        llm=llama_config_from(ref.llm),
                        projector=_config_from(ref.projector,
                                               ProjectorConfig),
                        visual_select_layer=ref.visual_select_layer,
                        slowfast=ref.slowfast)


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def _linear(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["kernel"]).T
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _ln(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _load(module, sd, device):
    """Fill a module built on the meta device, on `device` (default the
    card); each tensor is converted to the dtype the module declares (int8
    and fp32-scale buffers keep theirs)."""
    module = module.to_empty(device=device or "cuda")
    module.load_state_dict(sd, strict=True)
    return module


def vit_state_dict(tree: Dict[str, Any], cfg: ViTConfig):
    emb = tree["embeddings"]
    ps, C, D = cfg.patch_size, cfg.num_channels, cfg.hidden_size
    sd = {
        # unfold rows are (c, i, j) channel-major → conv weight [D, C, p, p]
        "patch_embed.weight": _t(emb["patch_kernel"]).T.reshape(D, C, ps,
                                                                 ps),
        "class_embedding": _t(emb["class_embedding"]),
        "position_embedding": _t(emb["position_embedding"]),
    }
    _ln(sd, "pre_layernorm", tree["pre_layernorm"])
    for i, lp in enumerate(tree["layers"]):
        pre = f"layers.{i}."
        _ln(sd, pre + "ln1", lp["ln1"])
        _ln(sd, pre + "ln2", lp["ln2"])
        for name in ("q", "k", "v", "o"):
            _linear(sd, pre + name, lp["attn"][name])
        for name in ("fc1", "fc2"):
            _linear(sd, pre + name, lp["mlp"][name])
    return sd


def projector_state_dict(tree: Dict[str, Any]):
    sd = {}
    for i, lp in enumerate(tree["layers"]):
        if "ln_scale" in lp:
            raise NotImplementedError("projector LayerNorms (Yi-VL) are "
                                      "not ported")
        _linear(sd, f"layers.{i}", lp)
    return sd


def _w4_layer(pk, s_w):
    """One layer of a reference W4 stack → the port's (packed, scale).
    The tile-contiguous layout [Nb, Kb, bk, bn] + [Nb, Gb, gk, bn] is
    undone first, as the reference's w4_untile_layout does."""
    pk, s_w = np.asarray(pk), np.asarray(s_w)
    if pk.ndim == 4:
        Nb, Kb, bk, bn = pk.shape
        gh = bk // s_w.shape[2]
        G, N = Kb * bk // gh, Nb * bn
        pk = pk.transpose(1, 2, 0, 3).reshape(G, gh, N)
        s_w = s_w.transpose(1, 2, 0, 3).reshape(G, 1, N)
    return w4_from_flat(pk, s_w)


def llama_layout(tree: Dict[str, Any]):
    """(weight_quant, fused) of a reference llama tree."""
    layers = tree["layers"]
    if any(k.endswith("_scale4") for k in layers):
        quant = "int4"
    elif any(k.endswith("_scale") for k in layers):
        quant = "int8"
    else:
        quant = "none"
    return quant, "qkv" in layers


def llama_state_dict(tree: Dict[str, Any], cfg: LlamaConfig):
    layers = tree["layers"]
    quant, fused = llama_layout(tree)
    sd = {"embed_tokens": _t(tree["embed_tokens"]),
          "final_norm": _t(tree["final_norm"]),
          "lm_head.weight": _t(tree["lm_head"]).T}
    if quant != "none":
        sd["lm_head.scale"] = _t(tree["lm_head_scale"]).reshape(-1)
    for l in range(cfg.num_hidden_layers):
        pre = f"layers.{l}."
        sd[pre + "input_norm"] = _t(layers["input_norm"][l])
        sd[pre + "post_attn_norm"] = _t(layers["post_attn_norm"][l])
        mlp = {}
        if "mlp_gu" in layers:      # AURORA_W4_FUSED_MLP=1 tiles
            tiles = (torch.from_numpy(np.array(layers[k][l]))
                     for k in ("mlp_gu", "mlp_gs", "mlp_dw", "mlp_ds"))
            gu_pk, gu_s, dn_pk, dn_s = (
                t.numpy() for t in w4_mlp_untile_reference(*tiles))
            mlp = {"gateup": w4_from_flat(gu_pk, gu_s),
                   "down": w4_from_flat(dn_pk, dn_s)}
        for name in projection_shapes(cfg, fused):
            if name in mlp:
                sd[pre + name + ".packed"], sd[pre + name + ".scale"] = \
                    mlp[name]
            elif quant == "int4":
                sd[pre + name + ".packed"], sd[pre + name + ".scale"] = \
                    _w4_layer(layers[name][l], layers[name + "_scale4"][l])
            elif quant == "int8":
                sd[pre + name + ".weight"] = _t(layers[name][l]).T
                sd[pre + name + ".scale"] = _t(
                    layers[name + "_scale"][l]).reshape(-1)
            else:
                sd[pre + name + ".weight"] = _t(layers[name][l]).T
    return sd


def vit_from_params(tree, cfg: ViTConfig, device=None, dtype=None):
    return _load(VisionTransformer(cfg, device="meta", dtype=dtype),
                 vit_state_dict(tree, cfg), device)


def projector_from_params(tree, cfg: ProjectorConfig, device=None,
                          dtype=None):
    return _load(Projector(cfg, device="meta", dtype=dtype),
                 projector_state_dict(tree), device)


def llama_from_params(tree, cfg: LlamaConfig, device=None, dtype=None):
    """Dense, W4 (flat, tiled or fused-MLP) or W8 reference trees,
    per-name or fused; dtype applies to the dense weights, embeddings and
    norms."""
    quant, fused = llama_layout(tree)
    return _load(LlamaModel(cfg, device="meta", dtype=dtype,
                            weight_quant=quant, fused=fused),
                 llama_state_dict(tree, cfg), device)


def aurora_state_dict(tree, cfg: AuroraConfig) -> Dict[str, torch.Tensor]:
    """The composite {"visual_encoder", "projector", "llm"} tree as the
    port's AuroraModel state dict (e.g. to compare a JAX train step's
    updated params with the port's model)."""
    sd = {}
    for prefix, part in (
            ("visual_encoder.",
             vit_state_dict(tree["visual_encoder"], cfg.vit)),
            ("projector.", projector_state_dict(tree["projector"])),
            ("llm.", llama_state_dict(tree["llm"], cfg.llm))):
        sd.update({prefix + k: v for k, v in part.items()})
    return sd


def aurora_from_params(tree, cfg: AuroraConfig, device=None, dtype=None):
    """The composite {"visual_encoder", "projector", "llm"} tree."""
    return _load(AuroraModel(cfg, device="meta", dtype=dtype),
                 aurora_state_dict(tree, cfg), device)
