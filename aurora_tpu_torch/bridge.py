"""Weight and config bridge from the JAX package's trees to the port.

The JAX package keeps parameters as nested dicts of arrays: dense kernels
[in, out], LLM layers stacked [L, ...], the ViT patch embedding as an
unfold kernel [p·p·C, D]. The functions here take such a tree with numpy
leaves (e.g. `jax.device_get(params)`) and return the port's modules:
transposed into `nn.Linear` weights [out, in], the LLM layers unstacked,
the patch kernel reshaped into a conv weight [D, C, p, p]. Configs cross
by field name from any object with the same attributes (every knob of
the reference's LlamaConfig: the dense families', the MoE and MLA ones
and YaRN's frequencies). A dense family's extra parameters (biases, q/k
norms, norm biases, Gemma-2's output norms, `wpe`) cross by their
reference names, and a tied tree has no `lm_head`. A MoE tree's router
`moe_router` [L, D, E], expert stacks `moe_gate`/`moe_up` [L, E, D, F]
and `moe_down` [L, E, F, D] (int8 with `<name>_scale` [L, E, 1, F] in
the W8 and W4 trees), shared expert `moe_shared_*` [L, in, out] and
scalar gate `moe_shared_gate_w` cross into the MoE layers (ops/moe.py
ExpertStack), and DeepSeek v1's unstacked `dense_layers` into the first
layers of the port's one stack. DeepSeek-V2's per-layer tree
(models/deepseek_v2.py) crosses with `deepseek_v2_from_params`. The
modules are built on the card unless the caller passes a device (the
CPU tests pass device="cpu"). The ViT tree may be CLIP's (class
embedding, pre-LayerNorm) or SigLIP's (patch bias), the projector's
layers may carry Yi-VL's LayerNorms (`ln_scale`, `ln_bias`), and an
InternVL tree ({"vision", "projector", "text"}) crosses with
`internvl_from_params`.

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
from aurora_tpu_torch.models.llama import (LAYER_EXTRAS, TOP_EXTRAS,
                                           LlamaConfig, LlamaModel,
                                           projection_shapes)
from aurora_tpu_torch.models.projector import Projector, ProjectorConfig
from aurora_tpu_torch.models.vit import ViTConfig, VisionTransformer
from aurora_tpu_torch.ops.pallas.quant_matmul import (
    w4_from_flat, w4_mlp_untile_reference)

def _config_from(ref, cls):
    return cls(**{f.name: getattr(ref, f.name)
                  for f in dataclasses.fields(cls) if hasattr(ref, f.name)})


def llama_config_from(ref) -> LlamaConfig:
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
    """A CLIP tree (class_embedding, pre_layernorm) or a SigLIP one
    (patch_bias, neither of those)."""
    emb = tree["embeddings"]
    ps, C, D = cfg.patch_size, cfg.num_channels, cfg.hidden_size
    sd = {
        # unfold rows are (c, i, j) channel-major → conv weight [D, C, p, p]
        "patch_embed.weight": _t(emb["patch_kernel"]).T.reshape(D, C, ps,
                                                                 ps),
        "position_embedding": _t(emb["position_embedding"]),
    }
    if not cfg.class_token:
        sd["patch_embed.bias"] = _t(emb["patch_bias"])
    else:
        sd["class_embedding"] = _t(emb["class_embedding"])
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
    """Layers {kernel, bias} and, after a linear, Yi-VL's LayerNorm
    {ln_scale, ln_bias} where the layer carries it."""
    sd = {}
    for i, lp in enumerate(tree["layers"]):
        _linear(sd, f"layers.{i}", lp)
        if "ln_scale" in lp:
            sd[f"norms.ln{i}.weight"] = _t(lp["ln_scale"])
            sd[f"norms.ln{i}.bias"] = _t(lp["ln_bias"])
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


def llama_extras(tree: Dict[str, Any]):
    """The family parameters (models/llama.py LAYER_EXTRAS, TOP_EXTRAS) a
    reference llama tree holds."""
    return tuple(n for n in LAYER_EXTRAS if n in tree["layers"]) + tuple(
        n for n in TOP_EXTRAS if n in tree)


def llama_moe_layout(tree: Dict[str, Any]) -> Dict[str, int]:
    """LlamaModel's MoE widths (models/llama.py `moe_layout`) of a
    reference llama tree; {} for a dense one."""
    layers = tree["layers"]
    if "moe_gate" not in layers:
        return {}
    shared = layers.get("moe_shared_gate")
    return {"moe_inter": np.shape(layers["moe_gate"])[-1],
            "shared_inter": 0 if shared is None else np.shape(shared)[-1],
            "shared_gate": "moe_shared_gate_w" in layers}


_MOE_STACKS = ("moe_gate", "moe_up", "moe_down", "moe_shared_gate",
               "moe_shared_up", "moe_shared_down")


def _moe_layer(sd, pre, lp):
    """One MoE layer of a reference tree (lp: name → that layer's array)
    into sd: the router and scalar gate as they are, each expert stack
    [E, in, out] (a shared expert's [in, out] as one expert) with its int8
    scales [E, out]."""
    sd[pre + "moe_router"] = _t(lp["moe_router"])
    if "moe_shared_gate_w" in lp:
        sd[pre + "moe_shared_gate_w"] = _t(lp["moe_shared_gate_w"])
    for name in _MOE_STACKS:
        if name not in lp:
            continue
        w = _t(lp[name])
        if w.dim() == 2:            # the shared expert: one expert
            w = w[None]
        sd[pre + name + ".weight"] = w
        if name + "_scale" in lp:
            sd[pre + name + ".scale"] = _t(lp[name + "_scale"]).reshape(
                w.shape[0], w.shape[2])


def llama_state_dict(tree: Dict[str, Any], cfg: LlamaConfig):
    quant, fused = llama_layout(tree)
    first_k = len(tree.get("dense_layers", ()))
    sd = {"embed_tokens": _t(tree["embed_tokens"]),
          "final_norm": _t(tree["final_norm"])}
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = _t(tree["lm_head"]).T
        if quant != "none":
            sd["lm_head.scale"] = _t(tree["lm_head_scale"]).reshape(-1)
    if "score" in tree:         # the classification head, [D, num_labels]
        sd["score.weight"] = _t(tree["score"]).T
    extras = llama_extras(tree)
    for name in extras:
        if name in TOP_EXTRAS:
            sd[name] = _t(tree[name])
    for l in range(cfg.num_hidden_layers):
        pre = f"layers.{l}."
        if l < first_k:             # DeepSeek v1's dense prefix: float,
            dl = tree["dense_layers"][l]    # per-name, unstacked
            for name in ("input_norm", "post_attn_norm"):
                sd[pre + name] = _t(dl[name])
            for name in projection_shapes(cfg, False):
                sd[pre + name + ".weight"] = _t(dl[name]).T
            continue
        layers = {k: v[l - first_k] for k, v in tree["layers"].items()}
        sd[pre + "input_norm"] = _t(layers["input_norm"])
        if not cfg.parallel_block:
            sd[pre + "post_attn_norm"] = _t(layers["post_attn_norm"])
        for name in extras:
            if name in LAYER_EXTRAS:
                sd[pre + name] = _t(layers[name])
        moe = "moe_router" in layers
        if moe:
            _moe_layer(sd, pre, layers)
        mlp = {}
        if "mlp_gu" in layers:      # AURORA_W4_FUSED_MLP=1 tiles
            tiles = (torch.from_numpy(np.array(layers[k]))
                     for k in ("mlp_gu", "mlp_gs", "mlp_dw", "mlp_ds"))
            gu_pk, gu_s, dn_pk, dn_s = (
                t.numpy() for t in w4_mlp_untile_reference(*tiles))
            mlp = {"gateup": w4_from_flat(gu_pk, gu_s),
                   "down": w4_from_flat(dn_pk, dn_s)}
        for name in projection_shapes(cfg, fused, moe):
            if name in mlp:
                sd[pre + name + ".packed"], sd[pre + name + ".scale"] = \
                    mlp[name]
            elif quant == "int4":
                sd[pre + name + ".packed"], sd[pre + name + ".scale"] = \
                    _w4_layer(layers[name], layers[name + "_scale4"])
            elif quant == "int8":
                sd[pre + name + ".weight"] = _t(layers[name]).T
                sd[pre + name + ".scale"] = _t(
                    layers[name + "_scale"]).reshape(-1)
            else:
                sd[pre + name + ".weight"] = _t(layers[name]).T
    return sd


def vit_from_params(tree, cfg: ViTConfig, device=None, dtype=None):
    return _load(VisionTransformer(cfg, device="meta", dtype=dtype),
                 vit_state_dict(tree, cfg), device)


def projector_from_params(tree, cfg: ProjectorConfig, device=None,
                          dtype=None):
    norms = [i for i, lp in enumerate(tree["layers"]) if "ln_scale" in lp]
    return _load(Projector(cfg, device="meta", dtype=dtype,
                           norm_layers=norms),
                 projector_state_dict(tree), device)


def llama_from_params(tree, cfg: LlamaConfig, device=None, dtype=None):
    """Dense, W4 (flat, tiled or fused-MLP) or W8 reference trees,
    per-name or fused, with the classification head `score` where the tree
    has one, MoE trees (with DeepSeek v1's dense prefix); dtype applies to
    the float weights, embeddings and norms."""
    quant, fused = llama_layout(tree)
    num_labels = np.shape(tree["score"])[1] if "score" in tree else 0
    return _load(LlamaModel(cfg, device="meta", dtype=dtype,
                            weight_quant=quant, fused=fused,
                            num_labels=num_labels,
                            extras=llama_extras(tree),
                            **llama_moe_layout(tree)),
                 llama_state_dict(tree, cfg), device)


def gemma2_state_dict(tree: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """A reference Gemma-2 tree (models/gemma2.py: stacked [L, in, out]
    kernels, the HF norm weights, per-layer `sliding` flags, which the
    port derives from the layer index) → Gemma2Model's state dict."""
    layers = tree["layers"]
    sd = {"embed_tokens": _t(tree["embed_tokens"]),
          "final_norm": _t(tree["final_norm"])}
    for l in range(cfg.num_hidden_layers):
        for name in ("input_norm", "post_attn_norm", "pre_ffw_norm",
                     "post_ffw_norm"):
            sd[f"layers.{l}.{name}"] = _t(layers[name][l])
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            sd[f"layers.{l}.{name}.weight"] = _t(layers[name][l]).T
    return sd


def gemma2_from_params(tree, cfg, device=None, dtype=None):
    from aurora_tpu_torch.models.gemma2 import Gemma2Model
    return _load(Gemma2Model(cfg, device="meta", dtype=dtype),
                 gemma2_state_dict(tree, cfg), device)


def deepseek_v2_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference DeepSeek-V2 tree (models/deepseek_v2.py: a per-layer
    list of [in, out] kernels, `gate_weight` [E, D], `experts` a list of
    per-expert MLPs, `shared` and dense `mlp` dicts) → DeepseekV2Model's
    state dict."""
    sd = {"embed_tokens": _t(tree["embed_tokens"]),
          "final_norm": _t(tree["final_norm"]),
          "lm_head.weight": _t(tree["lm_head"]).T}
    for i, lp in enumerate(tree["layers"]):
        pre = f"layers.{i}."
        for name in ("input_norm", "post_attn_norm", "kv_a_norm",
                     "q_a_norm"):
            if name in lp:
                sd[pre + name] = _t(lp[name])
        for name in ("q", "q_a", "q_b", "kv_a", "kv_b", "o"):
            if name in lp:
                sd[pre + name + ".weight"] = _t(lp[name]).T
        if "mlp" in lp:
            for name in ("gate", "up", "down"):
                sd[pre + name + ".weight"] = _t(lp["mlp"][name]).T
            continue
        sd[pre + "moe_gate_w"] = _t(lp["gate_weight"])
        for name in ("gate", "up", "down"):
            sd[pre + "moe_" + name + ".weight"] = torch.stack(
                [_t(ep[name]) for ep in lp["experts"]])
            sd[pre + "shared_" + name + ".weight"] = _t(lp["shared"][name]).T
    return sd


def deepseek_v2_from_params(tree, cfg, device=None, dtype=None):
    """A reference DeepSeek-V2 tree → DeepseekV2Model (cfg: the port's
    DeepseekV2Config, e.g. `DeepseekV2Config(**asdict(reference_cfg))`)."""
    from aurora_tpu_torch.models.deepseek_v2 import DeepseekV2Model
    return _load(DeepseekV2Model(cfg, device="meta", dtype=dtype),
                 deepseek_v2_state_dict(tree), device)


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


def internvl_config_from(ref):
    """The reference's InternVLConfig → the port's."""
    from aurora_tpu_torch.models.internvl import (InternViTConfig,
                                                  InternVLConfig)
    return InternVLConfig(vision=_config_from(ref.vision, InternViTConfig),
                          text=llama_config_from(ref.text),
                          downsample_ratio=ref.downsample_ratio,
                          projector_hidden_act=ref.projector_hidden_act)


def internvl_state_dict(tree, cfg) -> Dict[str, torch.Tensor]:
    """The reference's InternVL tree (models/internvl.py: {"vision",
    "projector", "text"}, kernels [in, out], the patch convolution OIHW)
    → InternVLModel's vision and projector entries."""
    v, pj = tree["vision"], tree["projector"]
    sd = {"vision.patch_embed.weight": _t(v["patch_embed"]),
          "vision.patch_embed.bias": _t(v["patch_bias"]),
          "vision.cls_token": _t(v["cls_token"]).reshape(-1)}
    if "pos_embed" in v:
        sd["vision.pos_embed"] = _t(v["pos_embed"])
    if "final_norm_w" in v:
        sd["vision.final_norm.weight"] = _t(v["final_norm_w"])
        sd["vision.final_norm.bias"] = _t(v["final_norm_b"])
    plain = {"norm1_w": "norm1.weight", "norm1_b": "norm1.bias",
             "norm2_w": "norm2.weight", "norm2_b": "norm2.bias",
             "q_bias": "q.bias", "k_bias": "k.bias", "v_bias": "v.bias",
             "q_norm": "q_norm", "k_norm": "k_norm", "proj_b": "proj.bias",
             "fc1_b": "fc1.bias", "fc2_b": "fc2.bias", "lambda1": "lambda1",
             "lambda2": "lambda2"}
    for i, lp in enumerate(v["layers"]):
        pre = f"vision.layers.{i}."
        for theirs, x in lp.items():
            if theirs in plain:
                sd[pre + plain[theirs]] = _t(x)
            else:           # the kernels q, k, v, proj, fc1, fc2
                sd[pre + theirs + ".weight"] = _t(x).T
    for ours, theirs in (("norm.weight", "ln_w"), ("norm.bias", "ln_b"),
                         ("fc1.bias", "fc1_b"), ("fc2.bias", "fc2_b")):
        sd["projector." + ours] = _t(pj[theirs])
    for name in ("fc1", "fc2"):
        sd[f"projector.{name}.weight"] = _t(pj[name]).T
    return sd


def internvl_from_params(tree, cfg, device=None, dtype=None):
    """The reference's InternVL tree (numpy leaves) → InternVLModel; cfg:
    the port's InternVLConfig (`internvl_config_from`)."""
    from aurora_tpu_torch.models.internvl import (InternViT,
                                                  InternVLModel,
                                                  InternVLProjector)
    sd = internvl_state_dict(tree, cfg)

    def part(prefix):
        return {k[len(prefix):]: x for k, x in sd.items()
                if k.startswith(prefix)}

    return InternVLModel(
        cfg,
        _load(InternViT(cfg.vision, device="meta", dtype=dtype),
              part("vision."), device),
        _load(InternVLProjector(cfg, device="meta", dtype=dtype),
              part("projector."), device),
        llama_from_params(tree["text"], cfg.text, device, dtype))


def lora_adapters_from(adapters, device=None, dtype=None):
    """The reference's LoRA adapters ({"llm/layers/q": {"a": [L, in, r],
    "b": [L, r, out]}}, train/lora.py's stacked factors, numpy leaves) →
    the port's, one entry per layer ({"llm.layers.<l>.q": {"a": [in, r],
    "b": [r, out]}}), leaf tensors that require grad, on the card unless
    `device` says otherwise; dtype default: the arrays'."""
    out = {}
    for path, ab in adapters.items():
        parts = path.split("/")
        at = parts.index("layers") + 1
        a, b = np.asarray(ab["a"]), np.asarray(ab["b"])
        for l in range(a.shape[0]):
            name = ".".join(parts[:at] + [str(l)] + parts[at:])
            out[name] = {k: torch.tensor(v[l], device=device or "cuda",
                                         dtype=dtype).requires_grad_()
                         for k, v in (("a", a), ("b", b))}
    return out
