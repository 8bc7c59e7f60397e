"""InternVL: the InternViT vision encoder, the pixel-shuffle projector and
a decoder of the dense zoo (aurora_tpu/models/internvl.py).

InternViT is a BEiT-style ViT: a CLS token and absolute position
embeddings added after the patch convolution, layer_norm or rms_norm
blocks, an optional q/k RMSNorm over the full width before the head
split, q/k/v biases where the checkpoint has them, LayerScale vectors
(lambda1, lambda2) on both residual branches, exact GELU, and mean
pooling (no final LayerNorm) by default. Its attention runs in plain
torch: SDPA held to `REPEATABLE_SDPA`, as the CLIP tower's is.

`internvl_image_features` drops the CLS row, lays the patches out as a
square, pixel-shuffles it (downsample_ratio 0.5: 4× fewer tokens, 4×
wider) and projects it (LayerNorm, linear, GELU, linear) into the
decoder's width: `n_visual_tokens` tokens an image. `internvl_forward`
splices them over the prompt's image markers (models/aurora.py
`fuse_multimodal`) and runs the decoder (models/llama.py `llama_apply`).
The converters read InternVLForConditionalGeneration's key layout
(`model.vision_tower.`, `model.multi_modal_projector.`,
`model.language_model.`, `lm_head.`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from aurora_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                           llama_apply, llama_lm_loss)
from aurora_tpu_torch.ops.attention import mha_reference, repeatable_sdpa
from aurora_tpu_torch.ops.norms import rms_norm

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class InternViTConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    use_qk_norm: bool = False
    attention_bias: bool = False
    norm_type: str = "layer_norm"           # "layer_norm" | "rms_norm"
    layer_scale_init_value: float = 0.1
    use_absolute_position_embeddings: bool = True
    use_mean_pooling: bool = True           # True → no final LayerNorm

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class InternVLConfig:
    vision: InternViTConfig = dataclasses.field(
        default_factory=InternViTConfig)
    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    downsample_ratio: float = 0.5
    projector_hidden_act: str = "gelu"

    @property
    def n_visual_tokens(self) -> int:
        side = self.vision.image_size // self.vision.patch_size
        return int((side * self.downsample_ratio) ** 2)

    @property
    def projector_in(self) -> int:
        return int(self.vision.hidden_size / self.downsample_ratio ** 2)


class Norm(nn.Module):
    """InternViT's norm: LayerNorm (weight, bias; the affine in fp32, as
    the reference does) or RMSNorm (weight)."""

    def __init__(self, d: int, eps: float, kind: str, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.kind, self.eps = kind, eps
        self.weight = nn.Parameter(torch.ones(d, **kw))
        if kind == "layer_norm":
            self.bias = nn.Parameter(torch.zeros(d, **kw))
        elif kind != "rms_norm":
            raise ValueError(f"unknown norm_type {kind!r}")

    def forward(self, x):
        if self.kind == "rms_norm":
            return rms_norm(x, self.weight, self.eps)
        xf = x.to(torch.float32)
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).pow(2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + self.eps)
        return (out * self.weight + self.bias).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU in fp32, cast back."""
    return F.gelu(x.to(torch.float32)).to(x.dtype)


class InternViTLayer(nn.Module):
    def __init__(self, cfg: InternViTConfig, device=None, dtype=None):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.norm1 = Norm(d, cfg.layer_norm_eps, cfg.norm_type, **kw)
        self.norm2 = Norm(d, cfg.layer_norm_eps, cfg.norm_type, **kw)
        self.q = nn.Linear(d, d, bias=cfg.attention_bias, **kw)
        self.k = nn.Linear(d, d, bias=cfg.attention_bias, **kw)
        self.v = nn.Linear(d, d, bias=cfg.attention_bias, **kw)
        if cfg.use_qk_norm:
            self.q_norm = nn.Parameter(torch.ones(d, **kw))
            self.k_norm = nn.Parameter(torch.ones(d, **kw))
        self.proj = nn.Linear(d, d, **kw)
        self.fc1 = nn.Linear(d, i, **kw)
        self.fc2 = nn.Linear(i, d, **kw)
        self.lambda1 = nn.Parameter(torch.ones(d, **kw))
        self.lambda2 = nn.Parameter(torch.ones(d, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T, D = x.shape
        H = cfg.num_attention_heads
        hd = D // H
        h = self.norm1(x)
        q, k, v = self.q(h), self.k(h), self.v(h)
        if cfg.use_qk_norm:     # the full width, before the head split
            q = rms_norm(q, self.q_norm, cfg.layer_norm_eps)
            k = rms_norm(k, self.k_norm, cfg.layer_norm_eps)
        with repeatable_sdpa():
            attn = mha_reference(q.view(B, T, H, hd), k.view(B, T, H, hd),
                                 v.view(B, T, H, hd), scale=hd ** -0.5)
        x = x + self.lambda1 * self.proj(attn.reshape(B, T, D))
        h = self.fc2(_gelu(self.fc1(self.norm2(x))))
        return x + self.lambda2 * h


class InternViT(nn.Module):
    """InternViT's parameters; the forward is `internvit_encode`."""

    def __init__(self, cfg: InternViTConfig, device=None, dtype=None):
        super().__init__()
        d, ps = cfg.hidden_size, cfg.patch_size
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.patch_embed = nn.Conv2d(3, d, ps, stride=ps, **kw)
        self.cls_token = nn.Parameter(torch.zeros(d, **kw))
        if cfg.use_absolute_position_embeddings:
            self.pos_embed = nn.Parameter(
                torch.zeros(cfg.num_patches + 1, d, **kw))
        self.layers = nn.ModuleList(
            InternViTLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        if not cfg.use_mean_pooling:
            self.final_norm = Norm(d, cfg.layer_norm_eps, "layer_norm", **kw)


def internvit_encode(vit: InternViT, pixel_values: torch.Tensor
                     ) -> torch.Tensor:
    """pixel_values [B, C, H, W] → the last hidden state [B, 1 + N, D]."""
    cfg = vit.cfg
    B = pixel_values.shape[0]
    x = vit.patch_embed(pixel_values.to(vit.patch_embed.weight.dtype))
    x = x.flatten(2).transpose(1, 2)                        # [B, N, D]
    x = torch.cat([vit.cls_token.to(x.dtype).expand(B, 1, -1), x], dim=1)
    if cfg.use_absolute_position_embeddings:
        x = x + vit.pos_embed
    for layer in vit.layers:
        x = layer(x)
    if not cfg.use_mean_pooling:
        x = vit.final_norm(x)
    return x


def pixel_shuffle(x: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
    """[B, W, H, C] → [B, W·s, H·s, C/s²] (modeling_internvl's
    pixel_shuffle, permute for permute)."""
    B, W, H, C = x.shape
    x = x.reshape(B, W, int(H * scale), int(C / scale))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(B, int(H * scale), int(W * scale), int(C / scale ** 2))
    return x.permute(0, 2, 1, 3)


class InternVLProjector(nn.Module):
    """LayerNorm (eps 1e-5) over the shuffled width, linear, GELU,
    linear into the decoder's width."""

    def __init__(self, cfg: InternVLConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d_in, d = cfg.projector_in, cfg.text.hidden_size
        self.norm = Norm(d_in, 1e-5, "layer_norm", **kw)
        self.fc1 = nn.Linear(d_in, d, **kw)
        self.fc2 = nn.Linear(d, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_gelu(self.fc1(self.norm(x))))


class InternVLModel(nn.Module):
    """{vision, projector, text}, each built and loaded by a converter: the
    text part is the dense zoo's LlamaModel, which the serving engine
    serves as it is."""

    def __init__(self, cfg: InternVLConfig, vision: InternViT,
                 projector: InternVLProjector, text: LlamaModel):
        super().__init__()
        self.cfg = cfg
        self.vision, self.projector, self.text = vision, projector, text


def internvl_image_features(model: InternVLModel, pixel_values: torch.Tensor
                            ) -> torch.Tensor:
    """[B, C, H, W] → projected visual tokens [B, n_visual_tokens, D_text]:
    CLS dropped, the patches as a square, pixel-shuffled, projected."""
    feats = internvit_encode(model.vision, pixel_values)[:, 1:]
    B, N, C = feats.shape
    side = int(N ** 0.5)
    feats = pixel_shuffle(feats.reshape(B, side, side, C),
                          model.cfg.downsample_ratio)
    return model.projector(feats.reshape(B, -1, feats.shape[-1]))


def internvl_forward(model: InternVLModel, input_ids: torch.Tensor,
                     pixel_values: Optional[torch.Tensor] = None,
                     attention_mask: Optional[torch.Tensor] = None,
                     labels: Optional[torch.Tensor] = None,
                     mode: str = "tensor"):
    """input_ids carry one IMAGE_TOKEN_INDEX (-200) marker an image, each
    expanded to n_visual_tokens positions; pixel_values [N_img, C, H, W]
    (or one image [C, H, W]) → logits [B, T_out, V] fp32 ("tensor") or
    (mean loss, valid-token count) ("loss")."""
    from aurora_tpu_torch.models.aurora import fuse_multimodal
    emb = model.text.embed_tokens
    if pixel_values is not None:
        feats = internvl_image_features(
            model, pixel_values if pixel_values.dim() == 4
            else pixel_values[None])
        fused = fuse_multimodal(emb, input_ids, [feats[:, None]],
                                attention_mask, labels)
    else:
        fused = {"inputs_embeds": emb[input_ids],
                 "attention_mask": attention_mask, "position_ids": None,
                 "labels": labels}
    logits = llama_apply(model.text, model.cfg.text,
                         inputs_embeds=fused["inputs_embeds"],
                         attention_mask=fused["attention_mask"],
                         position_ids=fused["position_ids"])
    if mode == "loss":
        return llama_lm_loss(logits, fused["labels"])
    if mode == "tensor":
        return logits
    raise ValueError(f"unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# HF names (InternVLForConditionalGeneration) → the port's modules
# ---------------------------------------------------------------------------

def _pair(v):
    return v[0] if isinstance(v, (list, tuple)) else v


def internvit_config_from_hf(cfg: Dict[str, Any]) -> InternViTConfig:
    return InternViTConfig(
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        image_size=_pair(cfg.get("image_size", 448)),
        patch_size=_pair(cfg.get("patch_size", 14)),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-6),
        use_qk_norm=cfg.get("use_qk_norm", False),
        attention_bias=cfg.get("attention_bias", False),
        norm_type=cfg.get("norm_type", "layer_norm"),
        layer_scale_init_value=cfg.get("layer_scale_init_value", 0.1),
        use_absolute_position_embeddings=cfg.get(
            "use_absolute_position_embeddings", True),
        use_mean_pooling=cfg.get("use_mean_pooling", True))


def internvit_state_dict(sd: StateDict, cfg: InternViTConfig) -> StateDict:
    """InternVLVisionModel names → InternViT's (nn.Linear and Conv2d
    keep HF's layouts, so nothing is transposed)."""
    e = "embeddings."
    out = {"patch_embed.weight": sd[e + "patch_embeddings.projection.weight"],
           "patch_embed.bias": sd[e + "patch_embeddings.projection.bias"],
           "cls_token": sd[e + "cls_token"].reshape(-1)}
    if cfg.use_absolute_position_embeddings:
        out["pos_embed"] = sd[e + "position_embeddings"].reshape(
            -1, cfg.hidden_size)
    names = [("norm1.weight", "layernorm_before.weight"),
             ("norm2.weight", "layernorm_after.weight"),
             ("proj.weight", "attention.projection_layer.weight"),
             ("proj.bias", "attention.projection_layer.bias"),
             ("fc1.weight", "mlp.fc1.weight"), ("fc1.bias", "mlp.fc1.bias"),
             ("fc2.weight", "mlp.fc2.weight"), ("fc2.bias", "mlp.fc2.bias"),
             ("lambda1", "lambda_1"), ("lambda2", "lambda_2")]
    names += [(f"{n}.weight", f"attention.{n}_proj.weight") for n in "qkv"]
    if cfg.norm_type == "layer_norm":
        names += [("norm1.bias", "layernorm_before.bias"),
                  ("norm2.bias", "layernorm_after.bias")]
    if cfg.attention_bias:
        names += [(f"{n}.bias", f"attention.{n}_proj.bias") for n in "qkv"]
    if cfg.use_qk_norm:
        names += [("q_norm", "attention.q_norm.weight"),
                  ("k_norm", "attention.k_norm.weight")]
    for i in range(cfg.num_hidden_layers):
        for ours, theirs in names:
            out[f"layers.{i}.{ours}"] = sd[f"encoder.layer.{i}.{theirs}"]
    if not cfg.use_mean_pooling:
        out["final_norm.weight"] = sd["layernorm.weight"]
        out["final_norm.bias"] = sd["layernorm.bias"]
    return out


def internvit_params_from_hf(sd: StateDict, cfg: InternViTConfig,
                             dtype=torch.float32, device=None) -> InternViT:
    from aurora_tpu_torch.bridge import _load
    return _load(InternViT(cfg, device="meta", dtype=dtype),
                 internvit_state_dict(sd, cfg), device)


def internvl_params_from_hf(sd: StateDict, cfg: InternVLConfig,
                            dtype=torch.bfloat16, device=None
                            ) -> InternVLModel:
    """A whole InternVLForConditionalGeneration state dict → InternVLModel
    on `device` (default the card); the decoder through the dense zoo's
    `llama_params_from_hf`."""
    from aurora_tpu_torch.bridge import _load
    from aurora_tpu_torch.models.convert import llama_params_from_hf

    def part(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}

    text_sd = part("model.language_model.")
    if "lm_head.weight" in sd:
        text_sd["lm_head.weight"] = sd["lm_head.weight"]
    pj = part("model.multi_modal_projector.")
    projector = _load(
        InternVLProjector(cfg, device="meta", dtype=dtype),
        {f"{ours}.{suf}": pj[f"{theirs}.{suf}"]
         for ours, theirs in (("norm", "layer_norm"), ("fc1", "linear_1"),
                              ("fc2", "linear_2"))
         for suf in ("weight", "bias")}, device)
    return InternVLModel(
        cfg, internvit_params_from_hf(part("model.vision_tower."),
                                      cfg.vision, dtype, device),
        projector, llama_params_from_hf(text_sd, cfg.text, dtype, device))
