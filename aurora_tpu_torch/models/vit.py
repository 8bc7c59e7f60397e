"""AuroraCap vision tower: CLIP or SigLIP ViT with Token Merging inside
every layer (aurora_tpu/models/vit.py).

Pre-LN encoder layers with the ToMe merge spliced between attention and
MLP. `vit_encode` returns the hidden state entering layer `select_layer`
(−2: the input of the last layer), not post-layernormed, token 0 dropped.
The patch embedding is a stride-p convolution whose weight is the
reference's unfold kernel reshaped. CLIP prepends a class embedding and
runs a pre-LayerNorm; SigLIP has neither, adds a bias after the patch
convolution and uses a GELU (tanh-approximated in so400m).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aurora_tpu_torch.models.remat import remat_call
from aurora_tpu_torch.ops.attention import mha_reference, repeatable_sdpa
from aurora_tpu_torch.ops.norms import layer_norm, quick_gelu
from aurora_tpu_torch.ops.tome import (bipartite_soft_matching, merge_wavg,
                                       tome_r, tome_schedule)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_hidden_layers: int = 32
    num_attention_heads: int = 16
    image_size: int = 378
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    model_type: str = "clip"
    proportional_attention: str = "reference"  # "reference" | "key"

    def __post_init__(self):
        _act(self.hidden_act)           # an unknown activation raises

    @property
    def class_token(self) -> bool:
        return self.model_type == "clip"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_positions(self) -> int:
        n = self.num_patches_side ** 2
        return n + 1 if self.class_token else n

    @classmethod
    def dfn5b_vit_h_378(cls) -> "ViTConfig":
        """DFN5B-CLIP-ViT-H-14-378, the AuroraCap-7B vision tower."""
        return cls(hidden_size=1280, intermediate_size=5120,
                   num_hidden_layers=32, num_attention_heads=16,
                   image_size=378, patch_size=14)


def _act(name: str):
    if name == "quick_gelu":
        return quick_gelu
    if name == "gelu":
        return F.gelu
    if name in ("gelu_pytorch_tanh", "gelu_new"):
        return functools.partial(F.gelu, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


class LayerNorm(nn.Module):
    """Affine parameters for ops.norms.layer_norm (reference numerics)."""

    def __init__(self, d: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.ln1 = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.q = nn.Linear(d, d, **kw)
        self.k = nn.Linear(d, d, **kw)
        self.v = nn.Linear(d, d, **kw)
        self.o = nn.Linear(d, d, **kw)
        self.ln2 = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.fc1 = nn.Linear(d, i, **kw)
        self.fc2 = nn.Linear(i, d, **kw)
        self.act = _act(cfg.hidden_act)

    def attention(self, x, size):
        """→ (attn_out, merge metric = mean-over-heads K)."""
        B, T, D = x.shape
        H, hd = self.cfg.num_attention_heads, self.cfg.head_dim
        q = self.q(x).view(B, T, H, hd)
        k = self.k(x).view(B, T, H, hd)
        v = self.v(x).view(B, T, H, hd)
        metric = k.mean(dim=2)
        bias = None
        if size is not None and self.cfg.proportional_attention == "key":
            bias = size.log()[:, None, None, :, 0]           # [B,1,1,T]
        with repeatable_sdpa():                # off cuDNN: repeatable
            out = mha_reference(q, k, v, bias=bias, scale=hd ** -0.5)
        return self.o(out.reshape(B, T, D)), metric

    def forward(self, x, size: Optional[torch.Tensor], r: int):
        attn_out, metric = self.attention(self.ln1(x), size)
        x = x + attn_out
        if r > 0:
            # class_token=True for BOTH towers, as in the reference: token
            # 0 (CLIP's CLS, SigLIP's first patch) never merges, and
            # vit_encode drops it
            merge = bipartite_soft_matching(metric, r, class_token=True)
            x, size = merge_wavg(merge, x, size)
        h = self.fc2(self.act(self.fc1(self.ln2(x))))
        return x + h, size


class VisionTransformer(nn.Module):
    """CLIP (class token, pre-LayerNorm) or SigLIP (a patch bias instead)."""

    def __init__(self, cfg: ViTConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d, ps = cfg.hidden_size, cfg.patch_size
        kw = dict(device=device, dtype=dtype)
        self.patch_embed = nn.Conv2d(cfg.num_channels, d, ps, stride=ps,
                                     bias=not cfg.class_token, **kw)
        if cfg.class_token:
            self.class_embedding = nn.Parameter(torch.zeros(d, **kw))
            self.pre_layernorm = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.num_positions, d, **kw))
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))

    def embed(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] → [B, N (+ 1 CLS), D] with position embeddings."""
        B, _, H, W = pixel_values.shape
        ps = self.cfg.patch_size
        emb = self.patch_embed(pixel_values).flatten(2).transpose(1, 2)
        if self.cfg.class_token:
            cls = self.class_embedding.to(emb.dtype).expand(B, 1, -1)
            emb = torch.cat([cls, emb], dim=1)
        pos = self.position_embedding
        if pos.shape[0] != emb.shape[1] or H // ps != W // ps:
            pos = interpolate_pos_embedding(pos, self.cfg, H, W)
        return emb + pos[None].to(emb.dtype)


def interpolate_pos_embedding(pos_embed: torch.Tensor, cfg: ViTConfig,
                              h: int, w: int) -> torch.Tensor:
    """Bicubic resample of the patch position embeddings for a non-native
    resolution: F.interpolate with align_corners=False and the explicit
    scale factor ((rows + 0.1) / n, (cols + 0.1) / n) of the reference.
    CLIP's CLS slot (row 0) passes through; SigLIP has none."""
    rows, cols = h // cfg.patch_size, w // cfg.patch_size
    n_cls = 1 if cfg.class_token else 0
    cls, patch = pos_embed[:n_cls], pos_embed[n_cls:]
    n = int(math.sqrt(patch.shape[0]))
    if rows * cols == patch.shape[0] and rows == cols:
        return pos_embed
    grid = patch.reshape(1, n, n, -1).permute(0, 3, 1, 2).to(torch.float32)
    out = F.interpolate(grid, scale_factor=((rows + 0.1) / n,
                                            (cols + 0.1) / n),
                        mode="bicubic", align_corners=False)
    out = out[0].permute(1, 2, 0).reshape(-1, patch.shape[-1])
    return torch.cat([cls, out.to(pos_embed.dtype)], dim=0)


def vit_tome_r(cfg: ViTConfig, kept_ratio: float, h: int, w: int) -> int:
    return tome_r(h, w, cfg.patch_size, kept_ratio, cfg.num_hidden_layers)


def vit_encode(vit: VisionTransformer, pixel_values: torch.Tensor, *,
               kept_ratio: float = 1.0, select_layer: int = -2,
               remat=False) -> torch.Tensor:
    """[B, C, H, W] → hidden state entering layer `select_layer` (the
    final output for −1), token 0 dropped: [B, T_sel - 1, D]. Layers past
    the selected one are not run. remat: per layer (models/remat.py)."""
    cfg = vit.cfg
    _, _, H, W = pixel_values.shape
    x = vit.embed(pixel_values)
    if cfg.class_token:
        x = vit.pre_layernorm(x)
    r = vit_tome_r(cfg, kept_ratio, H, W)
    sched = tome_schedule(x.shape[1], r, cfg.num_hidden_layers, 1)
    n_run = select_layer % (cfg.num_hidden_layers + 1)
    size = None
    for li in range(n_run):
        x, size = remat_call(vit.layers[li], remat, x, size, sched[li].r)
    # token 0 dropped for BOTH towers, as the reference's AuroraModel
    # slices [:, 1:] unconditionally: SigLIP loses its (protected) first
    # patch as CLIP loses its CLS
    return x[:, 1:]
