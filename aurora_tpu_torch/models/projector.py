"""Visual→LLM projector: Linear + (depth-1) × (GELU → Linear)
(aurora_tpu/models/projector.py), with Yi-VL's LayerNorm after a linear
where the checkpoint carries one (Linear → LN → GELU → Linear → LN)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from aurora_tpu_torch.models.vit import LayerNorm


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    visual_hidden_size: int = 1280
    llm_hidden_size: int = 4096
    depth: int = 2
    hidden_act: str = "gelu"
    bias: bool = True


class Projector(nn.Module):
    """norm_layers: the indices of the linears followed by a LayerNorm
    (eps 1e-5), `norms.ln<i>` in the state dict; none by default."""

    def __init__(self, cfg: ProjectorConfig, device=None, dtype=None,
                 norm_layers: Sequence[int] = ()):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.visual_hidden_size] + [cfg.llm_hidden_size] * cfg.depth
        self.layers = nn.ModuleList(
            nn.Linear(a, b, bias=cfg.bias, device=device, dtype=dtype)
            for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleDict({
            f"ln{i}": LayerNorm(cfg.llm_hidden_size, 1e-5, device=device,
                                dtype=dtype)
            for i in norm_layers})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            if i > 0:
                x = F.gelu(x)   # exact (erf) GELU
            x = layer(x)
            if f"ln{i}" in self.norms:
                x = self.norms[f"ln{i}"](x)
        return x


def apply_projector(projector: Projector, x: torch.Tensor) -> torch.Tensor:
    """x [..., visual_hidden] → [..., llm_hidden]."""
    return projector(x)
