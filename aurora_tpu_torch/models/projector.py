"""Visual→LLM projector: Linear + (depth-1) × (GELU → Linear)
(aurora_tpu/models/projector.py)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    visual_hidden_size: int = 1280
    llm_hidden_size: int = 4096
    depth: int = 2
    hidden_act: str = "gelu"
    bias: bool = True


class Projector(nn.Module):
    def __init__(self, cfg: ProjectorConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.visual_hidden_size] + [cfg.llm_hidden_size] * cfg.depth
        self.layers = nn.ModuleList(
            nn.Linear(a, b, bias=cfg.bias, device=device, dtype=dtype)
            for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            if i > 0:
                x = F.gelu(x)   # exact (erf) GELU
            x = layer(x)
        return x


def apply_projector(projector: Projector, x: torch.Tensor) -> torch.Tensor:
    """x [..., visual_hidden] → [..., llm_hidden]."""
    return projector(x)
