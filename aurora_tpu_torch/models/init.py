"""Seeded random initialization with the reference's scheme: every weight
matrix, embedding and position table ~ N(0, 0.02²), biases zero, norm
scales one (the `init_*_params` functions of aurora_tpu/models/)."""

from __future__ import annotations

import torch
from torch import nn


def _is_norm(name: str) -> bool:
    """A norm scale: a LayerNorm module's weight (ln1, pre_layernorm) or a
    bare RMSNorm parameter (input_norm, final_norm)."""
    parts = name.split(".")
    last = parts[-2] if parts[-1] == "weight" and len(parts) > 1 \
        else parts[-1]
    return "norm" in last or last.startswith("ln")


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Fill `module`'s parameters in place from `generator` (which must
    live on the parameters' device)."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif _is_norm(name):
            p.fill_(1.0)
        else:
            p.normal_(0.0, std, generator=generator)
    return module


def build(ctor, *args, device, dtype, generator: torch.Generator):
    """Construct `ctor(*args)` without running torch's default init (no
    global RNG use, no wasted fill), then fill it from `generator`."""
    module = ctor(*args, device="meta", dtype=dtype)
    module = module.to_empty(device=device)
    return random_init_(module, generator)
