"""Normalization and activation ops (aurora_tpu/ops/norms.py).

Statistics in fp32, output cast back to the input dtype, as the
reference does (HF LlamaRMSNorm / torch LayerNorm semantics). Only the
llama (RMSNorm + SiLU) and CLIP (LayerNorm + quick_gelu) cases are
ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             upcast_weight_mul: bool = False) -> torch.Tensor:
    """fp32 variance; cast back to x's dtype BEFORE the weight multiply
    (HF order) unless upcast_weight_mul."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    if upcast_weight_mul:
        return (weight.to(torch.float32) * xf).to(dtype)
    return weight * xf.to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Biased variance in fp32; normalized value cast back, then affine."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = (xf - mean) * (var + eps) ** -0.5
    return (y.to(dtype) * weight + bias).to(dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP activation: x * sigmoid(1.702 x)."""
    return x * torch.reciprocal(1.0 + torch.exp(-1.702 * x))


def family_norm(cfg, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Decoder norm dispatch; the port carries the llama RMSNorm case."""
    return rms_norm(x, weight, cfg.rms_norm_eps)


def family_act(cfg, gate: torch.Tensor) -> torch.Tensor:
    """Decoder MLP activation dispatch; the port carries SiLU."""
    return F.silu(gate)
