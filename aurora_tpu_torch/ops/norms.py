"""Normalization and activation ops (aurora_tpu/ops/norms.py).

Statistics in fp32, output cast back to the input dtype, as the
reference does (HF LlamaRMSNorm / torch LayerNorm semantics):
RMSNorm, LayerNorm (with a bias, bias-free or non-parametric), Cohere's
mean-centered LayerNorm, and the SiLU / GELU / quick_gelu activations of
the decoder families and CLIP.
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


def cohere_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Cohere's LayerNorm (modeling_cohere.CohereLayerNorm): mean-centered,
    no bias, the weight multiply in fp32; also per head for its qk-norm
    (weight [H, hd] broadcasting over [B, T, H, hd])."""
    xf = x.to(torch.float32)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).pow(2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (weight.to(torch.float32) * y).to(x.dtype)


def family_norm(cfg, x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor = None) -> torch.Tensor:
    """Decoder-family norm dispatch, shared by the offline model
    (models/llama.py) and the serving engine (serve/engine.py): RMSNorm
    (optionally the all-fp32 (1 + w) multiply, cfg.norm_upcast_mul),
    LayerNorm with an optional bias (StableLM, OLMo, StarCoder2; a
    non-parametric norm passes ones), or Cohere's bias-free LayerNorm."""
    if cfg.norm_type == "layernorm":
        return layer_norm(x, weight,
                          bias if bias is not None
                          else torch.zeros_like(weight), cfg.rms_norm_eps)
    if cfg.norm_type == "cohere":
        return cohere_layer_norm(x, weight, cfg.rms_norm_eps)
    return rms_norm(x, weight, cfg.rms_norm_eps,
                    upcast_weight_mul=cfg.norm_upcast_mul)


def family_act(cfg, gate: torch.Tensor) -> torch.Tensor:
    """MLP activation dispatch: SiLU (llama), tanh-approximated GELU in
    fp32 (Gemma's GeGLU, StarCoder2) or exact GELU."""
    if cfg.hidden_act == "gelu_tanh":
        return F.gelu(gate.to(torch.float32),
                      approximate="tanh").to(gate.dtype)
    if cfg.hidden_act == "gelu":
        return F.gelu(gate.to(torch.float32)).to(gate.dtype)
    return F.silu(gate)
