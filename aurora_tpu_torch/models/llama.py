"""Llama-family decoder configuration and parameter layout
(aurora_tpu/models/llama.py). Vicuna-7B-v1.5-16k is the AuroraCap LLM.

Only the llama case is ported (RMSNorm, SiLU-gated MLP, rotary with
optional linear scaling, GQA, no biases). The reference stacks layers as
[L, ...] arrays with dense kernels [in, out]; here each layer is a module
of `nn.Linear`s ([out, in] weights), or, for W4 serving, of `W4Linear`s
(nibble-packed int4 + group scales, the port's layout of
ops/pallas/quant_matmul.py) with an int8 `W8Linear` LM head. A layer
holds either the per-name projections (q, k, v, o, gate, up, down) or the
fused serving streams (qkv, o, gateup, down). The serving forward lives in
serve/engine.py; the offline `llama_apply` and loss wait for the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 16384
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_linear_scaling: Optional[float] = None
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def attn_scale(self) -> float:
        return float(self.head_dim) ** -0.5

    @classmethod
    def vicuna_7b_v15_16k(cls) -> "LlamaConfig":
        """lmsys/vicuna-7b-v1.5-16k, the AuroraCap-7B decoder."""
        return cls(rope_linear_scaling=4.0)

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "LlamaConfig":
        return cls(vocab_size=vocab_size, hidden_size=64,
                   intermediate_size=128, num_hidden_layers=3,
                   num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=512)


W4_GROUP = 128        # input rows per W4 scale group (the reference's)


def w4_group(in_features: int) -> int:
    """The reference's W4 group size: min(128, in_features)."""
    return min(W4_GROUP, in_features)


class W4Linear(nn.Module):
    """y = x @ W^T with W nibble-packed int4: `packed` [out, in/2] int8
    (even input row in the low nibble) and `scale` [out, G] fp32 for G
    groups of in/G input rows (see ops/pallas/quant_matmul.py). The
    engine's `_w4dot` computes with it."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("packed", packed)
        self.register_buffer("scale", scale)

    @classmethod
    def empty(cls, in_features: int, out_features: int,
              device=None) -> "W4Linear":
        group = w4_group(in_features)
        if in_features % group or group % 2:
            raise ValueError(f"in_features={in_features} does not split "
                             f"into groups of {group}")
        return cls(torch.zeros((out_features, in_features // 2),
                               dtype=torch.int8, device=device),
                   torch.zeros((out_features, in_features // group),
                               dtype=torch.float32, device=device))


class W8Linear(nn.Module):
    """y = x @ W^T with W int8 per output channel: `weight` [out, in]
    int8 and `scale` [out] fp32 (the W8A8 LM head of the W4 tree)."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale)

    @classmethod
    def empty(cls, in_features: int, out_features: int,
              device=None) -> "W8Linear":
        return cls(torch.zeros((out_features, in_features), dtype=torch.int8,
                               device=device),
                   torch.zeros((out_features,), dtype=torch.float32,
                               device=device))


def projection_shapes(cfg: LlamaConfig,
                      fused: bool) -> Dict[str, Tuple[int, int]]:
    """(in, out) of each projection of a layer: per name, or the fused
    serving streams (qkv = q ‖ k ‖ v, gateup = gate ‖ up on the output
    axis)."""
    d, i, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd
    if fused:
        return {"qkv": (d, nq + 2 * nkv), "o": (nq, d),
                "gateup": (d, 2 * i), "down": (i, d)}
    return {"q": (d, nq), "k": (d, nkv), "v": (d, nkv), "o": (nq, d),
            "gate": (d, i), "up": (d, i), "down": (i, d)}


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 weight_quant: str = "none", fused: bool = False):
        super().__init__()
        d = cfg.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.input_norm = nn.Parameter(torch.ones(d, **kw))
        self.post_attn_norm = nn.Parameter(torch.ones(d, **kw))
        for name, (n_in, n_out) in projection_shapes(cfg, fused).items():
            if weight_quant == "int4":
                proj = W4Linear.empty(n_in, n_out, device=device)
            else:
                proj = nn.Linear(n_in, n_out, bias=False, **kw)
            setattr(self, name, proj)


class LlamaModel(nn.Module):
    """Parameters of the decoder; the forward is the serving engine's.
    weight_quant="int4" lays the layers out as W4Linear projections (per
    name, or fused with fused=True) and the LM head as W8Linear."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 weight_quant: str = "none", fused: bool = False):
        super().__init__()
        if cfg.tie_word_embeddings:
            raise NotImplementedError("tied embeddings are not ported")
        if weight_quant not in ("none", "int4"):
            raise NotImplementedError(
                f"weight_quant={weight_quant!r}: only int4 is ported")
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.zeros(cfg.vocab_size, d, **kw))
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, weight_quant=weight_quant, fused=fused, **kw)
            for _ in range(cfg.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(d, **kw))
        if weight_quant == "int4":
            self.lm_head = W8Linear.empty(d, cfg.vocab_size, device=device)
        else:
            self.lm_head = nn.Linear(d, cfg.vocab_size, bias=False, **kw)
