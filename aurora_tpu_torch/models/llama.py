"""Llama-family decoder configuration and parameter layout
(aurora_tpu/models/llama.py). Vicuna-7B-v1.5-16k is the AuroraCap LLM.

Only the llama case is ported (RMSNorm, SiLU-gated MLP, rotary with
optional linear scaling, GQA, no biases). The reference stacks layers as
[L, ...] arrays with dense kernels [in, out]; here each layer is a module
of `nn.Linear`s ([out, in] weights). The serving forward lives in
serve/engine.py; the offline `llama_apply` and loss wait for the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        d, i, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.input_norm = nn.Parameter(torch.ones(d, **kw))
        self.post_attn_norm = nn.Parameter(torch.ones(d, **kw))
        self.q = nn.Linear(d, cfg.num_attention_heads * hd, bias=False, **kw)
        self.k = nn.Linear(d, cfg.num_key_value_heads * hd, bias=False, **kw)
        self.v = nn.Linear(d, cfg.num_key_value_heads * hd, bias=False, **kw)
        self.o = nn.Linear(cfg.num_attention_heads * hd, d, bias=False, **kw)
        self.gate = nn.Linear(d, i, bias=False, **kw)
        self.up = nn.Linear(d, i, bias=False, **kw)
        self.down = nn.Linear(i, d, bias=False, **kw)


class LlamaModel(nn.Module):
    """Parameters of the decoder; the forward is the serving engine's."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        if cfg.tie_word_embeddings:
            raise NotImplementedError("tied embeddings are not ported")
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.zeros(cfg.vocab_size, d, **kw))
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(d, **kw))
        self.lm_head = nn.Linear(d, cfg.vocab_size, bias=False, **kw)
