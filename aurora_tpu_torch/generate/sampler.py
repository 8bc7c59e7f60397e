"""Token sampling for offline generation (aurora_tpu/generate/sampler.py).

`SamplingParams` is the per-request configuration of both paths; the
serving engine applies its full surface on the device itself
(serve/engine.py `_sample_core`). `sample_logits` is generate/engine.py's
sampler: greedy at temperature 0, else temperature, top-k, top-p and
min-p, then a draw from an explicit `torch.Generator`, so draws are
reproducible per generator and comparable with JAX's only in
distribution.

Top-p keeps the smallest set of tokens, in descending probability, whose
mass reaches p: the rule of both serving engines. The reference's
offline `_apply_top_p` (sampler.py:43-53) takes its threshold from the
tokens it cuts, so it keeps every token when any is cut and drops every
token when none is; the port does not copy that.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0          # 0 → greedy
    top_k: int = 0                    # 0 → disabled
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0   # HF/CTRL style, prompt+output
    frequency_penalty: float = 0.0    # OpenAI style, output histogram
    presence_penalty: float = 0.0     # OpenAI style, output presence
    min_new_tokens: int = 0           # suppress eos below this length

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = logits.topk(k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: a token survives when the mass of the tokens
    before it in descending order is at most p (the top token always
    does)."""
    sorted_logits = logits.sort(dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cut = (probs.cumsum(dim=-1) - probs) > p
    thresh = sorted_logits.masked_fill(cut, float("inf")).amin(
        dim=-1, keepdim=True)
    return logits.masked_fill(logits < thresh, float("-inf"))


def _apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    top = probs.amax(dim=-1, keepdim=True)
    return logits.masked_fill(probs < min_p * top, float("-inf"))


def filter_logits(logits: torch.Tensor,
                  params: SamplingParams) -> torch.Tensor:
    """[B, V] → fp32 logits after temperature, top-k, top-p and min-p;
    the draw is from their softmax."""
    logits = logits.float() / params.temperature
    if params.top_k > 0:
        logits = _apply_top_k(logits, params.top_k)
    if params.top_p < 1.0:
        logits = _apply_top_p(logits, params.top_p)
    if params.min_p > 0.0:
        logits = _apply_min_p(logits, params.min_p)
    return logits


def sample_logits(logits: torch.Tensor, params: SamplingParams,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """logits [B, V] → token ids [B] int64. Greedy when temperature == 0;
    otherwise a draw from `generator` (on the logits' device)."""
    if params.is_greedy:
        return logits.argmax(dim=-1)
    if generator is None:
        raise ValueError("sampling requires a torch.Generator")
    probs = torch.softmax(filter_logits(logits, params), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def apply_frequency_presence_penalties(
        logits: torch.Tensor, token_counts: torch.Tensor,
        frequency_penalty: float, presence_penalty: float) -> torch.Tensor:
    """OpenAI-style penalties over per-request token histograms
    token_counts [B, V]."""
    out = logits - frequency_penalty * token_counts
    return out - presence_penalty * (token_counts > 0).to(out.dtype)


def apply_repetition_penalty(logits: torch.Tensor,
                             token_counts: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF/CTRL repetition penalty: positive logits of seen tokens divided
    by the penalty, negative ones multiplied."""
    scaled = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(token_counts > 0, scaled, logits)
