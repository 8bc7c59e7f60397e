"""Offline generation over a dense KV cache (aurora_tpu/generate/engine.py).

One prefill of the (multimodal) prompt embeddings, then a Python loop of
one-token decode steps through `llama_apply` with a KV cache sized
prompt + max_new_tokens; the loop ends early once every row has emitted
an EOS (one host read of the done flags a step). The reference runs the
same loop as one compiled `lax.while_loop`.

Right-padded prompts: row b's prompt occupies cache slots [0, len_b);
decoded tokens go at the uniform slots T + step - 1 with their true
positions len_b + step - 1 fed to RoPE, and the gap [len_b, T) stays
masked. Every call carries an attention mask, so attention takes the
plain path (`mha_reference`: SDPA on the card), as the reference's masked
calls skip its flash kernel.

This is the inference.py path; batched serving is serve/engine.py.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple

import torch

from aurora_tpu_torch.generate.sampler import SamplingParams, sample_logits
from aurora_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                           init_kv_cache, llama_apply)


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor    # [B, max_new_tokens] int64, padded with pad_id
    lengths: torch.Tensor   # [B] int64: generated tokens, EOS included
    logprobs: Optional[torch.Tensor] = None  # [B, max_new] when requested


def _ban_eos_below_min(lg: torch.Tensor, n_generated: int,
                       sampling: SamplingParams,
                       eos_ids: Tuple[int, ...]) -> torch.Tensor:
    """EOS is suppressed while fewer than min_new_tokens are out. Ids
    outside the vocabulary (the eos_ids=(-1,) 'never stop' sentinel) ban
    nothing: -1 must not wrap to the last token."""
    if n_generated >= sampling.min_new_tokens:
        return lg
    V = lg.shape[-1]
    cols = [e for e in eos_ids if 0 <= e < V]
    if not cols:
        return lg
    lg = lg.clone()
    lg[:, cols] = float("-inf")
    return lg


def _logprob_of(lg: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(lg.float(), dim=-1)
    return lp.gather(1, tok[:, None])[:, 0]


@torch.no_grad()
def generate(model: LlamaModel, cfg: LlamaConfig,
             inputs_embeds: torch.Tensor, attention_mask: torch.Tensor, *,
             max_new_tokens: int,
             sampling: SamplingParams = SamplingParams(),
             eos_ids: Tuple[int, ...] = (2,),
             pad_id: int = 0,
             generator: Optional[torch.Generator] = None,
             return_logprobs: bool = False) -> GenerateResult:
    """Greedy or sampled decode from fused (multimodal) embeddings.

    inputs_embeds [B, T, D] right-padded; attention_mask [B, T] bool.
    Sampling draws from `generator` (on the embeddings' device)."""
    if (sampling.repetition_penalty != 1.0 or sampling.frequency_penalty
            or sampling.presence_penalty):
        warnings.warn(
            "offline generate() applies temperature/top_k/top_p/min_p/"
            "min_new_tokens only; repetition/frequency/presence "
            "penalties are ignored — serve this request through "
            "aurora_tpu_torch.serve for the full sampler surface",
            stacklevel=2)
    dev = inputs_embeds.device
    B, T, _ = inputs_embeds.shape
    S = T + max_new_tokens
    eos_ids = tuple(eos_ids)
    eos = torch.tensor(eos_ids, dtype=torch.int64, device=dev)
    mask = attention_mask.to(torch.bool)
    prompt_lens = mask.sum(dim=1)
    cache = init_kv_cache(cfg, B, S, dtype=inputs_embeds.dtype, device=dev)
    full_mask = torch.zeros((B, S), dtype=torch.bool, device=dev)
    full_mask[:, :T] = mask
    position_ids = torch.arange(T, device=dev)[None] * mask
    logits, cache = llama_apply(
        model, cfg, inputs_embeds=inputs_embeds, attention_mask=full_mask,
        position_ids=position_ids, kv_cache=cache, cache_len=0)
    last = logits[torch.arange(B, device=dev), prompt_lens - 1]

    tok = sample_logits(_ban_eos_below_min(last, 0, sampling, eos_ids),
                        sampling, generator)
    done = torch.isin(tok, eos)
    out_tokens = torch.full((B, max_new_tokens), pad_id, dtype=torch.int64,
                            device=dev)
    out_tokens[:, 0] = tok
    out_lp = None
    if return_logprobs:
        out_lp = torch.zeros((B, max_new_tokens), dtype=torch.float32,
                             device=dev)
        out_lp[:, 0] = _logprob_of(last, tok)
    lengths = torch.ones((B,), dtype=torch.int64, device=dev)
    for step in range(1, max_new_tokens):
        if bool(done.all()):
            break
        write_at = T + step - 1
        full_mask[:, write_at] = True
        logits, cache = llama_apply(
            model, cfg, inputs_embeds=model.embed_tokens[tok[:, None]],
            attention_mask=full_mask,
            position_ids=(prompt_lens + step - 1)[:, None], kv_cache=cache,
            cache_len=write_at)
        lg = logits[:, 0]
        nxt = sample_logits(_ban_eos_below_min(lg, step, sampling, eos_ids),
                            sampling, generator)
        tok = torch.where(done, pad_id, nxt)
        out_tokens[:, step] = tok
        if return_logprobs:
            out_lp[:, step] = torch.where(done, 0.0, _logprob_of(lg, nxt))
        lengths += (~done).to(torch.int64)
        done = done | torch.isin(nxt, eos)
    return GenerateResult(tokens=out_tokens, lengths=lengths,
                          logprobs=out_lp)


def decode_tokens(tokenizer, result: GenerateResult,
                  eos_ids: Sequence[int] = (2,), pad_id: int = 0):
    """Host-side detokenize → list[str], trailing EOS trimmed."""
    outs = []
    for row, n in zip(result.tokens.tolist(), result.lengths.tolist()):
        ids = row[:n]
        while ids and ids[-1] in eos_ids:
            ids.pop()
        outs.append(tokenizer.decode(ids, skip_special_tokens=True))
    return outs
