"""Beam search over the dense KV cache (aurora_tpu/generate/beam.py).

HF `generate(num_beams=K, do_sample=False)` semantics, as the reference's
inference.py:38/:94 uses them: vanilla beam search with length_penalty,
early_stopping=False and EOS handling over 2K candidates (a finished
hypothesis leaves the running set and is ranked by score / len **
length_penalty, len counting the generated tokens with the EOS). The
beams are the batch of the decode step, and reordering them is a gather
on the cache's batch axis. The loop runs on the host, one decode step and
one read of the stop condition per token.

Every top-k here is a stable descending sort, so that ties (the -1e9 of
an empty slot) resolve to the lowest index, as `lax.top_k` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from aurora_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                           init_kv_cache, llama_apply)

_NEG = -1e9


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    values, idx = x.sort(descending=True, stable=True)
    return values[:k], idx[:k]


def _norm(score: torch.Tensor, n_generated: int,
          length_penalty: float) -> torch.Tensor:
    """HF normalizes by the generated length; the prompt never enters."""
    return score / (float(n_generated) ** length_penalty)


@torch.no_grad()
def beam_generate(model: LlamaModel, cfg: LlamaConfig,
                  inputs_embeds: torch.Tensor,
                  attention_mask: torch.Tensor, *,
                  num_beams: int, max_new_tokens: int,
                  eos_ids: Tuple[int, ...] = (2,), pad_id: int = 0,
                  length_penalty: float = 1.0
                  ) -> Tuple[torch.Tensor, int]:
    """inputs_embeds [1, T, D] (beam search is per prompt, as in the
    reference CLI) → (tokens [max_new_tokens] of the best hypothesis,
    its length)."""
    if inputs_embeds.shape[0] != 1:
        raise ValueError("beam search takes a batch of one prompt")
    K = num_beams
    dev = inputs_embeds.device
    _, T, _ = inputs_embeds.shape
    S = T + max_new_tokens
    V = cfg.vocab_size
    eos = torch.tensor(tuple(eos_ids), dtype=torch.int64, device=dev)

    # ---- prefill once, tile the cache across the beams
    mask = attention_mask.to(torch.bool)
    prompt_len = int(mask.sum())
    cache = init_kv_cache(cfg, 1, S, dtype=inputs_embeds.dtype, device=dev)
    kv_mask = torch.zeros((1, S), dtype=torch.bool, device=dev)
    kv_mask[:, :T] = mask
    logits, cache = llama_apply(
        model, cfg, inputs_embeds=inputs_embeds, attention_mask=kv_mask,
        position_ids=torch.arange(T, device=dev)[None] * mask,
        kv_cache=cache, cache_len=0)
    cache = {n: c.repeat_interleave(K, dim=1) for n, c in cache.items()}
    kv_mask = kv_mask.repeat(K, 1)

    lp0 = torch.log_softmax(logits[0, prompt_len - 1].float(), dim=-1)
    beam_scores, beam_last = _top_k(lp0, K)
    tokens = torch.full((K, max_new_tokens), pad_id, dtype=torch.int64,
                        device=dev)
    tokens[:, 0] = beam_last
    # beams whose first token is EOS retire at once
    first_eos = torch.isin(beam_last, eos)
    fin_scores = torch.where(first_eos, _norm(beam_scores, 1,
                                              length_penalty), _NEG)
    fin_tokens = torch.where(first_eos[:, None], tokens, pad_id)
    fin_lens = first_eos.to(torch.int64)
    beam_scores = torch.where(first_eos, _NEG, beam_scores)

    step = 1
    while step < max_new_tokens:
        # early_stopping=False: done when the best running beam, normalized
        # at the current length, cannot beat the worst finished one
        if bool(fin_scores.min() >= _norm(beam_scores.max(), step,
                                          length_penalty)):
            break
        write_at = T + step - 1
        kv_mask[:, write_at] = True
        pos = torch.full((K, 1), prompt_len + step - 1, dtype=torch.int64,
                         device=dev)
        logits, cache = llama_apply(
            model, cfg, inputs_embeds=model.embed_tokens[beam_last[:, None]],
            attention_mask=kv_mask, position_ids=pos, kv_cache=cache,
            cache_len=write_at)
        lp = torch.log_softmax(logits[:, 0].float(), dim=-1)
        cand = (beam_scores[:, None] + lp).reshape(-1)           # [K * V]
        c_scores, c_idx = _top_k(cand, 2 * K)
        c_beam = c_idx // V
        c_tok = c_idx % V
        c_eos = torch.isin(c_tok, eos)

        # finished pool: merge the EOS candidates, normalized, with their
        # EOS written at its position (fin_lens counts it)
        cand_fin = torch.where(c_eos, _norm(c_scores, step + 1,
                                            length_penalty), _NEG)
        cand_fin_tokens = tokens[c_beam]
        cand_fin_tokens[:, step] = c_tok
        all_scores = torch.cat([fin_scores, cand_fin])
        all_tokens = torch.cat([fin_tokens, cand_fin_tokens])
        all_lens = torch.cat([fin_lens, torch.full((2 * K,), step + 1,
                                                   dtype=torch.int64,
                                                   device=dev)])
        fin_scores, keep = _top_k(all_scores, K)
        fin_tokens = all_tokens[keep]
        fin_lens = all_lens[keep]

        # running beams: the best K candidates that are not EOS
        beam_scores, pick = _top_k(torch.where(c_eos, _NEG, c_scores), K)
        r_beam = c_beam[pick]
        beam_last = c_tok[pick]
        for n in cache:
            cache[n] = cache[n].index_select(1, r_beam)
        kv_mask = kv_mask[r_beam]
        tokens = tokens[r_beam]
        tokens[:, step] = beam_last
        step += 1

    # the best finished hypothesis against the best normalized running one
    run_norm = _norm(beam_scores, step, length_penalty)
    if bool(fin_scores.max() >= run_norm.max()):
        best = int(fin_scores.argmax())
        return fin_tokens[best], int(fin_lens[best])
    return tokens[int(run_norm.argmax())], step
