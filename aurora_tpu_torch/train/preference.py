"""Preference objectives over the universal decoder
(aurora_tpu/train/preference.py): DPO, ORPO and a Bradley-Terry reward
model (xtuner's dpo.py, orpo.py and reward.py).

Batches carry chosen / rejected pairs: `chosen_ids`, `chosen_labels`,
`rejected_ids`, `rejected_labels` [B, T] (labels IGNORE_INDEX on the
prompt), and for the reward model optional `chosen_mask` /
`rejected_mask`. The steps run `llama_apply` without an attention mask,
so on the card an unmasked batch of T >= 128 at a head_dim that is a
multiple of 128 goes through the flash kernels, forward and backward
(ops/attention.py `mha`). Each step computes its gradients under
`train.trainer.repeatable_step` and applies them with the port's
`Optimizer` (clip by global norm → AdamW), as train/trainer.py's step
does; the model's parameters are updated in place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from aurora_tpu_torch.models.llama import LlamaConfig, llama_apply
from aurora_tpu_torch.train.trainer import (Optimizer, _global_norm,
                                            repeatable_step)
from aurora_tpu_torch.utils.constants import IGNORE_INDEX


def sequence_logprob(model, cfg: LlamaConfig, input_ids, labels,
                     attention_mask=None) -> torch.Tensor:
    """Σ log p(label) over the labels that are not IGNORE_INDEX, per
    sequence → [B] fp32."""
    logits = llama_apply(model, cfg, input_ids=input_ids,
                         attention_mask=attention_mask)
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = labels[:, 1:]
    valid = tgt != IGNORE_INDEX
    tok = lp.gather(-1, torch.where(valid, tgt, 0)[..., None])[..., 0]
    return torch.where(valid, tok, 0.0).sum(-1)


def dpo_loss(policy_chosen_lp, policy_rejected_lp, ref_chosen_lp,
             ref_rejected_lp, *, beta: float = 0.1,
             label_smoothing: float = 0.0):
    """Sigmoid DPO (dpo.py loss_type='sigmoid') → (loss [B], chosen
    rewards, rejected rewards)."""
    h = beta * ((policy_chosen_lp - policy_rejected_lp)
                - (ref_chosen_lp - ref_rejected_lp))
    loss = (-F.logsigmoid(h) * (1 - label_smoothing)
            - F.logsigmoid(-h) * label_smoothing)
    return (loss, beta * (policy_chosen_lp - ref_chosen_lp),
            beta * (policy_rejected_lp - ref_rejected_lp))


def _apply(model, opt: Optimizer, opt_state, loss_fn):
    """loss_fn() → (loss, aux) under repeatable_step; its gradients over
    opt's parameters go through opt.update. → {"loss", **aux}."""
    params = opt.params(model)
    live = [p for p in params if p.requires_grad]
    with repeatable_step():
        loss, aux = loss_fn()
        got = torch.autograd.grad(loss, live, allow_unused=True)
    found = dict(zip(map(id, live), got))
    grads = [found.get(id(p)) for p in params]
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    opt.update(grads, opt_state, model, _global_norm(grads))
    return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}


def make_dpo_step(cfg: LlamaConfig, ref_model, opt: Optimizer, *,
                  beta: float = 0.1, label_smoothing: float = 0.0):
    """→ step(model, opt_state, batch) → (model, opt_state, metrics):
    loss, reward_acc, reward_margin. The reference model is an argument
    (`step.with_ref(model, opt_state, batch, ref)`; `step` passes
    `ref_model`), its log-probs computed under torch.no_grad."""

    def loss_fn(model, ref, batch):
        def both(m):
            return (sequence_logprob(m, cfg, batch["chosen_ids"],
                                     batch["chosen_labels"]),
                    sequence_logprob(m, cfg, batch["rejected_ids"],
                                     batch["rejected_labels"]))
        pc, pr = both(model)
        with torch.no_grad():
            rc, rr = both(ref)
        loss, cr, jr = dpo_loss(pc, pr, rc, rr, beta=beta,
                                label_smoothing=label_smoothing)
        return loss.mean(), {"reward_acc": (cr > jr).float().mean(),
                             "reward_margin": (cr - jr).mean()}

    def step_with_ref(model, opt_state, batch, ref):
        metrics = _apply(model, opt, opt_state,
                         lambda: loss_fn(model, ref, batch))
        return model, opt_state, metrics

    def step(model, opt_state, batch):
        return step_with_ref(model, opt_state, batch, ref_model)

    step.with_ref = step_with_ref
    return step


def orpo_loss(model, cfg: LlamaConfig, batch, *, beta: float = 0.1):
    """ORPO (orpo.py): the chosen NLL plus beta times the odds-ratio
    penalty, reference-free, over LENGTH-NORMALIZED sequence log-probs
    → (loss, {nll, or_penalty, acc})."""
    def mean_lp(ids, labels):
        total = sequence_logprob(model, cfg, ids, labels)
        n = (labels[:, 1:] != IGNORE_INDEX).sum(-1)
        return total / n.clamp_min(1)

    lp_c = mean_lp(batch["chosen_ids"], batch["chosen_labels"])
    lp_r = mean_lp(batch["rejected_ids"], batch["rejected_labels"])
    # log odds(p) = log(p / (1 - p)) with p = exp(mean log-prob)
    log_odds = ((lp_c - lp_r)
                - (torch.log1p(-torch.exp(lp_c.clamp_max(-1e-7)))
                   - torch.log1p(-torch.exp(lp_r.clamp_max(-1e-7)))))
    ratio = -F.logsigmoid(log_odds)
    nll = -lp_c
    return (nll + beta * ratio).mean(), {
        "nll": nll.mean(), "or_penalty": ratio.mean(),
        "acc": (lp_c > lp_r).float().mean()}


def make_orpo_step(cfg: LlamaConfig, opt: Optimizer, *, beta: float = 0.1):
    """→ step(model, opt_state, batch) → (model, opt_state, metrics)."""

    def step(model, opt_state, batch):
        metrics = _apply(model, opt, opt_state,
                         lambda: orpo_loss(model, cfg, batch, beta=beta))
        return model, opt_state, metrics

    return step


# ---------------------------------------------------------------------------
# Reward model
# ---------------------------------------------------------------------------

def init_value_head(generator: torch.Generator, cfg: LlamaConfig,
                    dtype=torch.float32) -> torch.Tensor:
    """The scalar value head [D, 1] ~ N(0, 0.02²) from `generator`, on its
    device."""
    return torch.randn((cfg.hidden_size, 1), generator=generator,
                       device=generator.device, dtype=dtype) * 0.02


def trunk_forward(model, cfg: LlamaConfig, input_ids,
                  attention_mask=None) -> torch.Tensor:
    """The final-norm hidden states [B, T, D] (no LM head)."""
    return llama_apply(model, cfg, input_ids=input_ids,
                       attention_mask=attention_mask, return_hidden=True)


def reward_model_scores(model, value_head, cfg: LlamaConfig, input_ids,
                        attention_mask=None) -> torch.Tensor:
    """The value head on each sequence's last valid token → [B] fp32."""
    h = trunk_forward(model, cfg, input_ids, attention_mask)
    if attention_mask is not None:
        last = attention_mask.to(torch.int64).sum(1) - 1
    else:
        last = torch.full((input_ids.shape[0],), input_ids.shape[1] - 1,
                          device=h.device)
    h_last = h[torch.arange(h.shape[0], device=h.device), last]
    return (h_last.float() @ value_head.float())[:, 0]


def reward_bt_loss(model, value_head, cfg: LlamaConfig,
                   batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Bradley-Terry pairwise ranking loss (reward.py) → (loss, {acc,
    margin})."""
    sc = reward_model_scores(model, value_head, cfg, batch["chosen_ids"],
                             batch.get("chosen_mask"))
    sr = reward_model_scores(model, value_head, cfg,
                             batch["rejected_ids"],
                             batch.get("rejected_mask"))
    return -F.logsigmoid(sc - sr).mean(), {
        "acc": (sc > sr).float().mean(), "margin": (sc - sr).mean()}
