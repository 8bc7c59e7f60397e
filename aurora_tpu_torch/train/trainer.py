"""Training step (aurora_tpu/train/trainer.py): TrainConfig, the learning
rate schedule, the optimizer, the train state and `make_train_step`.

The reference chains optax transforms; the port's `Optimizer` is its own
code, written to match one optax step to fp32 rounding (not
`torch.optim.AdamW`, whose order of operations differs):
  * clip_by_global_norm: g if ‖g‖ < max_norm, else g / ‖g‖ · max_norm
    (optax's formula, not `clip_grad_norm_`'s +1e-6);
  * AdamW as `optax.adamw`: moments in the parameter dtype,
    mu = (1-b1) g + b1 mu, nu = (1-b2) g² + b2 nu, bias-corrected with
    1 - b^count in fp32, u = mu_hat / (sqrt(nu_hat) + eps), u += wd · p
    (decoupled weight decay, before the learning rate), u *= -lr(count)
    in the update dtype, p += u;
  * frozen modules (freeze_llm / _visual_encoder / _projector) get
    `requires_grad_(False)` in `init_train_state`: no gradient is computed
    for them (the reference's stop_gradient) and the optimizer leaves them
    alone (its set_to_zero);
  * grad_accum k > 1 as `optax.MultiSteps`: the running mean of k
    gradients, one update every k steps, the schedule advancing once per
    window.
The step updates the model's parameters in place: `TrainState.params` is
the model itself. Sums of squares for the norms run in fp32 (optax sums
in the leaf dtype; the same for fp32 parameters).

Not ported (NotImplementedError): sequence parallelism (`sp_mode`,
`hybrid_ulysses`, `ring_layout`, `heads_k_stride` off their defaults, a
mesh), packed batches (`segment_ids`, see models/aurora.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from aurora_tpu_torch.models.aurora import (AuroraConfig, AuroraModel,
                                            aurora_forward)

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 2e-4
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    warmup_ratio: float = 0.03
    max_steps: int = 1000
    grad_clip: float = 1.0
    grad_accum: int = 1
    freeze_llm: bool = False
    freeze_visual_encoder: bool = False
    freeze_projector: bool = False
    kept_ratio: float = 1.0
    remat: bool = True
    # optional remat policy applied when remat=True (models/remat.py);
    # None = full remat
    remat_policy: Optional[str] = None
    # sequence parallelism: accepted at the defaults only
    sp_mode: Optional[str] = None
    hybrid_ulysses: int = 1
    ring_layout: str = "contiguous"
    heads_k_stride: int = 0

    def __post_init__(self):
        if (self.sp_mode is not None or self.hybrid_ulysses != 1
                or self.ring_layout != "contiguous"
                or self.heads_k_stride != 0):
            raise NotImplementedError(
                "sequence parallelism (sp_mode, hybrid_ulysses, ring_layout, "
                "heads_k_stride) is not ported yet")


@dataclasses.dataclass
class TrainState:
    params: AuroraModel        # updated in place by the step
    opt_state: Dict[str, Any]
    step: int


def lr_schedule(cfg: TrainConfig):
    """optax.join_schedules([linear_schedule(lr/warmup, lr, warmup),
    cosine_decay_schedule(lr, max_steps - warmup)], [warmup]) as a function
    of the step, computed in fp32 as optax does."""
    warmup = max(1, int(cfg.max_steps * cfg.warmup_ratio))
    decay = cfg.max_steps - warmup
    if decay <= 0:
        raise ValueError("the cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay}")
    lr0 = cfg.lr / warmup

    def schedule(step: int) -> float:
        if step < warmup:
            frac = _F32(1) - _F32(min(max(step, 0), warmup)) / _F32(warmup)
            return float(_F32(lr0 - cfg.lr) * frac + _F32(cfg.lr))
        count = _F32(min(step - warmup, decay))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(np.pi) * count
                                               / _F32(decay)))
        return float(_F32(cfg.lr) * cosine)

    return schedule


def _frozen(cfg: TrainConfig) -> Dict[str, bool]:
    return {"llm": cfg.freeze_llm,
            "visual_encoder": cfg.freeze_visual_encoder,
            "projector": cfg.freeze_projector}


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t.float().square().sum() for t in tensors),
                          torch.zeros(())))


class Optimizer:
    """clip_by_global_norm → AdamW over the trainable parameters, inside
    MultiSteps when grad_accum > 1 (see the module docstring)."""

    def __init__(self, model: AuroraModel, cfg: TrainConfig):
        frozen = _frozen(cfg)
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)
        self.names = [n for n, _ in model.named_parameters()
                      if not frozen.get(n.split(".")[0], False)]

    def params(self, model: AuroraModel) -> List[torch.Tensor]:
        named = dict(model.named_parameters())
        return [named[n] for n in self.names]

    def init(self, model: AuroraModel) -> Dict[str, Any]:
        ps = self.params(model)
        state = {"count": 0, "mu": [torch.zeros_like(p) for p in ps],
                 "nu": [torch.zeros_like(p) for p in ps]}
        if self.cfg.grad_accum > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc=[torch.zeros_like(p) for p in ps])
        return state

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               model: AuroraModel,
               gnorm: Optional[torch.Tensor] = None) -> None:
        """Apply one step's gradients (in self.names order) in place.
        gnorm: their global norm, where the caller has it already; with
        grad_accum > 1 the clip takes the norm of the window's mean."""
        k = self.cfg.grad_accum
        if k > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc"], grads):
                acc.add_((g - acc) / (n + 1))     # optax's running mean
            state["mini_step"] = (n + 1) % k
            if n != k - 1:
                return
            state["gradient_step"] += 1
            grads, gnorm = state["acc"], None
        if gnorm is None:
            gnorm = _global_norm(grads)
        self._adamw(grads, gnorm, state, self.params(model))
        if k > 1:
            for acc in state["acc"]:
                acc.zero_()

    def _adamw(self, grads, gnorm, state, params) -> None:
        cfg = self.cfg
        b1, b2 = cfg.betas
        clip = not bool(gnorm < cfg.grad_clip)
        step_size = -self.schedule(state["count"])
        state["count"] += 1
        t = torch.tensor(state["count"], dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        for g, mu, nu, p in zip(grads, state["mu"], state["nu"], params):
            if clip:
                g = (g / gnorm.to(g.dtype)) * cfg.grad_clip
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1.to(mu.device, mu.dtype)) / (
                torch.sqrt(nu / bc2.to(nu.device, nu.dtype)) + 1e-8)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * p
            p.add_(torch.tensor(step_size, dtype=u.dtype,
                                device=u.device) * u)


def make_optimizer(params: AuroraModel, cfg: TrainConfig) -> Optimizer:
    return Optimizer(params, cfg)


def init_train_state(params: AuroraModel, cfg: TrainConfig) -> TrainState:
    """Freeze the configured modules (requires_grad_(False)) and set up
    the optimizer state; the model becomes the state's params."""
    for name, frozen in _frozen(cfg).items():
        getattr(params, name).requires_grad_(not frozen)
    return TrainState(params=params,
                      opt_state=make_optimizer(params, cfg).init(params),
                      step=0)


def make_train_step(acfg: AuroraConfig, tcfg: TrainConfig,
                    opt: Optional[Optimizer] = None, mesh=None):
    """Returns step(state, batch) → (state, metrics).

    batch: input_ids [B, T], labels [B, T], optional attention_mask [B, T]
    and pixel_values [B, F, C, H, W] (text-only batches skip the ViT).
    metrics (0-d tensors but lr): loss, ntokens, grad_norm (the global
    norm of all gradients, before clipping) and lr at step // grad_accum.
    """
    if mesh is not None:
        raise NotImplementedError("sharded training (a mesh) is not ported")
    remat = (tcfg.remat_policy or True) if tcfg.remat else False
    schedule = lr_schedule(tcfg)
    holder = [opt]

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        model = state.params
        if holder[0] is None:
            holder[0] = make_optimizer(model, tcfg)
        o = holder[0]
        if model.cfg != acfg:
            raise ValueError("the state's model was built for another "
                             "AuroraConfig")
        loss, ntok = aurora_forward(
            model, batch["input_ids"], batch.get("pixel_values"),
            attention_mask=batch.get("attention_mask"),
            labels=batch["labels"], kept_ratio=tcfg.kept_ratio,
            mode="loss", remat=remat, segment_ids=batch.get("segment_ids"))
        params = o.params(model)
        live = [p for p in params if p.requires_grad]
        got = (torch.autograd.grad(loss, live, allow_unused=True)
               if live and loss.requires_grad else [None] * len(live))
        found = dict(zip(map(id, live), got))
        grads = [found.get(id(p)) for p in params]
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        gnorm = _global_norm(grads)
        o.update(grads, state.opt_state, model, gnorm)
        metrics = {"loss": loss.detach(), "ntokens": ntok,
                   "grad_norm": gnorm,
                   "lr": schedule(state.step // max(tcfg.grad_accum, 1))}
        state.step += 1
        return state, metrics

    return step_fn
