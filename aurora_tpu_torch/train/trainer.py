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
the model itself. Its forward and backward run under `repeatable_step`
(SDPA's math backend, deterministic algorithms), so that a step repeats
bit for bit on the card. Sums of squares for the norms run in fp32 (optax sums
in the leaf dtype; the same for fp32 parameters). The (Q)LoRA steps
(train/lora.py, train/quant.py) take `lora_optimizer`: the reference's
`optax.chain(clip_by_global_norm(grad_clip), adamw(lr_schedule))` over
the adapters, with optax.adamw's defaults (betas 0.9 / 0.999, weight
decay 1e-4, not the config's) and no MultiSteps (grad_accum is ignored).

On a mesh (parallel/mesh.py; `make_train_step(mesh=)` with the state of
`init_train_state(shard_model(...))`) the step is the same step: each
rank runs its rows of the global batch and its block of the fused
sequence (`aurora_forward(seq_shard=)`, the attention of `sp_mode` through
`_build_sp_attn`) with its part of the model; the loss sum and the token
count are summed over the ranks, so the loss is the global batch's; each
shard's gradient is summed over its replicas (dp, sp; over fsdp by the
all-gather's transpose); the grad norm is the global one, each element
counted once over fsdp and tp; the optimizer updates the local shards.
`sp_mode` is None (a mesh with sp > 1 then raises), "ulysses", "ring" or
"hybrid" (`hybrid_ulysses` ranks of Ulysses inside each ring step);
packed batches (segment ids) take the llama3 ring (`heads_k_stride`).
`ring_layout` "zigzag" and "stripe" are refused in the step (see
`_build_sp_attn`); they run in parallel/ring.py and hybrid.py on
sequences reordered beforehand.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.deterministic
from torch.nn.attention import sdpa_kernel

from aurora_tpu_torch.models.aurora import (AuroraConfig, AuroraModel,
                                            aurora_forward)
from aurora_tpu_torch.ops.attention import TRAINING_SDPA
from aurora_tpu_torch.parallel.mesh import ShardedModel

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
    # explicit SP attention for the LLM: None | 'ulysses' | 'ring' |
    # 'hybrid' (with a mesh passed to make_train_step)
    sp_mode: Optional[str] = None
    hybrid_ulysses: int = 1
    # ring options: 'contiguous' | 'zigzag' | 'stripe'; heads_k_stride
    # bounds the llama3 varlen ring's all-gather (0: all KV heads at once)
    ring_layout: str = "contiguous"
    heads_k_stride: int = 0

    def __post_init__(self):
        if self.sp_mode not in (None, "ulysses", "ring", "hybrid"):
            raise ValueError(f"unknown sp_mode {self.sp_mode!r}")
        if self.ring_layout not in ("contiguous", "zigzag", "stripe"):
            raise ValueError(f"unknown ring_layout {self.ring_layout!r}")
        if self.hybrid_ulysses < 1 or self.heads_k_stride < 0:
            raise ValueError("hybrid_ulysses >= 1 and heads_k_stride >= 0")


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


@contextlib.contextmanager
def repeatable_step():
    """Run a train step's forward and backward so that it repeats bit for
    bit on the card, as the reference's step does (an exact resume needs
    it): SDPA narrowed to TRAINING_SDPA (ops/attention.py; the ViT's
    attention follows), and torch's deterministic algorithms (warn only,
    uninitialized memory not filled), which make the embedding
    backward's index_put accumulate without atomic adds. The previous
    settings come back on exit."""
    det = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with sdpa_kernel(TRAINING_SDPA):
            yield
    finally:
        torch.use_deterministic_algorithms(det, warn_only=warn)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def _frozen(cfg: TrainConfig) -> Dict[str, bool]:
    return {"llm": cfg.freeze_llm,
            "visual_encoder": cfg.freeze_visual_encoder,
            "projector": cfg.freeze_projector}


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t.float().square().sum() for t in tensors),
                          torch.zeros(())))


class Optimizer:
    """clip_by_global_norm → AdamW over the trainable parameters, inside
    MultiSteps when grad_accum > 1 (see the module docstring).

    With a model, the parameters are the model's not frozen by `cfg`
    (looked up by name at each call); with model=None, the callers pass
    the list of tensors itself. weight_decay and betas default to the
    config's; accumulate=False ignores grad_accum."""

    def __init__(self, model: Optional[AuroraModel], cfg: TrainConfig, *,
                 weight_decay: Optional[float] = None,
                 betas: Optional[Tuple[float, float]] = None,
                 accumulate: bool = True):
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)
        self.weight_decay = (cfg.weight_decay if weight_decay is None
                             else weight_decay)
        self.betas = cfg.betas if betas is None else betas
        self.grad_accum = cfg.grad_accum if accumulate else 1
        self.names = None
        if model is not None:
            frozen = _frozen(cfg)
            self.names = [n for n, _ in model.named_parameters()
                          if not frozen.get(n.split(".")[0], False)]

    def params(self, model) -> List[torch.Tensor]:
        """The parameters in this optimizer's order: a model's trainable
        ones by name, or the list given."""
        if self.names is None or isinstance(model, list):
            return list(model)
        named = dict(model.named_parameters())
        return [named[n] for n in self.names]

    def init(self, model) -> Dict[str, Any]:
        ps = self.params(model)
        state = {"count": 0, "mu": [torch.zeros_like(p) for p in ps],
                 "nu": [torch.zeros_like(p) for p in ps]}
        if self.grad_accum > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc=[torch.zeros_like(p) for p in ps])
        return state

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               model, gnorm: Optional[torch.Tensor] = None,
               norm=None) -> None:
        """Apply one step's gradients (in self.params order) in place.
        gnorm: their global norm, where the caller has it already; with
        grad_accum > 1 the clip takes the norm of the window's mean.
        norm: the global norm of a list of gradients (default
        `_global_norm`; a mesh's `ShardedModel.grad_norm`)."""
        k = self.grad_accum
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
            gnorm = (norm or _global_norm)(grads)
        self._adamw(grads, gnorm, state, self.params(model))
        if k > 1:
            for acc in state["acc"]:
                acc.zero_()

    def _adamw(self, grads, gnorm, state, params) -> None:
        cfg = self.cfg
        b1, b2 = self.betas
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
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(torch.tensor(step_size, dtype=u.dtype,
                                device=u.device) * u)


def make_optimizer(params: AuroraModel, cfg: TrainConfig) -> Optimizer:
    """Over a model's trainable parameters, or over a ShardedModel's
    local shards (parallel/mesh.py)."""
    if isinstance(params, ShardedModel):
        return Optimizer(None, cfg)
    return Optimizer(params, cfg)


def lora_optimizer(cfg: TrainConfig) -> Optimizer:
    """The (Q)LoRA steps' optimizer over a list of adapter tensors:
    clip_by_global_norm(cfg.grad_clip) → optax.adamw(lr_schedule(cfg))
    with adamw's defaults (weight decay 1e-4, betas 0.9 / 0.999)."""
    return Optimizer(None, cfg, weight_decay=1e-4, betas=(0.9, 0.999),
                     accumulate=False)


def apply_freeze(model: AuroraModel, cfg: TrainConfig) -> AuroraModel:
    """requires_grad_(False) on the modules the config freezes (and True
    on the others), in place."""
    for name, frozen in _frozen(cfg).items():
        getattr(model, name).requires_grad_(not frozen)
    return model


def init_train_state(params, cfg: TrainConfig) -> TrainState:
    """Freeze the configured modules and set up the optimizer state; the
    model becomes the state's params. A ShardedModel (parallel/mesh.py,
    made from a model `apply_freeze` froze) keeps its layout; its
    optimizer state lies over its local shards."""
    if isinstance(params, ShardedModel):
        return TrainState(params=params, step=0, opt_state=Optimizer(
            None, cfg).init(params.params()))
    apply_freeze(params, cfg)
    return TrainState(params=params,
                      opt_state=make_optimizer(params, cfg).init(params),
                      step=0)


_SHARDED_LISTS = ("mu", "nu", "acc")


def shard_state(state: TrainState, mesh) -> TrainState:
    """A one-process TrainState (a fresh one, or one restored from a
    checkpoint) → this rank's state on `mesh`: the model laid out by
    `shard_model`, the optimizer's moments (and MultiSteps' running mean)
    cut as its parameters are."""
    from aurora_tpu_torch.parallel.mesh import shard_model
    plan = shard_model(state.params, mesh)
    o = dict(state.opt_state)
    for key in _SHARDED_LISTS:
        if key in o:
            o[key] = plan.shard(dict(zip(plan.names, o[key])))
    return TrainState(params=plan, opt_state=o, step=state.step)


def gathered_state(state: TrainState) -> Dict[str, Any]:
    """A mesh state → the one-process checkpoint tree (train/checkpoint.py
    `_tree` of a TrainState: the whole model's state dict, the optimizer
    state over the one-process parameter order, the step), on every rank
    (collective): a checkpoint any mesh, or one process, resumes from."""
    plan = state.params
    o = dict(state.opt_state)
    for key in _SHARDED_LISTS:
        if key in o:
            whole = plan.unshard(o[key])
            o[key] = [whole[n] for n in plan.names]
    return {"params": plan.state_dict(), "opt_state": o,
            "step": int(state.step)}


_LAYOUT_FAULT = (
    "ring_layout {layout!r} with sp_mode {mode!r} is refused in the train "
    "step: the step keeps sequences in their natural order, and the zigzag "
    "and stripe rings expect a sequence reordered by zigzag_split / "
    "stripe_split first. The reference's train step runs them on "
    "sequences it does not reorder, and its attention is wrong there (max "
    "abs 1.70 for zigzag, 3.27 for stripe against plain attention; "
    "ROADMAP queue 3). The layouts run in parallel.ring.ring_mha / "
    "parallel.hybrid.hybrid_mha on inputs split beforehand")


def _build_sp_attn(tcfg: TrainConfig, mesh):
    """Ulysses / ring / hybrid attention over the mesh's sp axis,
    sp_attn(q, k, v, segment_ids, scale) on this rank's blocks (the
    reference's splice, aurora_tpu/train/trainer.py:110-159; the model's
    attention scale passed through, where the reference's takes D^-0.5);
    None without sp_mode or a mesh. Packed batches (segment ids) take the llama3 ring under "ring"
    and "hybrid". A non-contiguous ring_layout raises when the attention
    runs: ValueError for a packed batch (the reference's check),
    NotImplementedError otherwise (`_LAYOUT_FAULT`)."""
    if tcfg.sp_mode is None or mesh is None:
        return None
    from aurora_tpu_torch.parallel.hybrid import hybrid_attention_local
    from aurora_tpu_torch.parallel.ring import (ring_attention_local,
                                                ring_varlen_local)
    from aurora_tpu_torch.parallel.ulysses import ulysses_attention_local
    axis = mesh.axis("sp")
    mode, layout = tcfg.sp_mode, tcfg.ring_layout

    if mode == "ulysses":
        def sp_attn(q, k, v, segment_ids=None, scale=None):
            return ulysses_attention_local(q, k, v, axis=axis, causal=True,
                                           q_segment_ids=segment_ids,
                                           kv_segment_ids=segment_ids,
                                           scale=scale)
        return sp_attn

    def sp_attn(q, k, v, segment_ids=None, scale=None):
        if layout != "contiguous":
            if segment_ids is not None:
                raise ValueError(
                    "packed varlen batches (segment_ids) require "
                    f"ring_layout='contiguous' — {layout!r} reorders "
                    "tokens and the all-gather-KV varlen ring would "
                    "compute wrong causal masks")
            raise NotImplementedError(_LAYOUT_FAULT.format(layout=layout,
                                                           mode=mode))
        if mode == "hybrid":
            return hybrid_attention_local(
                q, k, v, axis=axis, ulysses=tcfg.hybrid_ulysses, causal=True,
                scale=scale, segment_ids=segment_ids,
                heads_k_stride=tcfg.heads_k_stride)
        if segment_ids is not None:
            return ring_varlen_local(q, k, v, segment_ids, axis=axis,
                                     heads_k_stride=tcfg.heads_k_stride,
                                     scale=scale)
        return ring_attention_local(q, k, v, axis=axis, causal=True,
                                    scale=scale)
    return sp_attn


def loss_and_grads(model, batch, tcfg: TrainConfig, params, mesh=None,
                   sp_attn=None, tp=None, before=None):
    """The forward and backward of a step, under `repeatable_step` →
    (the global batch's mean loss, its token count, the gradients of
    `params` (zeros where one takes no part): this rank's contribution to
    the global mean, not yet summed over ranks). On a mesh the batch is
    this rank's rows and the forward its block of the fused sequence; the
    loss sum and the count are summed over dp × fsdp × sp. before(): run
    inside the autograd region first (a ShardedModel's root gather)."""
    from aurora_tpu_torch.parallel.collectives import all_reduce_
    from aurora_tpu_torch.parallel.mesh import seq_shard
    if mesh is not None and mesh.cfg.sp > 1 and sp_attn is None:
        raise ValueError(f"a mesh with sp={mesh.cfg.sp} needs "
                         "TrainConfig.sp_mode ('ulysses', 'ring' or "
                         "'hybrid')")
    remat = (tcfg.remat_policy or True) if tcfg.remat else False
    live = [p for p in params if p.requires_grad]
    with repeatable_step():
        if before is not None:
            before()
        loss_sum, ntok = aurora_forward(
            model, batch["input_ids"], batch.get("pixel_values"),
            attention_mask=batch.get("attention_mask"),
            labels=batch["labels"], kept_ratio=tcfg.kept_ratio,
            mode="loss_sum", remat=remat,
            segment_ids=batch.get("segment_ids"), sp_attn=sp_attn,
            seq_shard=None if mesh is None else seq_shard(mesh), tp=tp)
        n_all, loss = ntok.detach().clone(), loss_sum.detach().float()
        if mesh is not None:
            data = mesh.axis(("dp", "fsdp", "sp"))
            n_all = all_reduce_(n_all, data)
            loss = all_reduce_(loss.clone(), data)
        denom = n_all.clamp_min(1)
        got = (torch.autograd.grad(loss_sum / denom, live,
                                   allow_unused=True)
               if live and loss_sum.requires_grad else [None] * len(live))
    found = dict(zip(map(id, live), got))
    grads = [found.get(id(p)) for p in params]
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    return loss / denom, n_all, grads


class _Whole:
    """A model on one process as the step sees a ShardedModel: its
    trainable parameters whole, nothing to gather, sum or cut."""

    tp = None

    def __init__(self, model, params: List[torch.Tensor]):
        self.model = model
        self._params = params

    def params(self) -> List[torch.Tensor]:
        return self._params

    def gather_root(self) -> None:
        pass

    def release(self) -> None:
        pass

    def reduce_grads(self, grads):
        return grads

    def grad_norm(self, grads) -> torch.Tensor:
        return _global_norm(grads)


def make_train_step(acfg: AuroraConfig, tcfg: TrainConfig,
                    opt: Optional[Optimizer] = None, mesh=None):
    """Returns step(state, batch) → (state, metrics).

    batch: input_ids [B, T], labels [B, T], optional attention_mask [B, T]
    and pixel_values [B, F, C, H, W] (text-only batches skip the ViT).
    metrics (0-d tensors but lr): loss, ntokens, grad_norm (the global
    norm of all gradients, before clipping) and lr at step // grad_accum.
    mesh (parallel/mesh.py): the state's params are a ShardedModel laid
    out on it and the batch this rank's rows (`local_rows`); one process
    runs the same step on the whole model (`_Whole`).
    """
    sp_attn = _build_sp_attn(tcfg, mesh)
    schedule = lr_schedule(tcfg)
    holder = [opt]

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        plan = state.params
        if mesh is None:
            if isinstance(plan, ShardedModel) or plan.cfg != acfg:
                raise ValueError("the state's model was built for another "
                                 "AuroraConfig (or laid out on a mesh)")
        elif not isinstance(plan, ShardedModel) or plan.mesh is not mesh:
            raise ValueError("on a mesh the state's params are the "
                             "ShardedModel shard_model made on it")
        elif plan.global_cfg != acfg:
            raise ValueError("the state's model was built for another "
                             "AuroraConfig")
        if holder[0] is None:
            holder[0] = make_optimizer(plan, tcfg)
        o = holder[0]
        if mesh is None:
            plan = _Whole(plan, o.params(plan))
        params = plan.params()
        try:
            loss, ntok, grads = loss_and_grads(
                plan.model, batch, tcfg, params, mesh, sp_attn, plan.tp,
                before=plan.gather_root)
        finally:
            plan.release()
        grads = plan.reduce_grads(grads)
        gnorm = plan.grad_norm(grads)
        o.update(grads, state.opt_state, params, gnorm, norm=plan.grad_norm)
        metrics = {"loss": loss, "ntokens": ntok, "grad_norm": gnorm,
                   "lr": schedule(state.step // max(tcfg.grad_accum, 1))}
        state.step += 1
        return state, metrics

    return step_fn
