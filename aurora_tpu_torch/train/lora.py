"""LoRA adapters over a frozen AuroraCap base (aurora_tpu/train/lora.py).

Adapters are a dict {module name: {"a": A [in, r], "b": B [r, out]}}
keyed by the port's module names (`llm.layers.3.q`), one entry per layer
and target (the reference stacks them [L, in, r] / [L, r, out];
`bridge.lora_adapters_from` unstacks its trees). A and B are in the
reference's [in, out] orientation, so W' = W + (alpha/r)·A@B is its
formula. Training forms W' per projection inside the layer
(`LoraLinear`, installed in place of each target `nn.Linear` by
`apply_lora`), differentiates with respect to the adapters only, and
updates them with `trainer.lora_optimizer`: the base stays frozen and
outside the optimizer. `merge_lora` folds the adapters into the base
weights for export.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

import torch
from torch import nn

from aurora_tpu_torch.models.aurora import AuroraModel
from aurora_tpu_torch.parallel.collectives import all_reduce_list
from aurora_tpu_torch.train.trainer import (_build_sp_attn, _global_norm,
                                            loss_and_grads)

Adapters = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 64
    alpha: int = 16
    # regexes over module names; the default hits every projection of the
    # LLM's layers (the reference's find_all_linear_names behaviour)
    target_patterns: Tuple[str, ...] = (
        r"llm\.layers\.\d+\.(q|k|v|o|gate|up|down)$",)

    @property
    def scale(self) -> float:
        return self.alpha / self.r


class LoraLinear(nn.Module):
    """A frozen nn.Linear plus an adapter: y = h @ W' with
    W' = (W^T + scale · A@B) computed in fp32 and cast to W's dtype, as
    the reference's merge_lora."""

    def __init__(self, base: nn.Linear, a: torch.Tensor, b: torch.Tensor,
                 scale: float):
        super().__init__()
        self.base, self.a, self.b, self.scale = base, a, b, scale

    def merged(self) -> torch.Tensor:
        """W' [in, out]."""
        w = self.base.weight
        delta = self.a.float() @ self.b.float()
        return (w.t().float() + self.scale * delta).to(w.dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.merged()


def _is_target(module: nn.Module) -> bool:
    from aurora_tpu_torch.train.quant import QuantLinear
    return isinstance(module, (nn.Linear, LoraLinear, QuantLinear))


def lora_target_paths(model: nn.Module, cfg: LoraConfig) -> List[str]:
    """Names of the projections the patterns select, in module order."""
    return [name for name, m in model.named_modules()
            if _is_target(m) and any(re.search(p, name)
                                     for p in cfg.target_patterns)]


def _in_out(module: nn.Module) -> Tuple[int, int, torch.dtype]:
    if isinstance(module, LoraLinear):
        module = module.base
    if isinstance(module, nn.Linear):
        return module.in_features, module.out_features, module.weight.dtype
    return module.in_features, module.out_features, module.dtype


def init_lora_params(generator: torch.Generator, model: nn.Module,
                     cfg: LoraConfig) -> Adapters:
    """Adapters for the matching projections: A ~ N(0, 0.02) from
    `generator`, B = 0 (peft's init: the adapted model starts as the
    base), in the base weight's dtype, on the generator's device."""
    adapters: Adapters = {}
    mods = dict(model.named_modules())
    for path in lora_target_paths(model, cfg):
        n_in, n_out, dtype = _in_out(mods[path])
        a = torch.randn((n_in, cfg.r), generator=generator,
                        device=generator.device, dtype=torch.float32)
        adapters[path] = {
            "a": (a * 0.02).to(dtype).requires_grad_(),
            "b": torch.zeros((cfg.r, n_out), dtype=dtype,
                             device=generator.device).requires_grad_()}
    return adapters


def adapter_tensors(adapters: Adapters) -> List[torch.Tensor]:
    """The optimizer's parameter list: each entry's a, then its b."""
    return [t for ab in adapters.values() for t in (ab["a"], ab["b"])]


def _set(model: nn.Module, path: str, module: nn.Module) -> None:
    parent, _, name = path.rpartition(".")
    setattr(model.get_submodule(parent), name, module)


def apply_lora(model: AuroraModel, adapters: Adapters,
               cfg: LoraConfig) -> AuroraModel:
    """Make each adapted nn.Linear of `model` a LoraLinear over these
    adapters (in place; a LoraLinear already there takes the new
    tensors)."""
    mods = dict(model.named_modules())
    for path, ab in adapters.items():
        m = mods[path]
        if isinstance(m, LoraLinear):
            m.a, m.b, m.scale = ab["a"], ab["b"], cfg.scale
        elif isinstance(m, nn.Linear):
            _set(model, path, LoraLinear(m, ab["a"], ab["b"], cfg.scale))
        else:
            raise TypeError(f"{path} is a {type(m).__name__}: a float "
                            "base's projection is an nn.Linear (a "
                            "quantized base takes train/quant.inject_lora)")
    return model


@torch.no_grad()
def merge_lora(model: AuroraModel, adapters: Adapters,
               cfg: LoraConfig) -> AuroraModel:
    """W' = W + scale·A@B into every adapted projection's weight, in
    place; LoraLinear modules become their (merged) nn.Linear again."""
    mods = dict(model.named_modules())
    for path, ab in adapters.items():
        m = mods[path]
        base = m.base if isinstance(m, LoraLinear) else m
        merged = LoraLinear(base, ab["a"], ab["b"], cfg.scale).merged()
        base.weight.copy_(merged.t())
        if m is not base:
            _set(model, path, base)
    return model


def make_lora_train_step(acfg, tcfg, base_params: AuroraModel,
                         lora_cfg: LoraConfig, opt, mesh=None,
                         attach=apply_lora):
    """step(adapters, opt_state, batch) → (adapters, opt_state, metrics),
    over the adapters only; the base is frozen (requires_grad off) and
    never enters `opt` (`trainer.lora_optimizer`). `step.with_base(...,
    base)` takes the base as an argument, as the reference's does.
    metrics: loss, ntokens, grad_norm (the adapters' gradients' global
    norm, before clipping); no lr, as in the reference. The forward and
    backward run under `trainer.repeatable_step`. attach: how the
    adapters enter the base (`apply_lora`; train/quant.py passes
    `inject_lora`).

    mesh (parallel/mesh.py, dp / fsdp / sp; tp 1): the batch is this
    rank's rows, the sequence is cut over sp with `sp_mode`'s attention
    (`trainer._build_sp_attn`, as the reference's step builds it), and
    the adapters' gradients are summed over the ranks; the base and the
    adapters are whole on every rank."""
    if mesh is not None and mesh.cfg.tp > 1:
        raise NotImplementedError(
            "a (Q)LoRA step on a mesh takes dp, fsdp and sp; tp > 1 "
            "(cutting the base and its adapters) is not ported")
    sp_attn = _build_sp_attn(tcfg, mesh)

    def step_with_base(adapters: Adapters, opt_state, batch,
                       base: AuroraModel):
        base.requires_grad_(False)
        model = attach(base, adapters, lora_cfg)
        params = adapter_tensors(adapters)
        loss, ntok, grads = loss_and_grads(model, batch, tcfg, params, mesh,
                                           sp_attn)
        if mesh is not None:
            grads = all_reduce_list(grads, mesh.axis(("dp", "fsdp", "sp")))
        if attach is not apply_lora:
            attach(base, None, lora_cfg)   # drop this step's graph
        gnorm = _global_norm(grads)
        opt.update(grads, opt_state, params, gnorm)
        return adapters, opt_state, {"loss": loss, "ntokens": ntok,
                                     "grad_norm": gnorm}

    def step(adapters, opt_state, batch):
        return step_with_base(adapters, opt_state, batch, base_params)

    step.with_base = step_with_base
    return step

