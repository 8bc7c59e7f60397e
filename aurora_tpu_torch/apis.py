"""Programmatic builders, the `xtuner.apis` analog (aurora_tpu/apis.py).

    from aurora_tpu_torch import apis
    model, cfg, tok = apis.build_model("path/to/auroracap")
    ds = apis.build_dataset("data.json", tok, image_folder="imgs/")
    step, state, stage = apis.build_trainer(model, cfg, stage="pretrain")
    rt = apis.build_runtime(model_path="path/to/llm")    # offline batches

Every builder builds on the card unless `device` says otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def build_model(model_path: str, dtype=None, device="cuda"):
    """xtuner-format AuroraCap (or llava-hf) directory → (AuroraModel,
    AuroraConfig, tokenizer), on the card unless `device` says
    otherwise."""
    from aurora_tpu_torch.cli.infer import load_model
    return load_model(model_path, dtype=dtype or torch.bfloat16,
                      device=device)


def build_lora_model(model_path: str, *, r: int = 64, alpha: int = 16,
                     quant: str = "none", dtype=None, seed: int = 0,
                     device="cuda"):
    """(Q)LoRA assembly: a frozen (optionally int8/int4) base and adapters
    with B = 0 (A from a generator seeded with `seed` on `device`).
    Returns (base model, adapters, AuroraConfig, LoraConfig, tokenizer)."""
    from aurora_tpu_torch.train.lora import LoraConfig, init_lora_params
    from aurora_tpu_torch.train.quant import quantize_base
    if quant not in ("none", "int8", "int4"):
        raise ValueError(f"quant={quant!r}: expected 'none', 'int8' or "
                         "'int4' (an unknown value must not silently "
                         "4-bit-quantize the base)")
    model, cfg, tok = build_model(model_path, dtype, device)
    lcfg = LoraConfig(r=r, alpha=alpha)
    gen = torch.Generator(device=device).manual_seed(seed)
    adapters = init_lora_params(gen, model, lcfg)
    if quant != "none":
        quantize_base(model, bits=8 if quant == "int8" else 4)
    return model, adapters, cfg, lcfg, tok


def build_dataset(data_path: str, tokenizer, *, image_folder: str = "",
                  max_length: int = 2048, image_size: int = 378,
                  template=None, cache_dir: Optional[str] = None,
                  device="cuda"):
    """llava-format json/jsonl → AuroraDataset, frames made on `device`."""
    from aurora_tpu_torch.data.dataset import AuroraDataset, aurora_map_fn
    from aurora_tpu_torch.utils.templates import PROMPT_TEMPLATE
    return AuroraDataset(data_path, tokenizer,
                         image_folder=image_folder,
                         map_fn=aurora_map_fn,
                         template=template or PROMPT_TEMPLATE.vicuna,
                         max_length=max_length, image_size=image_size,
                         cache_dir=cache_dir, device=device)


def build_trainer(params, acfg, *, stage: str = "pretrain",
                  max_steps: Optional[int] = None, mesh=None):
    """Stage config + optimizer + step + initial state over the model
    `params` (its frozen modules frozen). Returns (step_fn, state,
    stage_config); step_fn(state, batch) → (state, metrics)."""
    from aurora_tpu_torch.train.configs import STAGES
    from aurora_tpu_torch.train.trainer import (init_train_state,
                                                make_optimizer,
                                                make_train_step)
    stage_cfg = STAGES[stage]()
    tcfg = stage_cfg.train
    if max_steps is not None:
        tcfg = dataclasses.replace(tcfg, max_steps=max_steps)
        stage_cfg = dataclasses.replace(stage_cfg, train=tcfg)
    opt = make_optimizer(params, tcfg)
    state = init_train_state(params, tcfg)
    step_fn = make_train_step(acfg, tcfg, opt, mesh=mesh)
    return step_fn, state, stage_cfg


def build_runtime(model=None, cfg=None, tokenizer=None, *,
                  model_path: Optional[str] = None, engine_config=None,
                  dtype=None, device=None):
    """Offline batch generation over the serving engine (serve/runtime.py,
    sglang.Runtime's analog)."""
    from aurora_tpu_torch.serve.runtime import Runtime
    return Runtime(model, cfg, tokenizer, model_path=model_path,
                   engine_config=engine_config, dtype=dtype, device=device)
