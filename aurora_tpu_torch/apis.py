"""Programmatic builders, the `xtuner.apis` analog (aurora_tpu/apis.py).

    from aurora_tpu_torch import apis
    model, cfg, tok = apis.build_model("path/to/auroracap")
    rt = apis.build_runtime(model_path="path/to/llm")    # offline batches

The serving builders are ported. LoRA, the dataset and the trainer's
stage assembly are not: their builders raise NotImplementedError naming
their ROADMAP item (the training step itself is train/trainer.py's).
"""

from __future__ import annotations

from typing import Optional

import torch

_TRAINING = "ROADMAP.md queue 1 item 7 (the rest of training)"


def build_model(model_path: str, dtype=None, device="cuda"):
    """xtuner-format AuroraCap (or llava-hf) directory → (AuroraModel,
    AuroraConfig, tokenizer), on the card unless `device` says
    otherwise."""
    from aurora_tpu_torch.cli.infer import load_model
    return load_model(model_path, dtype=dtype or torch.bfloat16,
                      device=device)


def build_lora_model(model_path: str, **kwargs):
    raise NotImplementedError(f"(Q)LoRA is not ported yet: {_TRAINING}")


def build_dataset(data_path: str, tokenizer, **kwargs):
    raise NotImplementedError(f"the training dataset is not ported yet: "
                              f"{_TRAINING}")


def build_trainer(params, acfg, **kwargs):
    raise NotImplementedError(f"the stage configs and trainer assembly are "
                              f"not ported yet: {_TRAINING}")


def build_runtime(model=None, cfg=None, tokenizer=None, *,
                  model_path: Optional[str] = None, engine_config=None,
                  dtype=None, device=None):
    """Offline batch generation over the serving engine (serve/runtime.py,
    sglang.Runtime's analog)."""
    from aurora_tpu_torch.serve.runtime import Runtime
    return Runtime(model, cfg, tokenizer, model_path=model_path,
                   engine_config=engine_config, dtype=dtype, device=device)
