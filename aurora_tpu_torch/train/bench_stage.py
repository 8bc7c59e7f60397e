"""bench.py's training stage (bench.py:834-856) on the port: its model,
train config and batch, shared by chip_smoke.py's `[train]` and
`[train-parity]` phases and tools/profile_train.py.

Vicuna-7B widths (hidden 4096, intermediate 11008, 32 heads of 128,
vocab 32000) at a cut depth, with the stage's tiny frozen ViT and
projector (the batch is text-only), random weights from a seed; batch 4
× seq 2048 of ids in [10, 30000) from `np.random.default_rng(seed)`,
labels = ids. The batch carries no attention_mask, the one case in
which the reference's step runs its flash kernel (ROADMAP queue 3); for
full-length rows it is the same function as the stage's all-true mask.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from aurora_tpu_torch.models.aurora import AuroraConfig, init_aurora
from aurora_tpu_torch.models.llama import LlamaConfig
from aurora_tpu_torch.models.projector import ProjectorConfig
from aurora_tpu_torch.models.vit import ViTConfig
from aurora_tpu_torch.train.trainer import TrainConfig

BATCH, SEQ, LAYERS = 4, 2048, 4


def aurora_config(layers: int = LAYERS,
                  llm: Optional[LlamaConfig] = None) -> AuroraConfig:
    """The stage's AuroraConfig; `llm` (default Vicuna-7B-v1.5-16k) is
    cut to `layers`."""
    llm = dataclasses.replace(llm or LlamaConfig.vicuna_7b_v15_16k(),
                              num_hidden_layers=layers)
    vit = ViTConfig(hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    image_size=56, patch_size=14)
    return AuroraConfig(vit=vit, llm=llm, projector=ProjectorConfig(
        visual_hidden_size=32, llm_hidden_size=llm.hidden_size, depth=2))


def init_model(cfg: AuroraConfig, device, seed: int,
               dtype=torch.bfloat16):
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_aurora(cfg, device=device, dtype=dtype, generator=gen)


def train_config(remat=True, remat_policy: Optional[str] = None
                 ) -> TrainConfig:
    return TrainConfig(remat=remat, remat_policy=remat_policy,
                       freeze_visual_encoder=True, freeze_projector=True,
                       max_steps=100)


def text_batch(cfg: AuroraConfig, device, seed: int = 5,
               seq: int = SEQ) -> Dict[str, torch.Tensor]:
    ids = np.random.default_rng(seed).integers(
        10, min(30000, cfg.llm.vocab_size), size=(BATCH, seq))
    t = torch.from_numpy(ids).to(device)
    return {"input_ids": t, "labels": t}
