"""AuroraCap's 3-stage training curriculum as dataclass configs (a copy of
aurora_tpu/train/configs.py over the port's TrainConfig):
  * pretrain ("projection"): LLM and ViT frozen, the projector trained,
    batch 16, lr 2e-4, kept ratio 1.0;
  * vision: ViT and projector trained, ToMe kept ratio 0.1, slowfast,
    batch 1 × grad_accum 24, lr 1e-4;
  * language: everything trained, lr 2e-5, batch 4.
Overridable with dataclasses.replace, or from a copy-cfg JSON through the
train CLI's --config (cli/cfg_tools.py).
"""

from __future__ import annotations

import dataclasses

from aurora_tpu_torch.models.aurora import AuroraConfig
from aurora_tpu_torch.train.trainer import TrainConfig


@dataclasses.dataclass(frozen=True)
class StageConfig:
    name: str
    train: TrainConfig
    batch_size: int
    max_length: int = 4096
    image_size: int = 378
    slowfast: bool = False


def pretrain_stage(max_steps: int = 1000) -> StageConfig:
    return StageConfig(
        name="projection_stage",
        train=TrainConfig(lr=2e-4, weight_decay=0.0, warmup_ratio=0.03,
                          max_steps=max_steps, grad_clip=1.0,
                          freeze_llm=True, freeze_visual_encoder=True,
                          kept_ratio=1.0),
        batch_size=16)


def vision_stage(max_steps: int = 1000) -> StageConfig:
    return StageConfig(
        name="vision_stage",
        train=TrainConfig(lr=1e-4, warmup_ratio=0.03, max_steps=max_steps,
                          grad_clip=1.0, grad_accum=24,
                          freeze_llm=True, kept_ratio=0.1),
        batch_size=1, slowfast=True)


def language_stage(max_steps: int = 1000,
                   kept_ratio: float = 0.1) -> StageConfig:
    return StageConfig(
        name="language_stage",
        train=TrainConfig(lr=2e-5, warmup_ratio=0.03, max_steps=max_steps,
                          grad_clip=1.0, kept_ratio=kept_ratio),
        batch_size=4)


STAGES = {"pretrain": pretrain_stage, "vision": vision_stage,
          "language": language_stage}


def auroracap_7b_model() -> AuroraConfig:
    return AuroraConfig.auroracap_7b()
