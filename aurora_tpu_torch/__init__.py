"""aurora_tpu_torch — PyTorch/CUDA port of aurora_tpu for one NVIDIA H100.

The module tree mirrors `aurora_tpu/`, so each module's reference twin
sits at the same relative path. This package imports torch and numpy
only: never `jax`, and nothing from `aurora_tpu` (whose serve package
pulls in the JAX engine at import time).

Ported so far: AuroraCap-7B caption serving (uint8 frames → CLIP
normalize → ViT-H/14 with ToMe → projector → multimodal fusion → batched
extend → multi-step decode through `serve.engine.ServeEngine`) with bf16
weights and KV or W4 weights and int8 KV, and the training step
(`train.trainer.make_train_step` over `models.aurora.aurora_forward`),
and the user entry points: checkpoint loading from an xtuner or llava-hf
directory (`models.convert`), the inference.py caption path
(`python -m aurora_tpu_torch infer`, `cli.infer`; greedy, sampled and
beam generation in `generate/`) and the in-process `serve.runtime.Runtime`
with stop strings.
Every kernel is hand-written CUDA C++ for sm_90a under `csrc/` (the
ragged extend and decode attention, the W4A8 matmul, flash attention
forward and backward), built on first use (`ops/cuda_build.py`).
"""

__all__ = ["apis", "bridge", "cli", "data", "generate", "models", "ops",
           "serve", "train", "utils"]
