"""aurora_tpu_torch — PyTorch/CUDA port of aurora_tpu for one NVIDIA H100.

The module tree mirrors `aurora_tpu/`, so each module's reference twin
sits at the same relative path. This package imports torch and numpy
only: never `jax`, and nothing from `aurora_tpu` (whose serve package
pulls in the JAX engine at import time).

The slice ported so far is AuroraCap-7B caption serving with bf16
weights and bf16 KV: uint8 frames → CLIP normalize → ViT-H/14 with ToMe
→ projector → multimodal fusion → batched extend → multi-step decode
through `serve.engine.ServeEngine`. The two serving attention kernels
(`ops/pallas/ragged_attention.py`) are hand-written CUDA C++ for sm_90a
under `csrc/`, built on first use (`ops/cuda_build.py`).
"""

__all__ = ["bridge", "data", "generate", "models", "ops", "serve", "utils"]
