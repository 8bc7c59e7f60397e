"""The port's models (aurora_tpu/models/): the universal dense decoder
(llama.py), Gemma-2 (gemma2.py), the CLIP tower (vit.py), the projector
and AuroraCap's composite (aurora.py)."""

from aurora_tpu_torch.models.gemma2 import (Gemma2Config, gemma2_apply,
                                            init_gemma2)
from aurora_tpu_torch.models.llama import (LlamaConfig, llama_apply,
                                           llama_lm_loss)

__all__ = ["LlamaConfig", "llama_apply", "llama_lm_loss", "Gemma2Config",
           "gemma2_apply", "init_gemma2"]
