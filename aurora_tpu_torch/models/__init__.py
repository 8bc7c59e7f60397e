"""The port's models (aurora_tpu/models/): the universal dense decoder
(llama.py), Gemma-2 (gemma2.py), DeepSeek-V2 (deepseek_v2.py), the CLIP
and SigLIP towers (vit.py), the projector and AuroraCap's composite
(aurora.py), and InternVL: InternViT, the pixel-shuffle projector and a
dense decoder (internvl.py)."""

from aurora_tpu_torch.models.deepseek_v2 import (DeepseekV2Config,
                                                 deepseek_v2_apply,
                                                 init_deepseek_v2)
from aurora_tpu_torch.models.gemma2 import (Gemma2Config, gemma2_apply,
                                            init_gemma2)
from aurora_tpu_torch.models.internvl import (InternVLConfig,
                                              InternViTConfig,
                                              internvit_encode,
                                              internvl_forward)
from aurora_tpu_torch.models.llama import (LlamaConfig, llama_apply,
                                           llama_lm_loss)
from aurora_tpu_torch.models.projector import (Projector, ProjectorConfig,
                                               apply_projector)
from aurora_tpu_torch.models.vit import (VisionTransformer, ViTConfig,
                                         vit_encode)

__all__ = [
    "ViTConfig", "VisionTransformer", "vit_encode",
    "ProjectorConfig", "Projector", "apply_projector",
    "LlamaConfig", "llama_apply", "llama_lm_loss",
    "Gemma2Config", "gemma2_apply", "init_gemma2",
    "DeepseekV2Config", "deepseek_v2_apply", "init_deepseek_v2",
    "InternVLConfig", "InternViTConfig", "internvl_forward",
    "internvit_encode",
]
