"""Device half of the CLIP image pipeline (aurora_tpu/data/preprocess.py).

Only `clip_normalize_device` is ported: serving receives frames that are
already resized and center-cropped to the tower's resolution as uint8.
The PIL half of the reference module is not needed on the GPU host.
"""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize_device(frames: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] uint8 → [N, 3, H, W] float32 on the frames' device:
    rescale by 1/255, then normalize with the OpenAI CLIP mean/std."""
    x = frames.to(torch.float32) / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)
