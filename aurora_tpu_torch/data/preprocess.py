"""Device half of the CLIP image pipeline (aurora_tpu/data/preprocess.py).

`clip_resize_crop_device` takes decoded frames ([N, H, W, 3] uint8, as
data/video.py reads them) to the tower's resolution on the frames'
device: shortest-edge bicubic resize, center crop, rounding to uint8
levels. `clip_normalize_device` then rescales and normalizes them. The
PIL half of the reference module is not needed on the GPU host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_resize_crop_device(frames: torch.Tensor, size: int = 378,
                            crop: int = 378) -> torch.Tensor:
    """[N, H, W, 3] uint8 → [N, crop, crop, 3] uint8-valued float32 on the
    frames' device.

    The short edge is resized to `size` and the long edge to int(size ·
    long / short) (truncated, as PIL's shortest-edge resize does) with the
    Keys cubic (a = -0.5) and, on a downscale, its support scaled by the
    factor: `F.interpolate(mode="bicubic", antialias=True)`, PIL's BICUBIC
    and jax.image.resize's "bicubic" with antialias=True. Frames whose
    short edge is already `size` skip the resample. Then a center crop,
    and rounding and clamping to 0..255, as PIL's uint8 output does."""
    N, H, W, C = frames.shape
    x = frames.to(torch.float32)
    if min(H, W) == size:
        nh, nw = H, W
    else:
        if H <= W:
            nh, nw = size, int(size * W / H)
        else:
            nh, nw = int(size * H / W), size
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw),
                          mode="bicubic", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    top, left = (nh - crop) // 2, (nw - crop) // 2
    x = x[:, top:top + crop, left:left + crop]
    return torch.clamp(torch.round(x), 0.0, 255.0)


def clip_normalize_device(frames: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] uint8 → [N, 3, H, W] float32 on the frames' device:
    rescale by 1/255, then normalize with the OpenAI CLIP mean/std."""
    x = frames.to(torch.float32) / 255.0
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)
