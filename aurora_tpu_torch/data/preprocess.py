"""The CLIP image pipeline on the frames' device
(aurora_tpu/data/preprocess.py).

`clip_resize_crop_device` takes decoded frames ([N, H, W, 3] uint8, as
data/video.py reads them) to the tower's resolution on the frames'
device: shortest-edge bicubic resize, center crop, rounding to uint8
levels. `clip_normalize_device` then rescales and normalizes them. The
training dataset's two other geometries, `expand2square` and
`keep_aspect_preprocess`, are the reference's PIL paths in torch. The
card's host has no PIL: each resize is PIL's BICUBIC (see
`clip_resize_crop_device`), held to PIL within 2 levels per channel on
smooth images (tests/test_torch_data.py); padding and cropping are
exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
PATCH_SIZE = 14
# expand2square's background: the CLIP mean in uint8 levels
CLIP_MEAN_FILL = tuple(int(x * 255) for x in CLIP_MEAN)


def _bicubic(x: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """[N, H, W, C] float → [N, nh, nw, C]: PIL's BICUBIC resample."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw),
                         mode="bicubic", align_corners=False,
                         antialias=True).permute(0, 2, 3, 1)


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
        x = _bicubic(x, nh, nw)
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


def expand2square(frame: torch.Tensor,
                  fill=CLIP_MEAN_FILL) -> torch.Tensor:
    """[H, W, C] → [S, S, C], S = max(H, W): the frame centered (offsets
    rounded down) on a `fill` background, as the reference's PIL paste."""
    h, w = frame.shape[:2]
    if h == w:
        return frame
    side = max(h, w)
    out = torch.empty((side, side) + tuple(frame.shape[2:]),
                      dtype=frame.dtype, device=frame.device)
    out[:] = torch.tensor(fill, dtype=frame.dtype, device=frame.device)
    top, left = (side - h) // 2, (side - w) // 2
    out[top:top + h, left:left + w] = frame
    return out


def keep_aspect_preprocess(frame: torch.Tensor, shortest_edge: int = 378,
                           pad_to_square: bool = False) -> torch.Tensor:
    """The training dataset's keep-aspect path: [H, W, 3] uint8 → [3, H',
    W'] float32 normalized on the frame's device. Optionally expand2square
    first; then a bicubic resize by shortest_edge / min(H, W), zero pad at
    the bottom and right to multiples of PATCH_SIZE, normalize.

    The reference's quirk is kept (aurora_tpu/data/preprocess.py
    keep_aspect_preprocess): it reads PIL's (width, height) as (h, w), so
    a non-square image is resampled to the transposed aspect: H rows and W
    columns become int(W·s) rows and int(H·s) columns. A resize to the
    frame's own size is skipped, as PIL's is."""
    if pad_to_square:
        frame = expand2square(frame)
    h, w = frame.shape[:2]
    scale = shortest_edge / min(w, h)
    new_h, new_w = int(w * scale), int(h * scale)      # sic, see above
    x = frame.to(torch.float32)[None]
    if (new_h, new_w) != (h, w):
        x = torch.clamp(torch.round(_bicubic(x, new_h, new_w)), 0.0, 255.0)
    pad_h = (PATCH_SIZE - new_h % PATCH_SIZE) % PATCH_SIZE
    pad_w = (PATCH_SIZE - new_w % PATCH_SIZE) % PATCH_SIZE
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    return clip_normalize_device(x)[0]
