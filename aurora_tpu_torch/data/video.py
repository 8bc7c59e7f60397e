"""Host-side video frame loading (aurora_tpu/data/video.py).

Frame sampling is the reference's: linspace over min(total, num_frm)
indices PLUS the last frame whenever linspace missed it (the "+last frame"
quirk, so callers may receive num_frm+1 frames).

Decode backends, tried in order:
  * a directory of frame images (sorted lexically; PIL, imported when
    used);
  * `.npy`/`.npz` files holding [T, H, W, 3] uint8 arrays;
  * PyAV when importable (mp4 via stream decode, webm/mkv via full packet
    decode);
  * imageio when importable.

Every backend library is imported only when its backend is used, so the
module imports on a host that has none of them.
"""

from __future__ import annotations

import os

import numpy as np


def sample_frame_indices(total_frames: int, num_frm: int) -> np.ndarray:
    """linspace sampling + always-include-last-frame."""
    sampled = min(total_frames, num_frm)
    indices = np.linspace(0, total_frames - 1, sampled, dtype=int)
    if total_frames - 1 not in indices:
        indices = np.append(indices, total_frames - 1)
    return indices


def _read_av(path: str, num_frm: int) -> np.ndarray:
    import av
    is_packet_format = ("webm" in path) or ("mkv" in path)
    if not is_packet_format:
        try:
            container = av.open(path)
            total = container.streams.video[0].frames
            indices = sample_frame_indices(total, num_frm)
            want = set(int(i) for i in indices)
            frames = []
            for i, frame in enumerate(container.decode(video=0)):
                if i > indices[-1]:
                    break
                if i in want:
                    frames.append(frame)
            return np.stack([f.to_ndarray(format="rgb24") for f in frames])
        except Exception:
            pass
    container = av.open(path)
    frames = []
    for packet in container.demux(video=0):
        for frame in packet.decode():
            frames.append(frame)
    indices = sample_frame_indices(len(frames), num_frm)
    return np.stack(
        [frames[i].to_ndarray(format="rgb24") for i in indices])


def _read_imageio(path: str, num_frm: int) -> np.ndarray:
    import imageio.v3 as iio
    frames = iio.imread(path, plugin="pyav")  # [T, H, W, 3]
    indices = sample_frame_indices(frames.shape[0], num_frm)
    return frames[indices]


def _read_npy(path: str, num_frm: int) -> np.ndarray:
    arr = np.load(path)
    if isinstance(arr, np.lib.npyio.NpzFile):
        arr = arr[list(arr.keys())[0]]
    indices = sample_frame_indices(arr.shape[0], num_frm)
    return arr[indices]


def _read_frame_dir(path: str, num_frm: int) -> np.ndarray:
    from PIL import Image
    files = sorted(
        f for f in os.listdir(path)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    indices = sample_frame_indices(len(files), num_frm)
    frames = [np.asarray(Image.open(os.path.join(path, files[i]))
                         .convert("RGB")) for i in indices]
    return np.stack(frames)


def read_video(path: str, num_frm: int = 8) -> np.ndarray:
    """→ [F, H, W, 3] uint8 rgb frames (F may be num_frm+1, see module doc)."""
    if os.path.isdir(path):
        return _read_frame_dir(path, num_frm)
    if path.endswith((".npy", ".npz")):
        return _read_npy(path, num_frm)
    try:
        import av  # noqa: F401
        return _read_av(path, num_frm)
    except ImportError:
        pass
    try:
        import imageio  # noqa: F401
        return _read_imageio(path, num_frm)
    except ImportError:
        pass
    raise RuntimeError(
        f"no video backend available for {path!r}: install av/imageio, or "
        "provide .npy frames / a frame directory")
