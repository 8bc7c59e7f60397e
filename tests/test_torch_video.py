"""The front of the port's serving path against the JAX package's.

`aurora_tpu_torch.data.video` (frame sampling, the `.npy` / `.npz` and
frame-directory backends, the error where no backend applies) against
`aurora_tpu.data.video`: identical arrays. `clip_resize_crop_device` of
`aurora_tpu_torch.data.preprocess` (F.interpolate bicubic with antialias)
against the JAX one (jax.image.resize) at the frame sizes of the bench's
videos and of common portrait and landscape clips: equal shapes, at most
one level apart on the 0-255 scale; and against the PIL host path
`clip_resize_crop` on smooth frames within the contract of
tests/test_data.py.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from aurora_tpu.data import preprocess as jpre
from aurora_tpu.data import video as jvideo
from aurora_tpu_torch.data import preprocess as tpre
from aurora_tpu_torch.data import video as tvideo


def test_sample_frame_indices_match_jax():
    for total in range(1, 41):
        for num_frm in range(1, 17):
            np.testing.assert_array_equal(
                tvideo.sample_frame_indices(total, num_frm),
                jvideo.sample_frame_indices(total, num_frm),
                err_msg=f"{total}/{num_frm}")
    # the "+last frame" quirk: one frame of ten is frame 0, and the last comes
    # with it
    assert len(tvideo.sample_frame_indices(10, 1)) == 2


@pytest.mark.parametrize("kind", ["npy", "npz", "frames"])
def test_read_video_matches_jax(kind, tmp_path):
    rng = np.random.default_rng(["npy", "npz", "frames"].index(kind))
    arr = rng.integers(0, 256, size=(13, 24, 40, 3), dtype=np.uint8)
    if kind == "npy":
        path = str(tmp_path / "clip.npy")
        np.save(path, arr)
    elif kind == "npz":
        path = str(tmp_path / "clip.npz")
        np.savez(path, frames=arr)
    else:
        path = str(tmp_path / "frames")
        os.makedirs(path)
        for i, frame in enumerate(arr):
            Image.fromarray(frame).save(os.path.join(path, f"{i:03d}.png"))
        with open(os.path.join(path, "notes.txt"), "w") as f:
            f.write("not a frame")
    for num_frm in (1, 4, 8, 13, 20):
        got = tvideo.read_video(path, num_frm)
        want = jvideo.read_video(path, num_frm)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{kind}/{num_frm}")
    np.testing.assert_array_equal(tvideo.read_video(path, 4),
                                  arr[[0, 4, 8, 12]])


def test_read_video_without_a_backend_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "av", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    path = str(tmp_path / "clip.mp4")
    for read in (tvideo.read_video, jvideo.read_video):
        with pytest.raises(RuntimeError, match="no video backend"):
            read(path, 8)


def _smooth(H, W):
    """A smooth synthetic frame (tests/test_data.py's): any two bicubic
    resamplers differ by more on white noise."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frame = np.stack([127 + 120 * np.sin(xx / 23.0) * np.cos(yy / 17.0),
                      127 + 110 * np.cos(xx / 31.0 + 1.0),
                      127 + 100 * np.sin((xx + yy) / 41.0)], axis=-1)
    return np.clip(np.round(frame), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(360, 640), (480, 854), (640, 360),
                                   (378, 672)])
def test_clip_resize_crop_device_matches_jax_and_pil(shape):
    H, W = shape
    rng = np.random.default_rng(H + W)
    noise = rng.integers(0, 256, size=(1, H, W, 3), dtype=np.uint8)
    frames = np.concatenate([noise, _smooth(H, W)[None]])
    got = tpre.clip_resize_crop_device(torch.as_tensor(frames))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 378, 378, 3)
    got = got.numpy()
    np.testing.assert_array_equal(got, np.round(got))
    assert got.min() >= 0 and got.max() <= 255
    want = np.asarray(jpre.clip_resize_crop_device(jnp.asarray(frames)))
    assert want.shape == got.shape
    # both resample in fp32 with the Keys cubic; after rounding at most one
    # level apart (a value near .5 may round either way)
    assert np.abs(got - want).max() <= 1.0
    if min(H, W) == 378:      # no resample: exactly the crop
        np.testing.assert_array_equal(got, frames[:, :, 147:147 + 378])
    host = jpre.clip_resize_crop(list(frames[1:])).astype(np.float32)
    diff = np.abs(got[1:] - host)
    assert diff.max() <= 2.0 and diff.mean() <= 0.5, (diff.max(), diff.mean())
    # the serving caller casts to uint8 for the request: the same bytes
    assert np.array_equal(got.astype(np.uint8).astype(np.float32), got)
