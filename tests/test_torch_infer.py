"""The port's caption path (aurora_tpu_torch/cli/infer.py) against the JAX
package's, on a tiny random xtuner-format directory, fp32 on the CPU.

`caption` must give JAX's text on the same normalized frames: a 2-frame
video and one image, greedy and with 2 beams. `main` must print the
port's caption of the frames that its own device path makes from a
`.npy` video (and from a `.png` image), with --device cpu. The module
entry `python -m aurora_tpu_torch infer --help` exits 0; an unported
mode exits non-zero and names its ROADMAP item.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.cli import infer as jinfer
from aurora_tpu_torch.cli import infer as tinfer
from aurora_tpu_torch.data.video import read_video

from utils import make_tiny_xtuner_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEPT = 0.5
PROMPT = "Describe the video in detail."


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = make_tiny_xtuner_dir(tmp_path_factory.mktemp("xtuner"))[0]
    return (root, jinfer.load_model(root, dtype=jnp.float32),
            tinfer.load_model(root, dtype=torch.float32, device="cpu"))


def _frames(n, seed=0, h=64, w=80):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("n_frames", [2, 1], ids=["video", "image"])
@pytest.mark.parametrize("num_beams", [1, 2])
def test_caption_matches_jax(models, n_frames, num_beams):
    _, (jp, jc, jtok), (tm, tc, ttok) = models
    px = tinfer.preprocess_frames(_frames(n_frames), 56, "cpu").numpy()
    kw = dict(prompt=PROMPT, token_kept_ratio=KEPT, max_new_tokens=8,
              num_beams=num_beams, image_size=56)
    want = jinfer.caption(jp, jc, jtok, pixel_values=px, **kw)
    got = tinfer.caption(tm, tc, ttok, pixel_values=torch.from_numpy(px),
                         **kw)
    assert got == want


@pytest.mark.parametrize("kind", ["npy", "png"])
def test_main_prints_the_caption(models, tmp_path, capsys, kind):
    root, _, (tm, tc, ttok) = models
    if kind == "npy":
        path = str(tmp_path / "v.npy")
        np.save(path, _frames(4, seed=1))
        frames = read_video(path, 2)
    else:
        from PIL import Image
        path = str(tmp_path / "i.png")
        frames = _frames(1, seed=2)
        Image.fromarray(frames[0]).save(path)
    tinfer.main(["--model_path", root, "--visual_input", path,
                 "--device", "cpu", "--dtype", "float32", "--num_frm", "2",
                 "--image_size", "56", "--token_kept_ratio", str(KEPT),
                 "--max_new_tokens", "6", "--prompt", PROMPT])
    printed = capsys.readouterr().out
    want = tinfer.caption(tm, tc, ttok, pixel_values=tinfer.preprocess_frames(
        frames, 56, "cpu"), prompt=PROMPT, token_kept_ratio=KEPT,
        max_new_tokens=6, image_size=56)
    assert printed == want + "\n"


def _module(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "aurora_tpu_torch", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)


def test_module_entry_infer_help():
    res = _module("infer", "--help")
    assert res.returncode == 0, res.stderr
    assert "--visual_input" in res.stdout and "--device" in res.stdout


def test_module_entry_unported_mode_fails():
    res = _module("bench-kernels")
    assert res.returncode == 2
    assert "not ported yet" in res.stderr and "ROADMAP" in res.stderr
