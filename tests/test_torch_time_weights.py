"""aurora_tpu_torch/tools/time_weights.py runs only on a GPU: without one it
exits 1 and prints no timing."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "aurora_tpu_torch", "tools", "time_weights.py")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU exit")
def test_time_weights_refuses_without_a_card(tmp_path):
    res = subprocess.run([sys.executable, SCRIPT, "--tree", ROOT],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert res.returncode == 1
    assert "CUDA is not available" in res.stderr
    assert "[kernels]" not in res.stdout
    assert "[weights]" not in res.stdout
