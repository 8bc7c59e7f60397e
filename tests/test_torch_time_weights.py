"""aurora_tpu_torch/tools/time_weights.py runs only on a GPU: without one it
exits 1 and prints no timing. Its --rows option parses before that."""

import importlib.util
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


def _tool():
    spec = importlib.util.spec_from_file_location("time_weights", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_time_weights_parses_its_rows():
    """--rows: distinct counts in 1..64, bench.py's batch of 28 among
    them; anything else is refused."""
    tool = _tool()
    assert tool.parse_rows("1,8,16,28,64") == (1, 8, 16, 28, 64)
    assert tool.parse_rows("4") == (4,)
    for bad in ("", "0", "65", "4,4", "4,x", "-1"):
        with pytest.raises(Exception, match="--rows takes"):
            tool.parse_rows(bad)


def test_time_weights_with_rows_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU exit")
    res = subprocess.run([sys.executable, SCRIPT, "--rows", "1,8,16,28,64"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert res.returncode == 1
    assert "CUDA is not available" in res.stderr
    assert "[kernels]" not in res.stdout
    bad = subprocess.run([sys.executable, SCRIPT, "--rows", "0,65"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert bad.returncode == 2 and "--rows takes" in bad.stderr
