"""Checkpoint save and resume (aurora_tpu/train/checkpoint.py) on
torch.save / torch.load(weights_only=True).

The reference's behaviour is kept:
  * one directory per step under `ckpt_dir` (`<ckpt_dir>/<step>/`);
  * `max_keep=2`: after a save, only the newest two steps stay;
  * a step at or below the newest saved one is not saved again (orbax's
    `should_save`), so the train loop's final save after an interval save
    of the same step writes nothing;
  * the whole state is saved: a TrainState as its model's state dict (the
    frozen modules included), its optimizer state and its step; any
    other state (the (Q)LoRA {"adapters", "opt_state"}) as the nested
    dicts and lists of tensors and numbers it is.
A write is atomic: the step's directory is written under a temporary name
in `ckpt_dir` and then renamed with os.replace.

`restore_checkpoint` copies the saved values into the target's tensors in
place (the model keeps its identity and device) and returns the target.
The port reads only its own checkpoints, not the reference's orbax
directories; checkpoint directories are local paths.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

from aurora_tpu_torch.train.trainer import TrainState
from aurora_tpu_torch.utils.fileio import is_remote

_STATE_FILE = "state.pt"


def _local(ckpt_dir: str) -> str:
    if is_remote(ckpt_dir):
        raise NotImplementedError(f"{ckpt_dir}: the port writes and reads "
                                  "checkpoints in local directories only")
    return os.path.abspath(ckpt_dir)


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit()
                  and os.path.exists(os.path.join(ckpt_dir, n, _STATE_FILE)))


def _tree(state) -> Any:
    if isinstance(state, TrainState):
        return {"params": state.params.state_dict(),
                "opt_state": state.opt_state, "step": int(state.step)}
    return state


def save_checkpoint(ckpt_dir: str, state, step: int,
                    max_keep: int = 2) -> bool:
    """Save `state` as step `step`; False (nothing written) when a step at
    or past it is saved already."""
    ckpt_dir = _local(ckpt_dir)
    steps = _steps(ckpt_dir)
    if steps and step <= steps[-1]:
        return False
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_tree(state), os.path.join(tmp, _STATE_FILE))
    os.replace(tmp, os.path.join(ckpt_dir, str(step)))
    for old in (steps + [step])[:-max_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)
    return True


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(_local(ckpt_dir))
    return steps[-1] if steps else None


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(_local(ckpt_dir), str(step), _STATE_FILE)


def _assign(target, saved, where: str):
    """Copy `saved` into `target`'s tensors; the new value for numbers."""
    if isinstance(target, torch.Tensor):
        if target.shape != saved.shape or target.dtype != saved.dtype:
            raise ValueError(f"{where}: saved {saved.dtype} "
                             f"{tuple(saved.shape)} does not fit "
                             f"{target.dtype} {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(saved)
        return target
    if isinstance(target, dict):
        if set(target) != set(saved):
            raise ValueError(f"{where}: saved keys {sorted(saved)} != "
                             f"{sorted(target)}")
        for k in target:
            target[k] = _assign(target[k], saved[k], f"{where}/{k}")
        return target
    if isinstance(target, list):
        if len(target) != len(saved):
            raise ValueError(f"{where}: {len(saved)} saved entries for "
                             f"{len(target)}")
        for i in range(len(target)):
            target[i] = _assign(target[i], saved[i], f"{where}/{i}")
        return target
    return saved


def restore_checkpoint(ckpt_dir: str, target, step: Optional[int] = None):
    """Load step `step` (default the latest) into `target`, a TrainState
    or a tree of the saved structure, in place; returns the target."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    saved = torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu",
                       weights_only=True, mmap=True)
    if isinstance(target, TrainState):
        target.params.load_state_dict(saved["params"], strict=True)
        _assign(target.opt_state, saved["opt_state"], "opt_state")
        target.step = int(saved["step"])
        return target
    return _assign(target, saved, "state")
