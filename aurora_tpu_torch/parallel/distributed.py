"""Multi-process start-up (aurora_tpu/parallel/distributed.py).

The reference connects every host's runtime with one
`jax.distributed.initialize` call and builds one mesh over all devices.
The port runs one process per rank, as torch does: `torchrun` (or any
launcher that exports its variables) starts them, and
`init_distributed` joins them into one `torch.distributed` process group.

Environment (torchrun's): MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and
LOCAL_RANK. A single process (no WORLD_SIZE, or WORLD_SIZE 1) returns
False, so every entry point can call it unconditionally.

Device: the card unless the caller passes device_type="cpu". With no
card visible the default raises, in a single process too: a rank never
carries on on the CPU on its own.

Backend: NCCL for ranks on distinct cards, gloo on the CPU. NCCL refuses
two ranks on one card, so when a host starts more ranks than it has
cards `init_distributed` raises unless gloo was asked for by name; it
never switches backend on its own. Each CUDA rank takes card LOCAL_RANK
modulo the card count (with gloo, several ranks may share one card).

As in the reference (:73-82): when the environment asks for several
processes and the group cannot be formed, this raises. It never falls
back to a single-process run, which would train every rank on the same
rows at 1/N of the global batch and let them overwrite each other's
checkpoints.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: cuda:(LOCAL_RANK mod the card count), or the
    CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def require_card(device_type: str, what: str) -> None:
    """Raise when device_type is "cuda" and no card is visible: the ranks
    never carry on on the CPU unless the caller asks for it."""
    if device_type == "cuda" and torch.cuda.device_count() == 0:
        raise RuntimeError(f"{what}: device_type 'cuda' but no card is "
                           "visible; pass device_type='cpu' to run on the "
                           "CPU")


def init_distributed(backend: Optional[str] = None,
                     device_type: str = "cuda", log=print) -> bool:
    """Join the process group the environment describes; True when this
    is a multi-process run (also when it was joined already).

    device_type: "cuda" (the default; raises when no card is visible) or
    "cpu". backend: None picks NCCL for "cuda" and gloo for "cpu"; "gloo"
    on "cuda" lets several ranks share a card (the collectives then copy
    through host memory, parallel/collectives.py)."""
    require_card(device_type, "init_distributed")
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    rank_ = int(os.environ.get("RANK", "0"))
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if addr is None or port is None:
        raise RuntimeError(
            f"WORLD_SIZE={world} asks for {world} processes, but "
            "MASTER_ADDR / MASTER_PORT are not set (start the ranks with "
            "torchrun); refusing to run as a single process")
    if device_type == "cuda":
        n_cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and local_world > n_cards:
            raise RuntimeError(
                f"{local_world} ranks on a host with {n_cards} card(s): NCCL "
                "takes one rank a card; pass backend='gloo' to share a card")
        torch.cuda.set_device(rank_device("cuda"))
    try:
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                world_size=world, rank=rank_)
    except Exception as e:  # noqa: BLE001 — re-raised below, never swallowed
        log(f"[distributed] init_process_group failed ({e})")
        raise RuntimeError(
            f"multi-process launch requested (WORLD_SIZE={world}, rank "
            f"{rank_}, {addr}:{port}) but the process group could not be "
            "formed; refusing to fall back to a single-process run") from e
    log(f"[distributed] rank {rank_}/{world}, backend {backend}, "
        f"device {rank_device(device_type)}")
    return True
