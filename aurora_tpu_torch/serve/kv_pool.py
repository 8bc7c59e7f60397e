"""Token-granular KV pool of the radix prefix cache
(aurora_tpu/serve/kv_pool.py).

One flat device buffer of KV slots per layer plus a host-side free-list
allocator. A slot is one token's K and V in every layer: k/v [L,
num_slots, Hkv, hd]. The radix tree maps token prefixes to slot arrays;
the engine copies a hit's slots into a request's KV row at admission and
a finished prompt's row positions into fresh slots at release
(serve/engine.py `_load_prefix` / `_store_prompt`).

int8 and int4 KV store int8 values beside fp32 per-token scale planes
ks/vs [L, num_slots, Hkv]. The int4 pool stays token-granular, as the
reference's does: its slots hold the 16-level grid values in an int8
container, and the rows pack and unpack at the pool boundary.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from aurora_tpu_torch.models.llama import LlamaConfig


class SlotAllocator:
    """Host free list over KV slots."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self._free = list(range(num_slots - 1, -1, -1))

    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[np.ndarray]:
        """n slots, or None when fewer than n are free."""
        if n > len(self._free):
            return None
        return np.asarray([self._free.pop() for _ in range(n)], np.int32)

    def free(self, slots) -> None:
        self._free.extend(int(s) for s in np.asarray(slots).reshape(-1))
        if len(self._free) > self.num_slots:
            raise RuntimeError("double free of KV slots")


class KVPool:
    """Device KV slot buffers: {"k", "v"} [L, num_slots, Hkv, hd] in
    `dtype`, or int8 with fp32 {"ks", "vs"} [L, num_slots, Hkv] when
    quant is set (int8 and int4 KV)."""

    def __init__(self, cfg: LlamaConfig, num_slots: int,
                 dtype=torch.bfloat16, quant: bool = False, device=None):
        if getattr(cfg, "mla_kv_lora_rank", None):
            raise NotImplementedError("MLA's latent KV pool is not ported")
        self.cfg = cfg
        self.num_slots = num_slots
        self.quant = quant
        shape = (cfg.num_hidden_layers, num_slots, cfg.num_key_value_heads,
                 cfg.head_dim)
        store = torch.int8 if quant else dtype
        self.planes: Dict[str, torch.Tensor] = {
            name: torch.zeros(shape, dtype=store, device=device)
            for name in ("k", "v")}
        if quant:
            for name in ("ks", "vs"):
                self.planes[name] = torch.zeros(shape[:3],
                                                dtype=torch.float32,
                                                device=device)

    def hbm_bytes(self) -> int:
        """Device bytes of the pool, scale planes included."""
        return sum(t.numel() * t.element_size()
                   for t in self.planes.values())
