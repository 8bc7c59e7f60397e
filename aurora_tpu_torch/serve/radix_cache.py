"""Radix prefix cache over KV slots (aurora_tpu/serve/radix_cache.py).

A radix tree keyed by token ids whose nodes own KV slot arrays:
match_prefix reuses the longest cached prefix, insert dedups a finished
request's tokens, LRU eviction reclaims unlocked leaves, lock_ref pins
paths while requests run. Host-side pure Python; the C++ twin in
aurora_tpu_torch/native/radix_tree.cc is the engine's default tree
(serve/engine.py `make_radix`).
"""

from __future__ import annotations

import heapq
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("children", "parent", "key", "slots", "lock_ref",
                 "last_access")

    def __init__(self, parent=None, key=None, slots=None):
        self.children: Dict[int, "_Node"] = {}  # first-token → child
        self.parent = parent
        self.key: List[int] = key or []
        self.slots: Optional[np.ndarray] = slots
        self.lock_ref = 0
        self.last_access = time.monotonic()

    def __lt__(self, other):
        return self.last_access < other.last_access


def _shared_len(a: List[int], b: List[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class RadixCache:
    def __init__(self, free_slots: Optional[Callable] = None):
        """free_slots(slots) is called when eviction releases KV slots."""
        self.root = _Node()
        self.root.lock_ref = 1
        self._free_slots = free_slots or (lambda s: None)
        self.evictable_size = 0

    # -- lookup ------------------------------------------------------------

    def match_prefix(self, token_ids) -> Tuple[np.ndarray, "_Node"]:
        """Longest cached prefix → (slot array, last node on the path)."""
        token_ids = [int(t) for t in token_ids]
        slots: List[np.ndarray] = []
        node = self.root
        key = token_ids
        while key:
            child = node.children.get(key[0])
            if child is None:
                break
            n = _shared_len(child.key, key)
            child.last_access = time.monotonic()
            if n < len(child.key):
                child = self._split(child, n)
                slots.append(child.slots)
                node = child
                break
            slots.append(child.slots)
            node = child
            key = key[n:]
        if slots:
            return np.concatenate(slots), node
        return np.empty((0,), np.int32), node

    # -- insert ------------------------------------------------------------

    def insert(self, token_ids, slots: np.ndarray) -> int:
        """Cache `token_ids` → `slots`. Returns the number of PREFIX tokens
        that were already cached (whose fresh slots the caller must free —
        radix_cache.py cache_req dedup semantics)."""
        token_ids = [int(t) for t in token_ids]
        slots = np.asarray(slots, np.int32)
        assert len(token_ids) == len(slots)
        return self._insert(self.root, token_ids, slots)

    def _insert(self, node: _Node, key: List[int],
                slots: np.ndarray) -> int:
        node.last_access = time.monotonic()
        if not key:
            return 0
        child = node.children.get(key[0])
        if child is None:
            new = _Node(parent=node, key=list(key), slots=slots.copy())
            node.children[key[0]] = new
            self.evictable_size += len(key)
            return 0
        n = _shared_len(child.key, key)
        if n < len(child.key):
            child = self._split(child, n)
        return n + self._insert(child, key[n:], slots[n:])

    def _split(self, child: _Node, n: int) -> _Node:
        """Split child at prefix length n → returns upper node."""
        upper = _Node(parent=child.parent, key=child.key[:n],
                      slots=child.slots[:n])
        upper.lock_ref = child.lock_ref
        upper.children = {child.key[n]: child}
        child.parent.children[child.key[0]] = upper
        child.parent = upper
        child.key = child.key[n:]
        child.slots = child.slots[n:]
        upper.last_access = child.last_access
        return upper

    # -- locking (pin paths while in use) -----------------------------------

    def lock(self, node: _Node, delta: int) -> None:
        while node is not None and node is not self.root:
            if node.lock_ref == 0 and delta > 0:
                self.evictable_size -= len(node.key)
            node.lock_ref += delta
            if node.lock_ref == 0 and delta < 0:
                self.evictable_size += len(node.key)
            assert node.lock_ref >= 0
            node = node.parent

    # -- eviction ------------------------------------------------------------

    def evict(self, num_tokens: int) -> int:
        """LRU-evict ≥ num_tokens unlocked leaf tokens; returns evicted
        count. Slots go back through free_slots."""
        leaves = [n for n in self._all_nodes()
                  if not n.children and n.lock_ref == 0]
        heapq.heapify(leaves)
        freed = 0
        while leaves and freed < num_tokens:
            node = heapq.heappop(leaves)
            if node.children or node.lock_ref > 0 or node is self.root:
                continue
            self._free_slots(node.slots)
            freed += len(node.key)
            self.evictable_size -= len(node.key)
            parent = node.parent
            del parent.children[node.key[0]]
            if (parent is not self.root and not parent.children
                    and parent.lock_ref == 0):
                heapq.heappush(leaves, parent)
        return freed

    def _all_nodes(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def total_cached_tokens(self) -> int:
        return sum(len(n.key) for n in self._all_nodes()
                   if n is not self.root)


class NullPrefixCache:
    """Prefix caching DISABLED (sglang --disable-radix-cache →
    src/sglang/python/sglang/srt/mem_cache/chunk_cache.py:1-83): every
    request prefills from scratch; nothing is inserted, matched, locked,
    or evicted. The `disable` attribute mirrors ChunkCache's — the
    engine's finish path checks it and skips the prompt-KV copy into the
    pool entirely (the reference's ChunkCache entries exist to resume
    chunked prefill, which this engine tracks on the Request instead,
    so a pure passthrough is the complete equivalent)."""

    disable = True

    def __init__(self, free_slots: Optional[Callable] = None):
        self.root = _Node()
        self.root.lock_ref = 1
        self.evictable_size = 0

    def match_prefix(self, token_ids) -> Tuple[np.ndarray, "_Node"]:
        return np.empty((0,), np.int32), self.root

    def insert(self, token_ids, slots: np.ndarray) -> int:
        raise NotImplementedError(
            "radix cache disabled: the engine must not cache prompt KV")

    def lock(self, node: "_Node", delta: int) -> None:
        pass

    def evict(self, num_tokens: int) -> int:
        return 0

    def total_cached_tokens(self) -> int:
        return 0
