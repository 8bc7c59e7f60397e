"""The C++ radix tree of the serving control plane, loaded with ctypes
(aurora_tpu/native/__init__.py).

`radix_tree.cc` beside this file is compiled with g++ on first use into
`build/native/` at the repository root, named by a hash of the source, so
a changed source rebuilds and an unchanged one loads the existing build.
The build writes a temporary file and renames it, so processes that build
at the same time do not see a partial library. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "radix_tree.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libradix_tree_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                              str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} "
                               f"({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def load_library() -> ctypes.CDLL:
    """Compile (when the source changed) and load the tree's library."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        _build(out)
    lib = ctypes.CDLL(str(out))
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    for name, restype, argtypes in (
            ("rt_new", P, []),
            ("rt_delete", None, [P]),
            ("rt_match", I64, [P, P, I64, P, I64, ctypes.POINTER(P)]),
            ("rt_insert", I64, [P, P, P, I64]),
            ("rt_lock", None, [P, P, I64]),
            ("rt_evict", I64, [P, I64, P, I64]),
            ("rt_total_cached", I64, [P]),
            ("rt_evictable", I64, [P])):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


class NativeRadixCache:
    """serve/radix_cache.py's RadixCache backed by the C++ tree. Node
    handles are opaque pointers (ints on the Python side); the root is
    None, and lock(None, d) does nothing, as lock(root, d) does there."""

    def __init__(self, free_slots=None):
        self._lib = load_library()
        self._h = self._lib.rt_new()
        self._free_slots = free_slots or (lambda s: None)
        self.root = None

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rt_delete(self._h)
            self._h = None

    @property
    def evictable_size(self) -> int:
        return int(self._lib.rt_evictable(self._h))

    def match_prefix(self, token_ids) -> Tuple[np.ndarray, int]:
        toks = np.ascontiguousarray(token_ids, np.int64)
        out = np.empty(max(len(toks), 1), np.int32)
        node = ctypes.c_void_p()
        n = self._lib.rt_match(self._h, toks.ctypes.data, len(toks),
                               out.ctypes.data, len(out), ctypes.byref(node))
        return out[:n].copy(), node.value

    def insert(self, token_ids, slots) -> int:
        toks = np.ascontiguousarray(token_ids, np.int64)
        sl = np.ascontiguousarray(slots, np.int32)
        if len(toks) != len(sl):
            raise ValueError(f"{len(toks)} tokens but {len(sl)} slots")
        return int(self._lib.rt_insert(self._h, toks.ctypes.data,
                                       sl.ctypes.data, len(toks)))

    def lock(self, node, delta: int) -> None:
        if node:
            self._lib.rt_lock(self._h, ctypes.c_void_p(node), delta)

    def evict(self, num_tokens: int) -> int:
        # eviction stops at node boundaries, so it may free more than asked
        out = np.empty(num_tokens + 65536, np.int32)
        n = self._lib.rt_evict(self._h, num_tokens, out.ctypes.data,
                               len(out))
        if n:
            self._free_slots(out[:n].copy())
        return int(n)

    def total_cached_tokens(self) -> int:
        return int(self._lib.rt_total_cached(self._h))
