"""Build and load the port's hand-written CUDA kernels.

Every `*.cu` under `aurora_tpu_torch/csrc/` is compiled by its own `nvcc`
for sm_90a (all sources at once, in parallel), and the objects are linked
into one shared library with a plain C interface, loaded with ctypes. The
library lands in `build/kernels/` at the repository root, named by a hash
of the sources (the shared `*.cuh` headers included) and flags, so a
changed source rebuilds and an unchanged one loads the existing build.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu, every pointer and the stream as c_void_p
SIGNATURES = {
    # ragged attention: ..., scale, window, cap, 1/cap[, kv_maxq,
    # 1/kv_maxq], stream; extend: ..., Hkv, L, B, S, head_dim, scale, ...;
    # decode: ..., head_dim, split, nsplit, scale, ...
    "aurora_ragged_extend_bf16":
        [_P] * 8 + [_I] * 8 + [_F, _I, _F, _F, _P],
    "aurora_ragged_decode_bf16":
        [_P] * 11 + [_I] * 8 + [_F, _I, _F, _F, _P],
    "aurora_ragged_extend_int8":
        [_P] * 10 + [_I] * 8 + [_F, _I, _F, _F, _P],
    "aurora_ragged_decode_int8":
        [_P] * 13 + [_I] * 8 + [_F, _I] + [_F] * 4 + [_P],
    "aurora_ragged_extend_int4":
        [_P] * 10 + [_I] * 8 + [_F, _I, _F, _F, _P],
    "aurora_ragged_decode_int4":
        [_P] * 13 + [_I] * 8 + [_F, _I] + [_F] * 4 + [_P],
    # weight streamers: ..., part, tickets, B, K, N[, G], span, nsplit,
    # flags, stream
    "aurora_w4a16_matmul":
        [_P] * 6 + [_I] * 8 + [_P],
    "aurora_w4a8_matmul":
        [_P] * 9 + [_I] * 8 + [_P],
    "aurora_w4a8_flat_matmul":
        [_P] * 9 + [_I] * 8 + [_P],
    # ..., part, out, B, D, I, G, Gd, ti, flags, stream
    "aurora_fused_mlp_w4":
        [_P] * 10 + [_I] * 8 + [_P],
    "aurora_w8a8_matmul":
        [_P] * 7 + [_I] * 6 + [_P],
    # rows[, group], then the kernel, int* shared bytes, int* blocks an SM
    "aurora_w8a8_kernel":
        [_I, _P, _P, _P],
    "aurora_w4a16_kernel":
        [_I, _I, _P, _P, _P],
    "aurora_w4a8_kernel":
        [_I, _I, _P, _P, _P],
    "aurora_w4a8_flat_kernel":
        [_I, _I, _P, _P, _P],
    # B, D, ti, Ib, group, down group, int* cluster size, int* channels
    "aurora_fused_mlp_cluster":
        [_I] * 6 + [_P, _P],
    "aurora_quantize_rows":
        [_P] * 3 + [_I] * 3 + [_P],
    "aurora_flash_fwd":
        [_P] * 7 + [_I] * 7 + [_F, _P],
    "aurora_flash_bwd_dkv":
        [_P] * 10 + [_I] * 7 + [_F, _P],
    "aurora_flash_bwd_dq":
        [_P] * 9 + [_I] * 7 + [_F, _P],
    # name, then int* registers, local (spill) bytes, shared bytes
    "aurora_kernel_attrs":
        [ctypes.c_char_p, _P, _P, _P],
}

_lib = None
build_seconds = 0.0   # wall time of the last compile in this process


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libaurora_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every (source, Popen) pair; raise on the first failure."""
    errors = []
    for src, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} ({proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
    if errors:
        raise RuntimeError("\n".join(errors))


def _build(out: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        _run(procs)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run([("link", subprocess.Popen(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def load_library() -> ctypes.CDLL:
    """Compile (when the sources changed) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        t0 = time.perf_counter()
        _build(out)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def kernel_attrs(name: str) -> dict:
    """Registers a thread, local (spill) bytes a thread and shared bytes a
    block of one kernel of the library, by the name that
    `aurora_kernel_attrs` knows (e.g. "flash_fwd", "ragged_extend_int8",
    "ragged_decode_bf16_g4", "w8a8_b64")."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = load_library().aurora_kernel_attrs(
        name.encode(), *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"aurora_kernel_attrs({name!r}) failed "
                           f"(cudaError {err})")
    return dict(zip(("regs", "local_bytes", "smem"), (v.value for v in vals)))
