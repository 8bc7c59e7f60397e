"""Remote-storage file IO (a copy of aurora_tpu/utils/fileio.py).

Byte IO for datasets, annotation json and media goes through a small
scheme-keyed backend registry: local paths through `open`, `gs://`,
`s3://` and any other fsspec protocol through fsspec, which is imported
only when such a path is first used (neither machine the port runs on
needs it for local files). `register_backend()` adds any other store.
Checkpoints (train/checkpoint.py) are written with torch.save to local
directories; `normalize_ckpt_dir` and `is_remote` keep remote URIs
verbatim.
"""

from __future__ import annotations

import io
import os
import re
from typing import Dict, List

_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")


def scheme_of(path: str) -> str:
    m = _SCHEME_RE.match(str(path))
    return m.group(1) if m else "file"


def is_remote(path: str) -> bool:
    return scheme_of(path) not in ("file",)


def normalize_ckpt_dir(path: str) -> str:
    """abspath for local dirs, remote URIs verbatim."""
    return str(path) if is_remote(path) else os.path.abspath(path)


class LocalBackend:
    def get(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def put(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> List[str]:
        return sorted(os.listdir(path))


class FsspecBackend:
    """gs:// (gcsfs) / s3:// (s3fs) / any fsspec-registered protocol."""

    def __init__(self, scheme: str):
        try:
            import fsspec
        except ImportError as e:  # pragma: no cover - env without fsspec
            raise ImportError(
                f"remote path scheme {scheme}://... needs fsspec (+ the "
                f"protocol's driver, e.g. gcsfs for gs://)") from e
        self.fs = fsspec.filesystem(scheme)

    def get(self, path: str) -> bytes:
        with self.fs.open(path, "rb") as f:
            return f.read()

    def put(self, path: str, data: bytes) -> None:
        with self.fs.open(path, "wb") as f:
            f.write(data)

    def exists(self, path: str) -> bool:
        return self.fs.exists(path)

    def listdir(self, path: str) -> List[str]:
        return sorted(self.fs.ls(path))


_BACKENDS: Dict[str, object] = {"file": LocalBackend()}


def register_backend(scheme: str, backend) -> None:
    _BACKENDS[scheme] = backend


def get_backend(path: str):
    s = scheme_of(path)
    if s not in _BACKENDS:
        _BACKENDS[s] = FsspecBackend(s)
    return _BACKENDS[s]


def read_bytes(path: str) -> bytes:
    return get_backend(path).get(str(path))


def read_text(path: str, encoding: str = "utf-8") -> str:
    return read_bytes(path).decode(encoding)


def write_bytes(path: str, data: bytes) -> None:
    get_backend(path).put(str(path), data)


def exists(path: str) -> bool:
    return get_backend(path).exists(str(path))


def open_file(path: str, mode: str = "rb"):
    """File-like handle for local OR remote paths. Remote writes are
    buffered and flushed on close."""
    if not is_remote(path):
        return open(path, mode)
    if "r" in mode:
        raw = read_bytes(path)
        return io.BytesIO(raw) if "b" in mode else io.StringIO(
            raw.decode("utf-8"))
    backend = get_backend(path)

    if "b" not in mode:  # text write: encode on close
        class _WT(io.StringIO):
            def close(self_w):
                if not self_w.closed:  # idempotent like real files
                    backend.put(str(path),
                                self_w.getvalue().encode("utf-8"))
                super().close()

        return _WT()

    class _W(io.BytesIO):
        def close(self_w):
            if not self_w.closed:  # idempotent like real files
                backend.put(str(path), self_w.getvalue())
            super().close()

    return _W()
