"""Unified entry point, the `xtuner MODE ...` dispatcher
(aurora_tpu/__main__.py).

    python -m aurora_tpu_torch MODE [MODE_ARGS...]

`infer`, `serve`, `chat`, `bench-latency` and `bench-serving` are ported;
every other mode of the reference exits non-zero with the ROADMAP item
that will port it.
"""

from __future__ import annotations

import importlib
import sys

_TRAINING = "queue 1 item 7 (the rest of training)"
_EVAL = "queue 1 item 10 (the eval adapter)"
_NOT_PORTED = {
    "train": _TRAINING, "preprocess": _TRAINING, "list-cfg": _TRAINING,
    "copy-cfg": _TRAINING, "log-dataset": _TRAINING,
    "check-custom-dataset": _TRAINING,
    "test": _EVAL, "eval": _EVAL, "post-eval": _EVAL, "mmbench": _EVAL,
    "convert": "queue 1 item 12 (the converters' export half)",
    "bench-kernels": "queue 1, not to port (aurora_tpu_torch/tools/"
                     "time_ragged.py and time_weights.py time the kernels)",
}


# mode → the module under aurora_tpu_torch.cli whose main(argv) runs it
_PORTED = {"infer": "infer", "serve": "serve", "chat": "chat",
           "bench-latency": "bench_latency", "bench-serving": "bench_serving"}


def _help() -> str:
    return ("usage: python -m aurora_tpu_torch MODE [ARGS...]\n"
            f"  ported modes: {', '.join(_PORTED)}\n"
            f"  not ported yet: {', '.join(sorted(_NOT_PORTED))}\n"
            "  example:\n"
            "    python -m aurora_tpu_torch infer --model_path M "
            "--visual_input v.npy\n")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_help())
        return 0
    mode, rest = argv[0], argv[1:]
    if mode in _PORTED:
        module = importlib.import_module("aurora_tpu_torch.cli."
                                         + _PORTED[mode])
        return module.main(rest) or 0
    if mode in _NOT_PORTED:
        print(f"mode {mode!r} is not ported yet: ROADMAP.md "
              f"{_NOT_PORTED[mode]}", file=sys.stderr)
        return 2
    print(f"unknown mode {mode!r}\n\n{_help()}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
