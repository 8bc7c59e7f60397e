"""Unified entry point, the `xtuner MODE ...` dispatcher
(aurora_tpu/__main__.py).

    python -m aurora_tpu_torch MODE [MODE_ARGS...]

`train`, `preprocess`, `list-cfg`, `copy-cfg`, `log-dataset`,
`check-custom-dataset`, `infer`, `serve`, `chat`, `convert`,
`bench-latency`, `bench-serving`, `test` and `eval` (the eval CLI),
`post-eval` and `mmbench` are ported; `bench-kernels`, which the port does
not need, exits 2 naming its ROADMAP entry.
"""

from __future__ import annotations

import importlib
import sys

_NOT_PORTED = {
    "bench-kernels": "queue 1, not to port (aurora_tpu_torch/tools/"
                     "time_ragged.py and time_weights.py time the kernels)",
}


# mode → "module" whose main(argv) runs it, or "module:function"
_CFG_TOOLS = "aurora_tpu_torch.cli.cfg_tools:"
_PORTED = {"train": "aurora_tpu_torch.cli.train",
           "preprocess": "aurora_tpu_torch.cli.preprocess",
           "list-cfg": _CFG_TOOLS + "list_cfg",
           "copy-cfg": _CFG_TOOLS + "copy_cfg",
           "log-dataset": _CFG_TOOLS + "log_dataset",
           "check-custom-dataset": _CFG_TOOLS + "check_custom_dataset",
           "infer": "aurora_tpu_torch.cli.infer",
           "serve": "aurora_tpu_torch.cli.serve",
           "chat": "aurora_tpu_torch.cli.chat",
           "convert": "aurora_tpu_torch.cli.convert",
           "bench-latency": "aurora_tpu_torch.cli.bench_latency",
           "bench-serving": "aurora_tpu_torch.cli.bench_serving",
           # xtuner's `test` is the eval CLI, as in the reference
           "test": "aurora_tpu_torch.eval.__main__",
           "eval": "aurora_tpu_torch.eval.__main__",
           "post-eval": "aurora_tpu_torch.eval.post_eval",
           "mmbench": "aurora_tpu_torch.cli.mmbench"}


def _help() -> str:
    return ("usage: python -m aurora_tpu_torch MODE [ARGS...]\n"
            f"  ported modes: {', '.join(_PORTED)}\n"
            f"  not ported yet: {', '.join(sorted(_NOT_PORTED))}\n"
            "  examples:\n"
            "    python -m aurora_tpu_torch infer --model_path M "
            "--visual_input v.npy\n"
            "    python -m aurora_tpu_torch copy-cfg vision my_cfg.json\n"
            "    python -m aurora_tpu_torch train --stage vision "
            "--config my_cfg.json --model_path M --data d.json\n")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_help())
        return 0
    mode, rest = argv[0], argv[1:]
    if mode in _PORTED:
        module, _, fn = _PORTED[mode].partition(":")
        return getattr(importlib.import_module(module), fn or "main")(
            rest) or 0
    if mode in _NOT_PORTED:
        print(f"mode {mode!r} is not ported yet: ROADMAP.md "
              f"{_NOT_PORTED[mode]}", file=sys.stderr)
        return 2
    print(f"unknown mode {mode!r}\n\n{_help()}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
