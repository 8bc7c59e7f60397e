"""Command-line entry points (aurora_tpu/cli/); `python -m aurora_tpu_torch
MODE` dispatches to them."""
