"""Metrics logging: jsonl always, Weights & Biases when asked for (a copy
of aurora_tpu/utils/loggers.py).

wandb is not a dependency: it is imported only when `wandb_project` is
given, and when the package is missing or its init fails the logger
degrades to jsonl-only and says so once.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only jsonl metrics stream with optional wandb mirroring."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 wandb_project: Optional[str] = None,
                 run_name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None,
                 log=print):
        self.jsonl_path = jsonl_path
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
        self._wandb = None
        if wandb_project:
            try:
                import wandb
                self._wandb = wandb.init(project=wandb_project,
                                         name=run_name, config=config or {})
            except Exception as e:  # noqa: BLE001 — degrade gracefully
                log(f"[loggers] wandb unavailable ({e}); jsonl only")

    def log(self, metrics: Dict[str, Any],
            step: Optional[int] = None) -> None:
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def summary(self, results: Dict[str, Any]) -> None:
        """Final run summary (eval results table)."""
        if self._wandb is not None:
            for k, v in results.items():
                self._wandb.summary[k] = v

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
