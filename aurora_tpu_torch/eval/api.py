"""Evaluation task system.

Replaces lmms-eval's YAML ConfigurableTask machinery
(src/lmms-eval/lmms_eval/api/task.py, 1,413 LoC) with a compact dataclass
registry: a task binds a dataset (local json/jsonl or HF datasets dir),
doc_to_visual / doc_to_text / process_results hooks, and metric
aggregations. `!function` YAML references become plain "module:fn" strings.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import random
from typing import Any, Callable, Dict, List, Optional

import numpy as np

_REGISTRY: Dict[str, "TaskConfig"] = {}


def resolve_fn(ref):
    """'pkg.mod:fn' → callable (the YAML !function analog)."""
    if callable(ref) or ref is None:
        return ref
    mod, fn = ref.split(":")
    return getattr(importlib.import_module(mod), fn)


@dataclasses.dataclass
class TaskConfig:
    name: str
    dataset_path: str = ""                 # json/jsonl file or dir
    doc_to_visual: Any = None              # doc → visual input (path/array)
    doc_to_text: Any = None                # doc → prompt text
    doc_to_target: Any = None              # doc → reference answer
    process_results: Any = None            # (doc, [pred]) → {metric: value}
    metric_aggregations: Dict[str, Any] = dataclasses.field(
        default_factory=dict)              # metric → agg fn or "mean"
    generation_kwargs: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    limit: Optional[int] = None
    # "generate" → model.generate_*; "loglikelihood" → per-choice
    # Σ log p(choice | context) via model.loglikelihood_choices
    # (lmms-eval output_type generate_until / multiple_choice parity)
    output_type: str = "generate"
    doc_to_choice: Any = None              # doc → list of choice strings

    @classmethod
    def from_yaml(cls, path: str) -> "TaskConfig":
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls(**raw)


def register_task(cfg: TaskConfig) -> TaskConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_task(name: str) -> "Task":
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; known: "
                       f"{sorted(_REGISTRY)}")
    return Task(_REGISTRY[name])


def list_tasks() -> List[str]:
    return sorted(_REGISTRY)


def _load_docs(path: str) -> List[dict]:
    if os.path.isdir(path):
        import datasets
        return list(datasets.load_from_disk(path))
    if path.endswith(".tsv"):  # MMBench-style tables
        from aurora_tpu_torch.eval.tasks.mmbench import load_mmbench_tsv
        return load_mmbench_tsv(path)
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(ln) for ln in f if ln.strip()]
        return json.load(f)


class Task:
    def __init__(self, cfg: TaskConfig):
        self.cfg = cfg
        self.doc_to_visual = resolve_fn(cfg.doc_to_visual)
        self.doc_to_text = resolve_fn(cfg.doc_to_text)
        self.doc_to_target = resolve_fn(cfg.doc_to_target)
        self.doc_to_choice = resolve_fn(cfg.doc_to_choice)
        self.process_results = resolve_fn(cfg.process_results)

    def docs(self) -> List[dict]:
        docs = _load_docs(self.cfg.dataset_path)
        if self.cfg.limit:
            docs = docs[: self.cfg.limit]
        return docs

    def aggregate(self, metric: str,
                  per_doc: List[Any]) -> Dict[str, float]:
        agg = self.cfg.metric_aggregations.get(metric, "mean")
        if agg == "mean":
            vals = [float(v) for v in per_doc]
            return {"value": float(np.mean(vals)),
                    "stderr": bootstrap_stderr(vals)}
        fn = resolve_fn(agg)
        return {"value": float(fn(per_doc)), "stderr": None}


def bootstrap_stderr(values: List[float], iters: int = 1000,
                     seed: int = 1234) -> float:
    """Bootstrap standard error of the mean (evaluator.py parity)."""
    if len(values) <= 1:
        return 0.0
    rng = random.Random(seed)
    arr = np.asarray(values, np.float64)
    means = []
    n = len(arr)
    for _ in range(iters):
        idx = [rng.randrange(n) for _ in range(n)]
        means.append(arr[idx].mean())
    return float(np.std(means))
