"""Evaluator: build requests per task, run the model, aggregate metrics.

Parity: lmms-eval simple_evaluate/evaluate
(src/lmms-eval/lmms_eval/evaluator.py:48, :301) — seeds, per-task request
loop, process_results, aggregation with bootstrap stderr, sample logging.
"""

from __future__ import annotations

import json
import os
import random
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np

from aurora_tpu_torch.eval.api import Task, get_task


def simple_evaluate(model, tasks: List[str], *, limit: Optional[int] = None,
                    log_samples: bool = False,
                    output_dir: Optional[str] = None,
                    seed: int = 0) -> Dict[str, Any]:
    """model: an adapter with `generate_until(doc, task) -> str`."""
    random.seed(seed)
    np.random.seed(seed)
    import aurora_tpu_torch.eval.tasks  # noqa: F401  (registers built-ins)

    results: Dict[str, Any] = {"results": {}, "samples": {}}
    for name in tasks:
        task = get_task(name)
        docs = task.docs()
        if limit:
            docs = docs[:limit]
        metrics = defaultdict(list)
        samples = []
        # batched adapters (generate_batch) run ALL docs through the
        # serving engine's continuous batching — the round-1 harness was
        # serial one-doc-at-a-time (lmms-eval accelerate-DP analog)
        t_batch0 = time.monotonic()
        if task.cfg.output_type == "loglikelihood":
            # multiple-choice: per-choice Σ log p(choice | context);
            # process_results receives the loglikelihood list
            # (lmms-eval output_type multiple_choice / mc_ppl parity)
            if not hasattr(model, "loglikelihood_choices"):
                raise ValueError(
                    f"task {task.cfg.name!r} scores by loglikelihood, "
                    f"which {type(model).__name__} cannot provide "
                    "(HTTP-served models expose generated-token "
                    "logprobs only) — run it with --model auroracap, "
                    "or use the task's generation variant")
            preds = [model.loglikelihood_choices(doc, task)
                     for doc in docs]
        else:
            preds = (model.generate_batch(docs, task)
                     if hasattr(model, "generate_batch") else None)
        batch_latency = ((time.monotonic() - t_batch0) / max(len(docs), 1)
                         if preds is not None else None)
        for i, doc in enumerate(docs):
            t0 = time.monotonic()
            pred = (preds[i] if preds is not None
                    else model.generate_until(doc, task))
            per_doc = task.process_results(doc, [pred])
            for k, v in per_doc.items():
                metrics[k].append(v)
            if log_samples:
                # batched adapters amortize latency over the whole run
                lat = (batch_latency if batch_latency is not None
                       else time.monotonic() - t0)
                samples.append({"doc_id": i, "pred": pred,
                                "target": (task.doc_to_target(doc)
                                           if task.doc_to_target else None),
                                "metrics": per_doc,
                                "latency_s": lat})
        agg = {}
        for k, v in metrics.items():
            if k.startswith("_"):
                continue  # bookkeeping for sample-level aggregation
            if k not in task.cfg.metric_aggregations \
                    and isinstance(v[0], str):
                continue  # string metric with no declared aggregation
            # DECLARED aggregations run regardless of value type — the
            # old isinstance-str filter silently killed generation-only
            # judge tasks' declared aggregations (vdc 'pred' agg_noop)
            agg[k] = task.aggregate(k, v)
        results["results"][name] = agg
        if log_samples:
            results["samples"][name] = samples
        # per-doc predictions for post_eval live in the samples jsonl
        # (pass log_samples=True for the decoupled scoring flow)
        results["results"][name]["_n"] = len(docs)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "results.json"), "w") as f:
            json.dump(results["results"], f, indent=2)
        if log_samples:
            for name, samples in results["samples"].items():
                with open(os.path.join(output_dir,
                                       f"{name}_samples.jsonl"), "w") as f:
                    for s in samples:
                        f.write(json.dumps(s) + "\n")
    return results
