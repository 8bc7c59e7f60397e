"""GSM8K grade-school math (generation + flexible numeric extraction).

Parity: lmms-eval tasks/gsm8k/gsm8k.yaml — generate_until with
"Question: ... Answer:" formatting, gold answer after "#### ", scored by
exact match of the FINAL number in the generation (the
"flexible-extract" filter: last number wins; strict-extract — a number
right after "The answer is" / "####" — is reported alongside).

Local jsonl rows: {"question": str, "answer": str}  (answer may be the
full rationale ending in "#### N" or just "N").
"""

from __future__ import annotations

import os
import re

from aurora_tpu_torch.eval.api import TaskConfig, register_task

_NUM = r"-?\$?[\d,]*\.?\d+"


def _canon(num: str) -> str:
    return num.replace(",", "").replace("$", "").rstrip(".").strip()


def gold_answer(doc) -> str:
    a = str(doc["answer"])
    if "####" in a:
        a = a.split("####")[-1]
    nums = re.findall(_NUM, a)
    return _canon(nums[-1]) if nums else a.strip()


def doc_to_text(doc, **_):
    return (f"Question: {doc['question'].strip()}\n"
            f"Answer: Let's think step by step.")


def doc_to_target(doc):
    return gold_answer(doc)


def extract_flexible(text: str):
    nums = re.findall(_NUM, text)
    return _canon(nums[-1]) if nums else None


def extract_strict(text: str):
    m = re.search(r"(?:####|[Tt]he answer is)\s*(" + _NUM + ")", text)
    return _canon(m.group(1)) if m else None


def process_results(doc, result):
    gold = gold_answer(doc)
    flex = extract_flexible(result[0])
    strict = extract_strict(result[0])
    return {"exact_match_flexible": float(flex == gold),
            "exact_match_strict": float(strict == gold)}


def register_gsm8k(dataset_path: str, name: str = "gsm8k"):
    m = "aurora_tpu_torch.eval.tasks.gsm8k:"
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_text=m + "doc_to_text",
        doc_to_target=m + "doc_to_target",
        process_results=m + "process_results",
        metric_aggregations={"exact_match_flexible": "mean",
                             "exact_match_strict": "mean"},
        generation_kwargs={"max_new_tokens": 256, "temperature": 0.0,
                           "stop": ["Question:"]}))


_path = os.environ.get("AURORA_GSM8K", "data/gsm8k/test.jsonl")
if os.path.exists(_path):
    register_gsm8k(_path)
