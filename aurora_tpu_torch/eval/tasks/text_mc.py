"""Text-only multiple-choice benchmarks: MMLU, HellaSwag, ARC.

Parity targets: lmms-eval's text task dirs (tasks/mmlu/*.yaml — 57
subjects scored by letter; tasks/hellaswag/utils.py — loglikelihood over
preprocessed endings with acc and length-normalized acc_norm; tasks/arc)
and xtuner's MMLU eval plugin (src/xtuner — loglikelihood scoring). These
exercise the engine's text loglikelihood path with no visual tower
(doc_to_visual absent → eval/models.py scores pure-text contexts).

Local jsonl rows:
  mmlu:      {"question", "choices": [4 strings], "answer": int,
              "subject": str}
  hellaswag: {"ctx", "endings": [4 strings], "label": int}
  arc:       {"question", "choices": [strings], "answer": int}
"""

from __future__ import annotations

import os
import re
from collections import defaultdict
from typing import List

import numpy as np

from aurora_tpu_torch.eval.api import TaskConfig, register_task

_LETTERS = "ABCDEFGHIJ"  # mmlu-pro carries up to 10 options


# --- MMLU ------------------------------------------------------------------

def mmlu_doc_to_text(doc, **_):
    subject = doc.get("subject", "").replace("_", " ")
    head = (f"The following is a multiple choice question (with answer) "
            f"about {subject}.\n\n" if subject else "")
    opts = "\n".join(f"{_LETTERS[i]}. {c}"
                     for i, c in enumerate(doc["choices"]))
    return f"{head}{doc['question'].strip()}\n{opts}\nAnswer:"


def mmlu_doc_to_choice(doc):
    return [f" {_LETTERS[i]}" for i in range(len(doc["choices"]))]


def mmlu_target(doc):
    return _LETTERS[int(doc["answer"])]


def mmlu_process_results(doc, result):
    pred = int(np.argmax(result[0]))
    return {"mmlu_acc": {"score": float(pred == int(doc["answer"])),
                         "subject": doc.get("subject", "all")}}


def mmlu_aggregate(results: List[dict]) -> float:
    """Mean over subjects of per-subject accuracy (the harness convention
    for the 57-subject suite), in %."""
    by_subj = defaultdict(list)
    for r in results:
        by_subj[r["subject"]].append(r["score"])
    return 100 * float(np.mean([np.mean(v) for v in by_subj.values()])) \
        if by_subj else 0.0


def register_mmlu(dataset_path: str, name: str = "mmlu"):
    m = "aurora_tpu_torch.eval.tasks.text_mc:"
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        output_type="loglikelihood",
        doc_to_text=m + "mmlu_doc_to_text",
        doc_to_choice=m + "mmlu_doc_to_choice",
        doc_to_target=m + "mmlu_target",
        process_results=m + "mmlu_process_results",
        metric_aggregations={"mmlu_acc": m + "mmlu_aggregate"}))


# --- HellaSwag -------------------------------------------------------------

def _hellaswag_preprocess(text: str) -> str:
    """tasks/hellaswag/utils.py:preprocess — strip [header] markers and
    WikiHow artifacts."""
    text = text.strip().replace(" [title]", ". ")
    text = re.sub(r"\[.*?\]", "", text)
    return text.replace("  ", " ")


def hellaswag_doc_to_text(doc, **_):
    ctx = doc.get("ctx") or (doc.get("ctx_a", "") + " "
                             + doc.get("ctx_b", "").capitalize())
    label = doc.get("activity_label", "")
    head = f"{label}: " if label else ""
    return _hellaswag_preprocess(head + ctx)


def hellaswag_doc_to_choice(doc):
    return [" " + _hellaswag_preprocess(e) for e in doc["endings"]]


def hellaswag_target(doc):
    return int(doc["label"])


def hellaswag_process_results(doc, result):
    lls = result[0]
    lens = [max(len(c), 1) for c in hellaswag_doc_to_choice(doc)]
    gold = int(doc["label"])
    return {"hellaswag_acc": float(int(np.argmax(lls)) == gold),
            "hellaswag_acc_norm": float(int(np.argmax(
                [ll / n for ll, n in zip(lls, lens)])) == gold)}


def register_hellaswag(dataset_path: str, name: str = "hellaswag"):
    m = "aurora_tpu_torch.eval.tasks.text_mc:"
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        output_type="loglikelihood",
        doc_to_text=m + "hellaswag_doc_to_text",
        doc_to_choice=m + "hellaswag_doc_to_choice",
        doc_to_target=m + "hellaswag_target",
        process_results=m + "hellaswag_process_results",
        metric_aggregations={"hellaswag_acc": "mean",
                             "hellaswag_acc_norm": "mean"}))


# --- ARC -------------------------------------------------------------------

def arc_doc_to_text(doc, **_):
    return f"Question: {doc['question'].strip()}\nAnswer:"


def arc_doc_to_choice(doc):
    return [f" {c}" for c in doc["choices"]]


def arc_target(doc):
    return int(doc["answer"])


def arc_process_results(doc, result):
    lls = result[0]
    lens = [max(len(c), 1) for c in arc_doc_to_choice(doc)]
    gold = int(doc["answer"])
    return {"arc_acc": float(int(np.argmax(lls)) == gold),
            "arc_acc_norm": float(int(np.argmax(
                [ll / n for ll, n in zip(lls, lens)])) == gold)}


def register_arc(dataset_path: str, name: str = "arc_challenge"):
    m = "aurora_tpu_torch.eval.tasks.text_mc:"
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        output_type="loglikelihood",
        doc_to_text=m + "arc_doc_to_text",
        doc_to_choice=m + "arc_doc_to_choice",
        doc_to_target=m + "arc_target",
        process_results=m + "arc_process_results",
        metric_aggregations={"arc_acc": "mean",
                             "arc_acc_norm": "mean"}))


for _reg, _name, _env, _default in (
        (register_mmlu, "mmlu", "AURORA_MMLU", "data/mmlu/test.jsonl"),
        # same letter-loglikelihood protocol (lmms-eval tasks/gpqa —
        # 4-option science MC; tasks/mmlu_pro — 10-option MC whose
        # "category" rides the subject key)
        (register_mmlu, "gpqa", "AURORA_GPQA", "data/gpqa/main.jsonl"),
        (register_mmlu, "mmlu_pro", "AURORA_MMLU_PRO",
         "data/mmlu_pro/test.jsonl"),
        (register_hellaswag, "hellaswag", "AURORA_HELLASWAG",
         "data/hellaswag/val.jsonl"),
        (register_arc, "arc_challenge", "AURORA_ARC_CHALLENGE",
         "data/arc_challenge/test.jsonl"),
        (register_arc, "arc_easy", "AURORA_ARC_EASY",
         "data/arc_easy/test.jsonl")):
    _path = os.environ.get(_env, _default)
    if os.path.exists(_path):
        _reg(_path, name=_name)
