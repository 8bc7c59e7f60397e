"""Yes/no judgment benchmark family: POPE, MME, HallusionBench.

Parity targets:
- POPE (lmms-eval tasks/pope/utils.py:pope_process_results /
  pope_aggregate_*): accuracy, precision, recall, F1 and yes-ratio over
  object-hallucination probes.
- MME (tasks/mme/utils.py:mme_process_results / mme_aggregate_results):
  questions come in PAIRS per image (one expecting yes, one no); each
  category scores acc*100 + acc_plus*100 where acc_plus counts images
  with BOTH questions right; perception/cognition report the SUM over
  their categories (max 2000 / 800).
- HallusionBench (tasks/hallusion_bench/evaluation/utils.py): aAcc
  (per-question), qAcc (per question set — every variant right), fAcc
  (per figure).

Local jsonl rows:
  {"image": <path, optional for text-only hallusion rows>,
   "question": str, "answer": "yes"|"no",
   "category": str (mme),
   "image_id": str (mme pairing / hallusion fAcc),
   "set_id": str, "question_id": str (hallusion qAcc)}
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import List

from aurora_tpu_torch.eval.api import TaskConfig, register_task

POST_PROMPT = "\nAnswer the question using a single word or phrase."


def doc_to_visual(doc):
    if not doc.get("image"):
        return []
    return [os.path.join(doc.get("_root", ""), doc["image"])]


def doc_to_text(doc, **_):
    return doc["question"].rstrip() + POST_PROMPT


def doc_to_target(doc):
    return doc["answer"]


def parse_yes_no(pred: str) -> str:
    """lmms-eval pope/mme answer parsing (mme/utils.py parse_pred_ans
    semantics): exact match, single-letter y/n, then a substring check
    over the FIRST 4 CHARS only — a whole-response substring fallback
    would turn 'I cannot determine' into 'no' ('no' ⊂ 'cannot') and
    'nothing is visible' into 'no'; anything else is 'other' (wrong)."""
    text = pred.lower().strip().rstrip(".")
    if text in ("yes", "no"):
        return text
    if text == "y":
        return "yes"
    if text == "n":
        return "no"
    head = text.split(",")[0].split()[0] if text.split() else ""
    if head in ("yes", "no"):
        return head
    prefix = text[:4]  # reference checks only this window
    if "yes" in prefix:
        return "yes"
    if "no" in prefix:  # incl. "not …" — a negation IS a no
        return "no"
    return "other"


# --- POPE ------------------------------------------------------------------

def pope_process_results(doc, result):
    pred = parse_yes_no(result[0])
    gt = doc["answer"].lower()
    rec = {"pred": pred, "gt": gt}
    return {k: rec for k in ("pope_accuracy", "pope_precision",
                             "pope_recall", "pope_f1", "pope_yes_ratio")}


def _pope_counts(results):
    tp = sum(1 for r in results if r["pred"] == "yes" and r["gt"] == "yes")
    fp = sum(1 for r in results if r["pred"] == "yes" and r["gt"] == "no")
    tn = sum(1 for r in results if r["pred"] == "no" and r["gt"] == "no")
    fn = sum(1 for r in results if r["pred"] != "yes" and r["gt"] == "yes")
    return tp, fp, tn, fn


def pope_acc(results: List[dict]) -> float:
    tp, fp, tn, fn = _pope_counts(results)
    n = len(results)
    return (tp + tn) / n if n else 0.0


def pope_precision(results: List[dict]) -> float:
    tp, fp, _, _ = _pope_counts(results)
    return tp / (tp + fp) if tp + fp else 0.0


def pope_recall(results: List[dict]) -> float:
    tp, _, _, fn = _pope_counts(results)
    return tp / (tp + fn) if tp + fn else 0.0


def pope_f1(results: List[dict]) -> float:
    p, r = pope_precision(results), pope_recall(results)
    return 2 * p * r / (p + r) if p + r else 0.0


def pope_yes_ratio(results: List[dict]) -> float:
    n = len(results)
    return sum(1 for r in results if r["pred"] == "yes") / n if n else 0.0


def register_pope(dataset_path: str, name: str = "pope"):
    m = "aurora_tpu_torch.eval.tasks.yesno:"
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual=m + "doc_to_visual",
        doc_to_text=m + "doc_to_text",
        doc_to_target=m + "doc_to_target",
        process_results=m + "pope_process_results",
        metric_aggregations={
            "pope_accuracy": m + "pope_acc",
            "pope_precision": m + "pope_precision",
            "pope_recall": m + "pope_recall",
            "pope_f1": m + "pope_f1",
            "pope_yes_ratio": m + "pope_yes_ratio"},
        generation_kwargs={"max_new_tokens": 8, "temperature": 0.0}))


# --- MME -------------------------------------------------------------------

MME_PERCEPTION = ("existence", "count", "position", "color", "posters",
                  "celebrity", "scene", "landmark", "artwork", "OCR")
MME_COGNITION = ("commonsense_reasoning", "numerical_calculation",
                 "text_translation", "code_reasoning")


def mme_process_results(doc, result):
    pred = parse_yes_no(result[0])
    rec = {"category": doc.get("category", ""),
           "image_id": doc.get("image_id", doc.get("image", "")),
           "correct": float(pred == doc["answer"].lower())}
    return {"mme_perception_score": rec, "mme_cognition_score": rec}


def _mme_group_score(results, categories):
    """Σ_cat acc*100 + acc_plus*100 (utils.py parity: acc over questions,
    acc_plus over both-right image pairs)."""
    by_cat = defaultdict(list)
    for r in results:
        if r["category"] in categories:
            by_cat[r["category"]].append(r)
    total = 0.0
    for rows in by_cat.values():
        acc = sum(r["correct"] for r in rows) / len(rows)
        pairs = defaultdict(list)
        for r in rows:
            pairs[r["image_id"]].append(r["correct"])
        acc_plus = (sum(1 for v in pairs.values() if all(v))
                    / len(pairs)) if pairs else 0.0
        total += acc * 100 + acc_plus * 100
    return total


def mme_perception(results: List[dict]) -> float:
    return _mme_group_score(results, MME_PERCEPTION)


def mme_cognition(results: List[dict]) -> float:
    return _mme_group_score(results, MME_COGNITION)


def register_mme(dataset_path: str, name: str = "mme"):
    m = "aurora_tpu_torch.eval.tasks.yesno:"
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual=m + "doc_to_visual",
        doc_to_text=m + "doc_to_text",
        doc_to_target=m + "doc_to_target",
        process_results=m + "mme_process_results",
        metric_aggregations={
            "mme_perception_score": m + "mme_perception",
            "mme_cognition_score": m + "mme_cognition"},
        generation_kwargs={"max_new_tokens": 8, "temperature": 0.0}))


# --- HallusionBench --------------------------------------------------------

def hallusion_process_results(doc, result):
    pred = parse_yes_no(result[0])
    rec = {"correct": float(pred == doc["answer"].lower()),
           "qid": f"{doc.get('set_id', '')}_{doc.get('question_id', '')}",
           "fid": f"{doc.get('set_id', '')}_{doc.get('image_id', '')}"}
    return {"hallusion_aAcc": rec, "hallusion_qAcc": rec,
            "hallusion_fAcc": rec}


def hallusion_aacc(results: List[dict]) -> float:
    n = len(results)
    return 100 * sum(r["correct"] for r in results) / n if n else 0.0


def _all_correct_groups(results, key):
    groups = defaultdict(list)
    for r in results:
        groups[r[key]].append(r["correct"])
    if not groups:
        return 0.0
    return 100 * sum(1 for v in groups.values() if all(v)) / len(groups)


def hallusion_qacc(results: List[dict]) -> float:
    return _all_correct_groups(results, "qid")


def hallusion_facc(results: List[dict]) -> float:
    return _all_correct_groups(results, "fid")


def register_hallusion(dataset_path: str, name: str = "hallusion_bench"):
    m = "aurora_tpu_torch.eval.tasks.yesno:"
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual=m + "doc_to_visual",
        doc_to_text=m + "doc_to_text",
        doc_to_target=m + "doc_to_target",
        process_results=m + "hallusion_process_results",
        metric_aggregations={
            "hallusion_aAcc": m + "hallusion_aacc",
            "hallusion_qAcc": m + "hallusion_qacc",
            "hallusion_fAcc": m + "hallusion_facc"},
        generation_kwargs={"max_new_tokens": 8, "temperature": 0.0}))


for _reg, _env, _default in (
        (register_pope, "AURORA_POPE", "data/pope/test.jsonl"),
        (register_mme, "AURORA_MME", "data/mme/test.jsonl"),
        (register_hallusion, "AURORA_HALLUSION",
         "data/hallusion_bench/test.jsonl")):
    _path = os.environ.get(_env, _default)
    if os.path.exists(_path):
        _reg(_path)
