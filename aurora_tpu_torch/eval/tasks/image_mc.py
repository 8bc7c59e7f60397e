"""Image multiple-choice benchmark family.

Parity targets: the lmms-eval image MC task dirs the reference evaluates
LLaVA-family checkpoints on — ai2d (tasks/ai2d/utils.py), scienceqa-img
(tasks/scienceqa/utils.py), seedbench (tasks/seedbench/utils.py), mmstar
(tasks/mmstar/utils.py), realworldqa (tasks/realworldqa/utils.py) and the
MMMU multiple-choice subset (tasks/mmmu/utils.py letter parsing). Each
reference dir is a YAML + utils.py pair over an HF dataset; here one
module covers the family with a shared local-jsonl format (zero-egress
environment — datasets ship as files):

  {"image": <path relative to the jsonl's dir>,
   "question": str, "options": [str, ...],
   "answer": <letter "A"… or int index>,
   "hint": optional context paragraph,
   "category": optional split key (seedbench/mmstar per-category)}

Every benchmark registers two tasks: `<name>` (generation + robust
letter parsing, the lmms-eval default for these suites) and `<name>_ppl`
(per-choice multimodal loglikelihood through the engine).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import List

import numpy as np

from aurora_tpu_torch.eval.api import TaskConfig, register_task
from aurora_tpu_torch.eval.tasks.video_mc import (_LETTERS, mcq_acc,
                                            parse_multi_choice_response,
                                            ppl_argmax)

POST_PROMPT = ("\nAnswer with the option's letter from the given "
               "choices directly.")


def doc_to_visual(doc):
    base = doc.get("_root", "")
    img = doc["image"]
    if isinstance(img, (list, tuple)):  # multi-image benchmarks
        # (muirbench tasks/muirbench/utils.py, mirb tasks/mirb/utils.py:
        #  the images feed the visual stream in order, like video frames)
        return [os.path.join(base, i) for i in img]
    return [os.path.join(base, img)]


def answer_index(doc) -> int:
    a = doc["answer"]
    if isinstance(a, int):
        return a
    return _LETTERS.index(str(a).strip().upper())


def doc_to_text(doc, **_):
    parts = []
    hint = doc.get("hint") or doc.get("context")
    if hint:
        parts.append(f"Hint: {hint}")
    parts.append(doc["question"])
    for i, opt in enumerate(doc["options"]):
        parts.append(f"{_LETTERS[i]}. {opt}")
    return "\n".join(parts) + POST_PROMPT


def doc_to_text_ppl(doc, **_):
    hint = doc.get("hint") or doc.get("context")
    prefix = f"Hint: {hint}\n" if hint else ""
    return prefix + doc["question"]


def doc_to_choice(doc):
    return [str(o) for o in doc["options"]]


def doc_to_target(doc):
    return _LETTERS[answer_index(doc)]


def process_results(doc, result):
    letters = [_LETTERS[i] for i in range(len(doc["options"]))]
    pred = parse_multi_choice_response(result[0], letters)
    return {"mc_accuracy": {
        "score": float(pred == doc_to_target(doc)),
        "category": doc.get("category", "all")}}


def process_results_ppl(doc, result):
    return {"mc_accuracy": {
        "score": float(ppl_argmax(result[0]) == answer_index(doc)),
        "category": doc.get("category", "all")}}


def aggregate(results: List[dict]) -> float:
    """Overall accuracy in %; per-category means land in samples logs."""
    if not results:
        return 0.0
    return 100 * float(np.mean([r["score"] for r in results]))


def aggregate_by_category(results: List[dict]) -> float:
    """Mean of per-category accuracies (seedbench/mmstar convention:
    categories weigh equally regardless of size)."""
    cats = defaultdict(list)
    for r in results:
        cats[r["category"]].append(r["score"])
    if not cats:
        return 0.0
    return 100 * float(np.mean([np.mean(v) for v in cats.values()]))


def register_image_mc(name: str, dataset_path: str, *,
                      by_category: bool = False,
                      max_new_tokens: int = 16):
    agg = ("aurora_tpu_torch.eval.tasks.image_mc:aggregate_by_category"
           if by_category else
           "aurora_tpu_torch.eval.tasks.image_mc:aggregate")
    gen = register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.image_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.image_mc:doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.image_mc:doc_to_target",
        process_results="aurora_tpu_torch.eval.tasks.image_mc:process_results",
        metric_aggregations={"mc_accuracy": agg},
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0}))
    ppl = register_task(TaskConfig(
        name=f"{name}_ppl", dataset_path=dataset_path,
        output_type="loglikelihood",
        doc_to_visual="aurora_tpu_torch.eval.tasks.image_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.image_mc:doc_to_text_ppl",
        doc_to_choice="aurora_tpu_torch.eval.tasks.image_mc:doc_to_choice",
        doc_to_target="aurora_tpu_torch.eval.tasks.image_mc:doc_to_target",
        process_results="aurora_tpu_torch.eval.tasks.image_mc:"
                        "process_results_ppl",
        metric_aggregations={"mc_accuracy": agg}))
    return gen, ppl


BENCHMARKS = (
    # (name, env var, default path, per-category aggregation)
    ("ai2d", "AURORA_AI2D", "data/ai2d/test.jsonl", False),
    ("scienceqa_img", "AURORA_SCIENCEQA", "data/scienceqa/test.jsonl",
     False),
    ("seedbench", "AURORA_SEEDBENCH", "data/seedbench/test.jsonl", True),
    ("mmstar", "AURORA_MMSTAR", "data/mmstar/val.jsonl", True),
    ("realworldqa", "AURORA_REALWORLDQA", "data/realworldqa/test.jsonl",
     False),
    ("mmmu_val", "AURORA_MMMU", "data/mmmu/val.jsonl", False),
    # (lmms-eval dirs: tasks/cvbench, tasks/blink, tasks/mmt,
    #  tasks/seedbench_2, tasks/vstar_bench — same letter-MC protocol)
    ("cvbench", "AURORA_CVBENCH", "data/cvbench/test.jsonl", True),
    ("blink", "AURORA_BLINK", "data/blink/val.jsonl", True),
    ("mmt_bench", "AURORA_MMT", "data/mmt_bench/val.jsonl", True),
    ("seedbench2", "AURORA_SEEDBENCH2", "data/seedbench2/test.jsonl",
     True),
    ("vstar_bench", "AURORA_VSTAR", "data/vstar_bench/test.jsonl",
     True),
    # (lmms-eval dirs: tasks/cmmmu, tasks/iconqa, tasks/ii_bench,
    #  tasks/mmmu_pro, tasks/mmupd, tasks/qbench, tasks/seedbench_2_plus
    #  — the same letter-MC protocol over their own datasets)
    ("cmmmu", "AURORA_CMMMU", "data/cmmmu/val.jsonl", True),
    ("iconqa", "AURORA_ICONQA", "data/iconqa/test.jsonl", False),
    ("ii_bench", "AURORA_IIBENCH", "data/ii_bench/test.jsonl", False),
    ("mmmu_pro", "AURORA_MMMU_PRO", "data/mmmu_pro/test.jsonl", False),
    ("mmupd", "AURORA_MMUPD", "data/mmupd/test.jsonl", True),
    ("qbench", "AURORA_QBENCH", "data/qbench/dev.jsonl", False),
    ("seedbench2_plus", "AURORA_SEEDBENCH2PLUS",
     "data/seedbench2_plus/test.jsonl", True),
    # multi-image MC (image lists; tasks/muirbench, tasks/mirb)
    ("muirbench", "AURORA_MUIRBENCH", "data/muirbench/test.jsonl",
     True),
    ("mirb", "AURORA_MIRB", "data/mirb/test.jsonl", True),
)

for _name, _env, _default, _bycat in BENCHMARKS:
    _path = os.environ.get(_env, _default)
    if os.path.exists(_path):
        register_image_mc(_name, _path, by_category=_bycat)
