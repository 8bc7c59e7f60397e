"""MMBench multiple-choice evaluation.

Parity: xtuner's mmbench tool (src/xtuner/xtuner/tools/mmbench.py:1-513)
— the MMBench TSV format (index / base64 image / question / hint /
options A-D / answer), option-letter prompting, first-letter + option-text
answer extraction, and CircularEval (a sample counts only if the model is
right under ALL rotations of its options, grouped by index % 1e6).

Dataset: point `AURORA_MMBENCH_TSV` (or dataset_path) at a local MMBench
TSV. Images decode from base64 to arrays host-side.
"""

from __future__ import annotations

import base64
import io
import os
import string
from collections import defaultdict
from typing import Dict, List

import numpy as np

from aurora_tpu_torch.eval.api import TaskConfig, register_task

MMBENCH_TSV = os.environ.get("AURORA_MMBENCH_TSV", "data/mmbench/dev.tsv")
OPTION_KEYS = ("A", "B", "C", "D")


def load_mmbench_tsv(path: str) -> List[dict]:
    """TSV → docs (mmbench.py MMBenchDataset.load_data_list parity)."""
    import csv
    docs = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            doc = {k.strip(): v for k, v in row.items()}
            doc["index"] = int(doc["index"])
            docs.append(doc)
    return docs


def doc_to_visual(doc):
    """base64 image column → [1, H, W, 3] uint8 frame array."""
    from PIL import Image
    img = Image.open(io.BytesIO(base64.b64decode(doc["image"])))
    return [np.asarray(img.convert("RGB"))[None]]


def doc_to_text(doc, **_):
    """Question (+hint) + lettered options + answer instruction
    (mmbench.py prompt construction)."""
    options = [f"{k}. {doc[k]}" for k in OPTION_KEYS
               if doc.get(k) not in (None, "", "nan")]
    hint = doc.get("hint", "")
    parts = []
    if hint and hint != "nan":
        parts.append(f"Hint: {hint}")
    parts.append(f"Question: {doc['question']}")
    parts.append("Options:\n" + "\n".join(options))
    parts.append("Please select the correct answer from the options "
                 "above. Answer with the option's letter directly.")
    return "\n".join(parts)


def doc_to_target(doc):
    return doc.get("answer", "")


def extract_choice(pred: str, doc) -> str:
    """First standalone option letter, else option-text containment
    (mmbench.py answer matching)."""
    text = pred.strip()
    for ch in text:
        if ch in OPTION_KEYS:
            return ch
        if ch not in string.whitespace + string.punctuation:
            break
    low = text.lower()
    for k in OPTION_KEYS:
        opt = str(doc.get(k, "")).lower()
        if opt and opt != "nan" and opt in low:
            return k
    return ""


def process_results(doc, result):
    choice = extract_choice(result[0], doc)
    # _index/_pred are sample-level bookkeeping for CircularEval —
    # the leading underscore keeps them out of the aggregate table
    return {"acc": float(choice == doc.get("answer", "")),
            "_index": doc["index"], "_pred": choice}


def circular_aggregate(results: List[Dict]) -> float:
    """CircularEval: group rotations by index % 1e6; a group scores 1 only
    if every rotation is correct (mmbench.py:CircularEval)."""
    groups = defaultdict(list)
    for r in results:
        groups[r["_index"] % 1_000_000].append(r["acc"])
    if not groups:
        return 0.0
    return float(np.mean([float(all(v)) for v in groups.values()]))


def agg_acc(results) -> float:
    return float(np.mean([r for r in results])) if len(results) else 0.0


def register(tsv_path: str = None, name: str = "mmbench_dev"):
    path = tsv_path or MMBENCH_TSV
    return register_task(TaskConfig(
        name=name,
        dataset_path=path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.mmbench:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.mmbench:doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.mmbench:doc_to_target",
        process_results="aurora_tpu_torch.eval.tasks.mmbench:process_results",
        metric_aggregations={"acc": "mean"},
        generation_kwargs={"max_new_tokens": 16, "temperature": 0.0},
    ))


if os.path.exists(MMBENCH_TSV):
    register()
