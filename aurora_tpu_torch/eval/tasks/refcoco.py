"""RefCOCO referring-expression grounding evaluation.

Parity: xtuner's eval_refcoco tool (src/xtuner/xtuner/tools/
eval_refcoco.py:110-140 — parse a bbox from the generated text, IoU > 0.5
against the normalized ground-truth box → accuracy).

Dataset: local jsonl, one record per expression
  {"image": <file>, "sentence": str, "bbox": [x1, y1, x2, y2],
   "height": int, "width": int}
Ground-truth boxes normalize to the [0, 100) integer grid the prompt asks
the model to answer in (RefCOCOJsonEvalDataset.normalize_bbox).
"""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np

from aurora_tpu_torch.eval.api import TaskConfig, register_task

REFCOCO_PROMPT = ("Please provide the bounding box coordinate of the "
                  "region this sentence describes: {sentence}")


def normalize_bbox(bbox, height, width, grid: int = 100):
    """Pixel box → [0, grid) integer coordinates (refcoco_json.py)."""
    x1, y1, x2, y2 = bbox
    return [int(x1 / width * grid), int(y1 / height * grid),
            int(x2 / width * grid), int(y2 / height * grid)]


def compute_iou(b1, b2) -> float:
    """+1-inclusive pixel-area IoU (eval_refcoco.py:112-126)."""
    x1, y1, x2, y2 = b1
    x3, y3, x4, y4 = b2
    ix1, iy1 = max(x1, x3), max(y1, y3)
    ix2, iy2 = min(x2, x4), min(y2, y4)
    if ix2 < ix1 or iy2 < iy1:
        return 0.0
    inter = (ix2 - ix1 + 1) * (iy2 - iy1 + 1)
    a1 = (x2 - x1 + 1) * (y2 - y1 + 1)
    a2 = (x4 - x3 + 1) * (y4 - y3 + 1)
    return inter / (a1 + a2 - inter)


def _coords(text: str, grid: int = 100):
    """Numbers from a model response, decimal-aware: '(0.52, 0.48)'
    must parse as two normalized coordinates (scaled onto the 0-grid
    target space), not shred into [0, 52, 0, 48] via an int-only
    regex."""
    vals = [float(x) for x in re.findall(r"-?\d+(?:\.\d+)?", text)]
    if vals and all(0.0 <= v <= 1.0 for v in vals):
        vals = [v * grid for v in vals]
    return vals


def parse_bbox(text: str):
    nums = _coords(text)
    return nums[:4] if len(nums) >= 4 else None


def doc_to_visual(doc):
    base = doc.get("_root", "")
    return [os.path.join(base, doc["image"])]


def doc_to_text(doc, **_):
    return REFCOCO_PROMPT.format(sentence=doc["sentence"])


def doc_to_target(doc):
    return normalize_bbox(doc["bbox"], doc["height"], doc["width"])


def process_results(doc, result):
    pred = parse_bbox(result[0])
    gt = doc_to_target(doc)
    iou = compute_iou(pred, gt) if pred else 0.0
    return {"acc@0.5": float(iou > 0.5), "miou": iou}


def register_refcoco(dataset_path: str, name: str = "refcoco_val"):
    return register_task(TaskConfig(
        name=name,
        dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.refcoco:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.refcoco:doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.refcoco:doc_to_target",
        process_results="aurora_tpu_torch.eval.tasks.refcoco:process_results",
        metric_aggregations={"acc@0.5": "mean", "miou": "mean"},
        generation_kwargs={"max_new_tokens": 32, "temperature": 0.0},
    ))


def screenspot_process_results(doc, result):
    """ScreenSpot GUI grounding (lmms-eval tasks/screenspot): the
    predicted CLICK POINT (or a predicted box's center) must land inside
    the ground-truth element box."""
    gt = doc_to_target(doc)
    raw = _coords(result[0])
    if len(raw) >= 4:  # a predicted box → use its center
        cx, cy = (raw[0] + raw[2]) / 2, (raw[1] + raw[3]) / 2
    elif len(raw) >= 2:
        cx, cy = raw[0], raw[1]
    else:
        return {"point_acc": 0.0}
    x1, y1, x2, y2 = gt
    return {"point_acc": float(x1 <= cx <= x2 and y1 <= cy <= y2)}


def register_screenspot(dataset_path: str, name: str = "screenspot"):
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.refcoco:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.refcoco:doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.refcoco:doc_to_target",
        process_results="aurora_tpu_torch.eval.tasks.refcoco:"
                        "screenspot_process_results",
        metric_aggregations={"point_acc": "mean"},
        generation_kwargs={"max_new_tokens": 32, "temperature": 0.0}))


# refcoco / refcoco+ / refcocog share one protocol (lmms-eval dirs:
# tasks/refcoco, tasks/refcoco+, tasks/refcocog); ScreenSpot adds
# point-in-box scoring (tasks/screenspot)
for _name, _env, _default in (
        ("refcoco", "AURORA_REFCOCO", "data/refcoco/val.jsonl"),
        ("refcoco_plus", "AURORA_REFCOCO_PLUS",
         "data/refcoco_plus/val.jsonl"),
        ("refcocog", "AURORA_REFCOCOG", "data/refcocog/val.jsonl")):
    _path = os.environ.get(_env, _default)
    if os.path.exists(_path):
        register_refcoco(_path, name=(_name if _name != "refcoco"
                                      else "refcoco_val"))

_path = os.environ.get("AURORA_SCREENSPOT", "data/screenspot/test.jsonl")
if os.path.exists(_path):
    register_screenspot(_path)
