"""Generic caption benchmarks scored with CIDEr-D.

Parity: the lmms-eval caption task family the reference's token-ratio
sweeps use — coco_cap / flickr30k / nocaps (figure_in_paper.ipynb cell 1,
BASELINE.md §6). Datasets are local jsonl files: one record per image/clip
  {"video_name"| "image": <file>, "captions": [str, ...]}
with media beside them (npy/frame-dir/mp4/jpg). Register per benchmark:

  from aurora_tpu_torch.eval.tasks.captions import register_caption_task
  register_caption_task("coco_cap", "/data/coco/val.jsonl")
"""

from __future__ import annotations

import os
from typing import List

from aurora_tpu_torch.eval.api import TaskConfig, register_task

CAPTION_PROMPT = ("Provide a one-sentence caption for the provided "
                  "image.")  # lmms-eval coco_cap doc_to_text


def doc_to_visual(doc):
    from aurora_tpu_torch.eval.tasks.vdc import doc_to_visual as vdc_visual
    if "image" in doc:
        base = doc.get("_root", "")
        return [os.path.join(base, doc["image"])]
    return vdc_visual(doc)


def doc_to_text(doc, **_):
    return doc.get("prompt", CAPTION_PROMPT)


def doc_to_target(doc):
    caps = (doc.get("captions") or doc.get("enCap")  # VATEX field
            or [doc.get("caption", "")])
    return caps


def process_results(doc, result):
    # CIDEr is corpus-level: stash (pred, refs) for the aggregator
    return {"cider": {"pred": result[0], "refs": doc_to_target(doc)}}


def cider_aggregate(results: List[dict]) -> float:
    from aurora_tpu_torch.eval.metrics import cider_d
    corpus, _ = cider_d([r["pred"] for r in results],
                        [r["refs"] for r in results])
    return corpus


def register_caption_task(name: str, dataset_path: str,
                          max_new_tokens: int = 64):
    return register_task(TaskConfig(
        name=name,
        dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.captions:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.captions:doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.captions:doc_to_target",
        process_results="aurora_tpu_torch.eval.tasks.captions:process_results",
        metric_aggregations={
            "cider": "aurora_tpu_torch.eval.tasks.captions:cider_aggregate"},
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0},
    ))


for _name, _env in (("coco_cap", "AURORA_COCO_CAP"),
                    ("flickr30k", "AURORA_FLICKR30K"),
                    ("nocaps", "AURORA_NOCAPS"),
                    ("textcaps", "AURORA_TEXTCAPS"),
                    ("youcook2", "AURORA_YOUCOOK2")):
    _path = os.environ.get(_env, f"data/{_name}/val.jsonl")
    if os.path.exists(_path):
        register_caption_task(_name, _path)


# --- VATEX video captioning (lmms-eval tasks/vatex parity) -----------------

VATEX_PROMPT = ("Provide a one-sentence caption for the provided "
                "video.")  # vatex/utils.py vatex_test_doc_to_text


def vatex_doc_to_text(doc, **_):
    return doc.get("prompt", VATEX_PROMPT)


def vatex_process_results(doc, result):
    rec = {"pred": result[0], "refs": doc_to_target(doc)}
    # corpus-level metrics share one stash (vatex/utils.py:90-117)
    return {"vatex_CIDEr": rec, "vatex_Bleu_4": rec,
            "vatex_ROUGE_L": rec}


def vatex_bleu4_aggregate(results: List[dict]) -> float:
    from aurora_tpu_torch.eval.metrics import bleu
    corpus, _ = bleu([r["pred"] for r in results],
                     [r["refs"] for r in results], n=4)
    return corpus


def vatex_rouge_aggregate(results: List[dict]) -> float:
    from aurora_tpu_torch.eval.metrics import rouge_l
    corpus, _ = rouge_l([r["pred"] for r in results],
                        [r["refs"] for r in results])
    return corpus


def register_vatex_task(dataset_path: str, name: str = "vatex_test",
                        max_new_tokens: int = 64):
    """VATEX English test captions: {"video_name"|"video_path": ...,
    "captions"|"enCap": [...]} jsonl."""
    return register_task(TaskConfig(
        name=name,
        dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.captions:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.captions:vatex_doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.captions:doc_to_target",
        process_results="aurora_tpu_torch.eval.tasks.captions:"
                        "vatex_process_results",
        metric_aggregations={
            "vatex_CIDEr": "aurora_tpu_torch.eval.tasks.captions:"
                           "cider_aggregate",
            "vatex_Bleu_4": "aurora_tpu_torch.eval.tasks.captions:"
                            "vatex_bleu4_aggregate",
            "vatex_ROUGE_L": "aurora_tpu_torch.eval.tasks.captions:"
                             "vatex_rouge_aggregate"},
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0},
    ))


# DetailCaps (lmms-eval tasks/detailcaps): detailed image captioning
# scored with the same CIDEr-D family
_path = os.environ.get("AURORA_DETAILCAPS", "data/detailcaps/test.jsonl")
if os.path.exists(_path):
    register_caption_task("detailcaps", _path, max_new_tokens=256)

_vatex_path = os.environ.get("AURORA_VATEX", "data/vatex/test.jsonl")
if os.path.exists(_vatex_path):
    register_vatex_task(_vatex_path)
