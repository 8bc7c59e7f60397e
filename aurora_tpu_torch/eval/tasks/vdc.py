"""VDC (Video Detailed Captioning) benchmark tasks.

Parity: src/lmms-eval/lmms_eval/tasks/vdc/ — five subsets
(camera / short / background / main_object / detailed), each asking for a
caption from a randomly chosen subset-specific prompt, scored by the
VDCScore LLM-judge protocol (aurora_tpu_torch.eval.judge).

Datasets are local jsonl files (the reference pulls `wchai/lmms_VDC_test`
from the HF hub — zero-egress environments point `AURORA_VDC_DIR` at a
local copy): one record per video with fields
  {"video_name": str, "caption": str, "qa_list": [{question, answer}, ...]}
and videos as <video_name>.mp4 (or .MP4/.mkv/npy/frame-dir) beside them.

Prompt pools are the EXACT benchmark constants (vdc_prompts.py, verbatim
from vdc/utils.py:51-152); override with `AURORA_VDC_PROMPTS=<json file>`
mapping subset → list[str] for custom protocols. Unlike the reference's
global `random.choice` (utils.py:172-194), the choice is seeded per
document (video_name) so generated captions are reproducible run-to-run
while still drawing uniformly from the pool.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List

from aurora_tpu_torch.eval.api import TaskConfig, register_task
from aurora_tpu_torch.eval.tasks.vdc_prompts import POOLS

VDC_DIR = os.environ.get("AURORA_VDC_DIR", "data/vdc")

_PROMPTS: Dict[str, List[str]] = dict(POOLS)

_override = os.environ.get("AURORA_VDC_PROMPTS")
if _override and os.path.exists(_override):
    with open(_override) as f:
        _PROMPTS.update(json.load(f))

SUBSETS = ("camera", "short", "background", "main_object", "detailed")


def doc_to_visual(doc):
    """vdc_doc_to_visual parity (utils.py:157-168) + npy/frame-dir
    fallbacks for hermetic runs."""
    base = os.path.join(doc.get("_root", VDC_DIR), doc["video_name"])
    for ext in (".mp4", ".MP4", ".mkv", ".npy", ".npz", ""):
        p = base + ext
        if os.path.exists(p):
            return [p]
    raise FileNotFoundError(f"no video found for {doc['video_name']!r} "
                            f"under {doc.get('_root', VDC_DIR)}")


def _doc_to_text(subset):
    def fn(doc, **_):
        pool = _PROMPTS[subset]
        key = f"{subset}:{doc.get('video_name', '')}".encode()
        idx = int.from_bytes(hashlib.sha1(key).digest()[:4], "little")
        return pool[idx % len(pool)]
    return fn


doc_to_text_camera = _doc_to_text("camera")
doc_to_text_short = _doc_to_text("short")
doc_to_text_background = _doc_to_text("background")
doc_to_text_main_object = _doc_to_text("main_object")
doc_to_text_detailed = _doc_to_text("detailed")


def doc_to_target(doc):
    return doc["caption"]


def make_process_results(judge_url: str = "http://localhost:30000"):
    """Online judging (vdc_process_results_generic parity). Most runs use
    generation_only + post_eval instead (EVAL.md decoupled flow)."""
    from aurora_tpu_torch.eval.judge import JudgeClient, vdcscore_for_caption

    judge = JudgeClient(os.environ.get("AURORA_JUDGE_URL", judge_url))

    def process_results(doc, result):
        pred = result[0]
        out = vdcscore_for_caption(judge, pred, doc["qa_list"])
        return {"llm_eval_score": out["score"], "llm_eval_acc": out["acc"]}

    return process_results


def process_results_generation_only(doc, result):
    """Dump-only mode for the decoupled post_eval flow
    (post_eval/process_vdc_result.py)."""
    return {"pred": result[0]}


for subset in SUBSETS:
    register_task(TaskConfig(
        name=f"vdc_{subset}_test",
        dataset_path=os.path.join(VDC_DIR, f"{subset}.jsonl"),
        doc_to_visual="aurora_tpu_torch.eval.tasks.vdc:doc_to_visual",
        doc_to_text=f"aurora_tpu_torch.eval.tasks.vdc:doc_to_text_{subset}",
        doc_to_target="aurora_tpu_torch.eval.tasks.vdc:doc_to_target",
        process_results=(
            "aurora_tpu_torch.eval.tasks.vdc:process_results_generation_only"),
        metric_aggregations={"pred": "aurora_tpu_torch.eval.tasks.vdc:agg_noop"},
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0.0},
    ))


def agg_noop(results):
    return float(len(results))
