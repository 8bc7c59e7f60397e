"""Judge-scored open-ended image benchmarks: MM-Vet and
LLaVA-in-the-Wild.

Parity targets: lmms-eval `tasks/mmvet/utils.py` (an LLM judge grades
each prediction against the ground truth on a 0.0-1.0 scale) and
`tasks/llava_in_the_wild/utils.py` (the judge rates a reference answer
and the model's answer 1-10 given image context; the metric is the
score ratio in %). The reference grades with the OpenAI API; here the
judge is our own serving engine (RuntimeEndpoint, as with VDCScore),
and the prompts are faithful re-statements of each protocol rather
than byte copies of the closed-source grader few-shots.

Datasets (local jsonl):
  mmvet:      {"image", "question", "answer"}  — answer may contain
              "<AND>" / "<OR>" separated acceptable variants
  llava_wild: {"image", "question", "gpt_answer", "context"}
"""

from __future__ import annotations

import os
import re
from typing import List

from aurora_tpu_torch.eval.api import TaskConfig, register_task

MMVET_SYSTEM = (
    "Compare the ground truth and prediction from AI models, to give a "
    "correctness score for the prediction. Different answer styles "
    "count as correct as long as the meaning matches the ground truth. "
    "If the ground truth contains answers joined by <AND>, all parts "
    "are required; if joined by <OR>, any one part suffices.")

MMVET_PROMPT = (
    "Question: {question}\n"
    "Ground truth: {answer}\n"
    "Prediction: {pred}\n\n"
    "Output only a single correctness score between 0.0 and 1.0, where "
    "1.0 means fully correct and 0.0 means completely wrong. Partial "
    "credit is allowed (e.g. 0.5). Do not output anything else.")

WILD_SYSTEM = (
    "You are a helpful and precise assistant for checking the quality "
    "of the answer.")

WILD_PROMPT = (
    "[Context]\n{context}\n\n[Question]\n{question}\n\n"
    "[Assistant 1]\n{reference}\n\n[End of Assistant 1]\n\n"
    "[Assistant 2]\n{pred}\n\n[End of Assistant 2]\n\n"
    "We would like to request your feedback on the performance of two "
    "AI assistants in response to the user question displayed above, "
    "based on the context. Please rate the helpfulness, relevance, "
    "accuracy, level of details of their responses. Each assistant "
    "receives an overall score on a scale of 1 to 10, where a higher "
    "score indicates better overall performance. Please first output a "
    "single line containing only two values indicating the scores for "
    "Assistant 1 and 2, respectively, separated by a space.")


def doc_to_visual(doc):
    base = doc.get("_root", "")
    return [os.path.join(base, doc["image"])]


def doc_to_text(doc, **_):
    return doc["question"]


def doc_to_target(doc):
    return doc.get("answer") or doc.get("gpt_answer", "")


def process_results_generation_only(doc, result):
    return {"pred": result[0]}


def _first_float(text: str, default: float = 0.0) -> float:
    m = re.search(r"\d+(?:\.\d+)?", text)
    return float(m.group(0)) if m else default


def score_mmvet_predictions(preds: List[dict], judge_url: str):
    """Decoupled scoring over [{question, answer, pred}] records.
    Returns mean correctness in % (the MM-Vet total score)."""
    from aurora_tpu_torch.eval.judge import JudgeClient
    judge = JudgeClient(judge_url)
    out = []
    for rec in preds:
        raw = judge.chat(MMVET_SYSTEM, MMVET_PROMPT.format(
            question=rec["question"], answer=rec.get("answer", ""),
            pred=rec["pred"]))
        out.append(min(max(_first_float(raw), 0.0), 1.0))
    n = max(len(out), 1)
    return {"mmvet_score": 100.0 * sum(out) / n, "per_sample": out}


def score_llava_wild_predictions(preds: List[dict], judge_url: str):
    """Decoupled scoring over [{question, gpt_answer, context, pred}].
    Metric: 100 * mean(assistant2) / mean(assistant1) — the
    llava-bench relative score."""
    from aurora_tpu_torch.eval.judge import JudgeClient
    judge = JudgeClient(judge_url)
    s1, s2, rows = [], [], []
    for rec in preds:
        raw = judge.chat(WILD_SYSTEM, WILD_PROMPT.format(
            context=rec.get("context", ""), question=rec["question"],
            reference=rec.get("gpt_answer", ""), pred=rec["pred"]))
        nums = re.findall(r"\d+(?:\.\d+)?", raw.splitlines()[0]
                          if raw else "")
        a, b = (float(nums[0]), float(nums[1])) if len(nums) >= 2 \
            else (1.0, 0.0)
        s1.append(a)
        s2.append(b)
        rows.append({"ref": a, "pred": b})
    ref = max(sum(s1) / max(len(s1), 1), 1e-9)
    got = sum(s2) / max(len(s2), 1)
    return {"llava_wild_relative": 100.0 * got / ref,
            "per_sample": rows}


def register_image_judge_task(name: str, dataset_path: str,
                              max_new_tokens: int = 256):
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.image_judge:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.image_judge:doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.image_judge:doc_to_target",
        process_results=("aurora_tpu_torch.eval.tasks.image_judge:"
                         "process_results_generation_only"),
        metric_aggregations={},
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0}))


for _name, _env, _default in (
        ("mmvet", "AURORA_MMVET", "data/mmvet/test.jsonl"),
        ("llava_in_the_wild", "AURORA_LLAVA_WILD",
         "data/llava_in_the_wild/test.jsonl"),
        # same generate-then-judge protocol (lmms-eval dirs:
        # tasks/llava-bench-coco, tasks/llava_wilder,
        # tasks/wild_vision_bench, tasks/vibe_eval,
        # tasks/multilingual-llava-bench-in-the-wild)
        ("llava_bench_coco", "AURORA_LLAVA_BENCH_COCO",
         "data/llava_bench_coco/test.jsonl"),
        ("llava_wilder", "AURORA_LLAVA_WILDER",
         "data/llava_wilder/test.jsonl"),
        ("wild_vision_bench", "AURORA_WILD_VISION",
         "data/wild_vision_bench/test.jsonl"),
        ("vibe_eval", "AURORA_VIBE_EVAL", "data/vibe_eval/test.jsonl"),
        ("llava_wild_multilingual", "AURORA_LLAVA_WILD_ML",
         "data/llava_wild_multilingual/test.jsonl")):
    _path = os.environ.get(_env, _default)
    if os.path.exists(_path):
        register_image_judge_task(_name, _path)
