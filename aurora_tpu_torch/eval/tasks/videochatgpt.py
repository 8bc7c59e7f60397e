"""Video-ChatGPT benchmark: judge-scored generation over five dimensions.

Parity: reference/src/lmms-eval/lmms_eval/tasks/videochatgpt/
(utils.py:108-426) — three tasks:
  * generic     — each QA judged on THREE axes (correctness, detailed
                  orientation, context), one judge call per axis
  * temporal    — temporal-accuracy judge
  * consistency — TWO questions per video with a common answer; the two
                  predictions are judged together for consistency

The judge prompts below are the benchmark's protocol definition and are
kept verbatim (changing a word changes the metric), like the VDC prompts.
The judge is our own serving engine (Llama-3.1-8B on aurora_tpu_torch serve,
EVAL.md:81-92 pattern) instead of the OpenAI API.

Dataset: local jsonl per question
  {"video_name": str, "question": str, "answer": str}           (generic/
                                                                 temporal)
  {"video_name": str, "question_1": str, "question_2": str,
   "answer": str}                                               (consistency)
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List

from aurora_tpu_torch.eval.api import TaskConfig, register_task

# --- judge protocol constants (videochatgpt/utils.py:218-426 verbatim) ---

JUDGE_SYSTEM: Dict[str, str] = {
    "correctness": (
        "You are an intelligent chatbot designed for evaluating the "
        "factual accuracy of generative outputs for video-based "
        "question-answer pairs. "
        "Your task is to compare the predicted answer with the correct "
        "answer and determine if they are factually consistent. Here's "
        "how you can accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Focus on the factual consistency between the predicted "
        "answer and the correct answer. The predicted answer should "
        "not contain any misinterpretations or misinformation.\n"
        "- The predicted answer must be factually accurate and align "
        "with the video content.\n"
        "- Consider synonyms or paraphrases as valid matches.\n"
        "- Evaluate the factual accuracy of the prediction compared to "
        "the answer."),
    "detailed_orientation": (
        "You are an intelligent chatbot designed for evaluating the "
        "detail orientation of generative outputs for video-based "
        "question-answer pairs. "
        "Your task is to compare the predicted answer with the correct "
        "answer and determine its level of detail, considering both "
        "completeness and specificity. Here's how you can accomplish "
        "the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Check if the predicted answer covers all major points from "
        "the video. The response should not leave out any key "
        "aspects.\n"
        "- Evaluate whether the predicted answer includes specific "
        "details rather than just generic points. It should provide "
        "comprehensive information that is tied to specific elements "
        "of the video.\n"
        "- Consider synonyms or paraphrases as valid matches.\n"
        "- Provide a single evaluation score that reflects the level "
        "of detail orientation of the prediction, considering both "
        "completeness and specificity."),
    "context": (
        "You are an intelligent chatbot designed for evaluating the "
        "contextual understanding of generative outputs for "
        "video-based question-answer pairs. "
        "Your task is to compare the predicted answer with the correct "
        "answer and determine if the generated response aligns with "
        "the overall context of the video content. Here's how you can "
        "accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Evaluate whether the predicted answer aligns with the "
        "overall context of the video content. It should not provide "
        "information that is out of context or misaligned.\n"
        "- The predicted answer must capture the main themes and "
        "sentiments of the video.\n"
        "- Consider synonyms or paraphrases as valid matches.\n"
        "- Provide your evaluation of the contextual understanding of "
        "the prediction compared to the answer."),
    "temporal": (
        "You are an intelligent chatbot designed for evaluating the "
        "temporal understanding of generative outputs for video-based "
        "question-answer pairs. "
        "Your task is to compare the predicted answer with the correct "
        "answer and determine if they correctly reflect the temporal "
        "sequence of events in the video content. Here's how you can "
        "accomplish the task:"
        "------"
        "##INSTRUCTIONS: "
        "- Focus on the temporal consistency between the predicted "
        "answer and the correct answer. The predicted answer should "
        "correctly reflect the sequence of events or details as they "
        "are presented in the video content.\n"
        "- Consider synonyms or paraphrases as valid matches, but only "
        "if the temporal order is maintained.\n"
        "- Evaluate the temporal accuracy of the prediction compared "
        "to the answer."),
    "consistency": (
        "You are an intelligent chatbot designed for evaluating the "
        "consistency of generative outputs for similar video-based "
        "question-answer pairs. "
        "You will be given two very similar questions, a common answer "
        "common to both the questions and predicted answers for the "
        "two questions ."
        "Your task is to compare the predicted answers for two very "
        "similar question, with a common correct answer and determine "
        "if they are consistent. Here's how you can accomplish the "
        "task:"
        "------"
        "##INSTRUCTIONS: "
        "- Focus on the consistency between the two predicted answers "
        "and the correct answer. Both predicted answers should "
        "correspond to the correct answer and to each other, and "
        "should not contain any contradictions or significant "
        "differences in the conveyed information.\n"
        "- Both predicted answers must be consistent with each other "
        "and the correct answer, in terms of the information they "
        "provide about the video content.\n"
        "- Consider synonyms or paraphrases as valid matches, but only "
        "if they maintain the consistency in the conveyed "
        "information.\n"
        "- Evaluate the consistency of the two predicted answers "
        "compared to the correct answer."),
}

_SCORE_NAME = {
    "correctness": "factual accuracy score",
    "detailed_orientation": "detail orientation score",
    "context": "contextual understanding score",
    "temporal": "temporal accuracy score",
}

_SCORE_LEVEL = {
    "correctness": "factual consistency",
    "detailed_orientation": "detail orientation",
    "context": "contextual understanding",
    "temporal": "temporal consistency",
}


def judge_user_prompt(axis: str, question: str, answer: str,
                      pred: str) -> str:
    name, level = _SCORE_NAME[axis], _SCORE_LEVEL[axis]
    return (
        "Please evaluate the following video-based question-answer "
        "pair:\n\n"
        f"Question: {question}\n"
        f"Correct Answer: {answer}\n"
        f"Predicted Answer: {pred}\n\n"
        f"Provide your evaluation only as a {name} where the {name} is "
        "an integer value between 0 and 5, with 5 indicating the "
        f"highest level of {level}. "
        "Please generate the response in the form of a Python "
        "dictionary string with keys 'score', where its value is the "
        f"{name} in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only "
        "provide the Python dictionary string. "
        "For example, your response should look like this: "
        "{''score': 4.8}.")


def judge_consistency_prompt(q1: str, q2: str, answer: str, pred1: str,
                             pred2: str) -> str:
    return (
        "Please evaluate the following video-based question-answer "
        "pair:\n\n"
        f"Question 1: {q1}\n"
        f"Question 2: {q2}\n"
        f"Correct Answer: {answer}\n"
        f"Predicted Answer to Question 1: {pred1}\n"
        f"Predicted Answer to Question 2: {pred2}\n\n"
        "Provide your evaluation only as a consistency score where the "
        "consistency score is an integer value between 0 and 5, with 5 "
        "indicating the highest level of consistency. "
        "Please generate the response in the form of a Python "
        "dictionary string with keys 'score', where its value is the "
        "consistency score in INTEGER, not STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only "
        "provide the Python dictionary string. "
        "For example, your response should look like this: "
        "{''score': 4.8}.")


def parse_score(review: str) -> int:
    """utils.py:428-443 parity: literal-eval the dict, 0 on failure."""
    try:
        return int(ast.literal_eval(review).get("score", 0))
    except Exception:  # noqa: BLE001 — any malformed review scores 0
        return 0


# --- task hooks -----------------------------------------------------------

def doc_to_visual(doc):
    from aurora_tpu_torch.eval.tasks.vdc import doc_to_visual as vdc_visual
    return vdc_visual(doc)


def doc_to_text(doc, **_):
    return doc["question"]


def doc_to_text_consistency(doc, **_):
    # each consistency doc carries ONE live question; its twin row has
    # the other (utils.py:84-100 semantics)
    q = doc.get("question_1")
    if not q or q == "None":
        q = doc["question_2"]
    return q


def doc_to_target(doc):
    return doc.get("answer", "")


def process_results_generation_only(doc, result):
    return {"pred": result[0]}


def _judge(judge_url=None):
    from aurora_tpu_torch.eval.judge import JudgeClient
    return JudgeClient(judge_url or os.environ.get(
        "AURORA_JUDGE_URL", "http://localhost:30000"))


def score_generic(preds: List[dict], judge_url: str = None):
    """[{question, answer, pred}] → correctness / detailed_orientation /
    context mean scores (one judge call per axis per sample,
    utils.py:108-141)."""
    judge = _judge(judge_url)
    axes = ("correctness", "detailed_orientation", "context")
    per = []
    for rec in preds:
        row = {}
        for axis in axes:
            out = judge.chat(JUDGE_SYSTEM[axis], judge_user_prompt(
                axis, rec["question"], rec.get("answer", ""),
                rec["pred"]))
            row[axis] = parse_score(out)
        per.append(row)
    n = max(len(per), 1)
    return {axis: sum(r[axis] for r in per) / n for axis in axes} | {
        "per_sample": per}


def score_temporal(preds: List[dict], judge_url: str = None):
    judge = _judge(judge_url)
    per = []
    for rec in preds:
        out = judge.chat(JUDGE_SYSTEM["temporal"], judge_user_prompt(
            "temporal", rec["question"], rec.get("answer", ""),
            rec["pred"]))
        per.append(parse_score(out))
    return {"temporal": sum(per) / max(len(per), 1), "per_sample": per}


def pair_consistency(records: List[dict]) -> List[dict]:
    """Pair Q1/Q2 rows by video_name (utils.py:182-215
    aggregate_submissions_consistency semantics)."""
    combined, used = [], set()
    for i, first in enumerate(records):
        if i in used or not first.get("question_1") \
                or first["question_1"] == "None":
            continue
        for j, second in enumerate(records):
            if j <= i or j in used:
                continue
            if second.get("video_name") == first.get("video_name") \
                    and second.get("question_2") \
                    and second["question_2"] != "None":
                combined.append({
                    "video_name": first["video_name"],
                    "question_1": first["question_1"],
                    "question_2": second["question_2"],
                    "answer": first.get("answer", ""),
                    "pred1": first["pred"], "pred2": second["pred"]})
                used |= {i, j}
                break
    return combined


def score_consistency(records: List[dict], judge_url: str = None):
    """records: per-question rows with preds (paired here), or
    pre-paired rows with pred1/pred2."""
    if records and "pred1" not in records[0]:
        records = pair_consistency(records)
    judge = _judge(judge_url)
    per = []
    for rec in records:
        out = judge.chat(
            JUDGE_SYSTEM["consistency"],
            judge_consistency_prompt(
                rec["question_1"], rec["question_2"],
                rec.get("answer", ""), rec["pred1"], rec["pred2"]))
        per.append(parse_score(out))
    return {"consistency": sum(per) / max(len(per), 1),
            "per_sample": per}


def register_videochatgpt_tasks(base_dir: str,
                                max_new_tokens: int = 128):
    """Register videochatgpt_{generic,temporal,consistency} from jsonl
    files under base_dir (generation-only; judge scoring is the
    decoupled score_* step, matching the reference's two-phase flow)."""
    out = []
    for dim in ("generic", "temporal", "consistency"):
        path = os.path.join(base_dir, f"{dim}.jsonl")
        to_text = ("aurora_tpu_torch.eval.tasks.videochatgpt:"
                   + ("doc_to_text_consistency" if dim == "consistency"
                      else "doc_to_text"))
        out.append(register_task(TaskConfig(
            name=f"videochatgpt_{dim}",
            dataset_path=path,
            doc_to_visual="aurora_tpu_torch.eval.tasks.videochatgpt:"
                          "doc_to_visual",
            doc_to_text=to_text,
            doc_to_target="aurora_tpu_torch.eval.tasks.videochatgpt:"
                          "doc_to_target",
            process_results="aurora_tpu_torch.eval.tasks.videochatgpt:"
                            "process_results_generation_only",
            metric_aggregations={},
            generation_kwargs={"max_new_tokens": max_new_tokens,
                               "temperature": 0.0})))
    return out


_base = os.environ.get("AURORA_VIDEOCHATGPT_DIR", "data/videochatgpt")
if os.path.isdir(_base):
    register_videochatgpt_tasks(_base)

# Video Detail Description (lmms-eval tasks/video_detail_description):
# the videochatgpt GENERIC judge protocol (correctness/detail/context
# axes) over its own caption set — one jsonl, same two-phase flow
_vdd = os.environ.get("AURORA_VIDEO_DETAIL",
                      "data/video_detail_description/test.jsonl")
if os.path.exists(_vdd):
    register_task(TaskConfig(
        name="video_detail_description",
        dataset_path=_vdd,
        doc_to_visual="aurora_tpu_torch.eval.tasks.videochatgpt:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.videochatgpt:doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.videochatgpt:doc_to_target",
        process_results="aurora_tpu_torch.eval.tasks.videochatgpt:"
                        "process_results_generation_only",
        metric_aggregations={},
        generation_kwargs={"max_new_tokens": 256, "temperature": 0.0}))
