"""Judge-scored open-ended video QA (ActivityNet-QA / Video-ChatGPT
family).

Parity: the lmms-eval activitynetqa / videochatgpt tasks — a generation
task whose answers are graded by an LLM judge (yes/no correctness + 0-5
score), exactly the VDCScore machinery pointed at QA pairs. The judge is
our own serving engine (RuntimeEndpoint), as with VDC.

Dataset: local jsonl per question
  {"video_name": str, "question": str, "answer": str}
"""

from __future__ import annotations

import os
from typing import List

from aurora_tpu_torch.eval.api import TaskConfig, register_task

JUDGE_SYSTEM = (
    "You are an intelligent chatbot designed for evaluating the "
    "correctness of generative outputs for question-answer pairs. "
    "Your task is to compare the predicted answer with the correct "
    "answer and determine if they match meaningfully.")

JUDGE_PROMPT = (
    "Please evaluate the following video-based question-answer pair:\n\n"
    "Question: {question}\n"
    "Correct Answer: {answer}\n"
    "Predicted Answer: {pred}\n\n"
    "Provide your evaluation only as a yes/no and score where the score "
    "is an integer value between 0 and 5, with 5 indicating the highest "
    "meaningful match. Please generate the response in the form of a "
    "Python dictionary string with keys 'pred' and 'score', where value "
    "of 'pred' is a string of 'yes' or 'no' and value of 'score' is in "
    "INTEGER, not STRING. DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR "
    "EXPLANATION. For example, your response should look like this: "
    "{{'pred': 'yes', 'score': 4}}.")


def doc_to_visual(doc):
    from aurora_tpu_torch.eval.tasks.vdc import doc_to_visual as vdc_visual
    return vdc_visual(doc)


def doc_to_text(doc, **_):
    return (f"{doc['question']}\nAnswer the question based on the "
            "video.")


def doc_to_target(doc):
    return doc.get("answer", "")


def make_process_results(judge_url: str = None):
    """Online judging (videochatgpt utils parity); most runs use the
    generation-only + post-scoring flow instead."""
    from aurora_tpu_torch.eval.judge import JudgeClient, parse_judge_dict

    judge = JudgeClient(judge_url
                        or os.environ.get("AURORA_JUDGE_URL",
                                          "http://localhost:30000"))

    def process_results(doc, result):
        out = judge.chat(JUDGE_SYSTEM, JUDGE_PROMPT.format(
            question=doc["question"], answer=doc.get("answer", ""),
            pred=result[0]))
        parsed = parse_judge_dict(out)
        yes = str(parsed.get("pred", "no")).lower().startswith("y")
        return {"qa_acc": float(yes),
                "qa_score": float(parsed.get("score", 0))}

    return process_results


def process_results_generation_only(doc, result):
    return {"pred": result[0]}


def score_qa_predictions(preds: List[dict], judge_url: str):
    """Decoupled scoring over [{question, answer, pred}] records
    (videochatgpt evaluate.py two-step flow)."""
    scorer = make_process_results(judge_url)
    out = []
    for rec in preds:
        out.append(scorer({"question": rec["question"],
                           "answer": rec.get("answer", "")},
                          [rec["pred"]]))
    n = max(len(out), 1)
    return {"qa_acc": sum(o["qa_acc"] for o in out) / n,
            "qa_score": sum(o["qa_score"] for o in out) / n,
            "per_sample": out}


def register_videoqa_task(name: str, dataset_path: str,
                          max_new_tokens: int = 64):
    return register_task(TaskConfig(
        name=name,
        dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.videoqa:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.videoqa:doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.videoqa:doc_to_target",
        process_results=("aurora_tpu_torch.eval.tasks.videoqa:"
                         "process_results_generation_only"),
        metric_aggregations={},
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0},
    ))


for _name, _env in (("activitynetqa", "AURORA_ACTIVITYNETQA"),
                    ("videochatgpt_qa", "AURORA_VIDEOCHATGPT"),
                    # same generate-then-judge open-ended video QA
                    # (lmms-eval tasks/cvrr, tasks/worldqa)
                    ("cvrr", "AURORA_CVRR"),
                    ("worldqa", "AURORA_WORLDQA")):
    _path = os.environ.get(_env, f"data/{_name}/test.jsonl")
    if os.path.exists(_path):
        register_videoqa_task(_name, _path)
