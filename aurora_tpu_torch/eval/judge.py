"""VDCScore LLM judge client.

Protocol parity: src/lmms-eval/lmms_eval/tasks/vdc/utils.py:201-306 — per
generated caption, for each ground-truth QA pair the judge (Llama-3.1-8B in
the reference, docs/auroracap/EVAL.md:81-92) is asked twice:
  1. answer the question FROM the caption alone;
  2. compare the predicted answer vs the GT answer → {'pred': yes/no,
     'score': 0-5}.
The judge endpooint is an OpenAI-chat server — ours
(aurora_tpu_torch.cli.serve) or any compatible one; the reference's SGLang
RuntimeEndpoint at localhost:30000 maps to base_url http://localhost:30000.

The system/user prompt strings reproduce the reference verbatim — they are
the metric's definition; changing a word changes the benchmark.
"""

from __future__ import annotations

import ast
import json
from typing import Dict, List, Optional

ANSWER_SYSTEM = (
    "You are an intelligent chatbot designed for providing accurate "
    "answers to questions related to the content based on a detailed "
    "description of a video or image."
    "Here's how you can accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Read the detailed description carefully.\n"
    "- Answer the question only based on the detailed description.\n"
    "- The answer should be a short sentence or phrase.\n")

ANSWER_USER = (
    "Please provide accurate answers to questions related to the content "
    "based on a detailed description of a video or image:\n\n"
    "detailed description: {caption}, question: {question}"
    "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide "
    "short but accurate answer.")

SCORE_SYSTEM = (
    "You are an intelligent chatbot designed for evaluating the "
    "correctness of generative outputs for question-answer pairs. "
    "Your task is to compare the predicted answer with the correct answer "
    "and determine if they match meaningfully. Here's how you can "
    "accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Focus on the meaningful match between the predicted answer and the "
    "correct answer.\n"
    "- Consider synonyms or paraphrases as valid matches.\n"
    "- Evaluate the correctness of the prediction compared to the answer.")

SCORE_USER = (
    "Please evaluate the following video-based question-answer pair:\n\n"
    "Question: {question}\n"
    "Correct Answer: {answer}\n"
    "Predicted Answer: {pred_answer}\n\n"
    "Provide your evaluation only as a yes/no and score where the score "
    "is an integer value between 0 and 5, with 5 indicating the highest "
    "meaningful match. "
    "Please generate the response in the form of a Python dictionary "
    "string with keys 'pred' and 'score', where value of 'pred' is  a "
    "string of 'yes' or 'no' and value of 'score' is in INTEGER, not "
    "STRING."
    "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide "
    "the Python dictionary string. "
    "For example, your response should look like this: "
    "{{'pred': 'yes', 'score': 4.8}}.")


class JudgeClient:
    """Minimal OpenAI-chat client (urllib; no extra deps)."""

    def __init__(self, base_url: str = "http://localhost:30000",
                 max_tokens: int = 256, timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.max_tokens = max_tokens
        self.timeout = timeout

    def chat(self, system: str, user: str, *,
             temperature: float = 0.0,
             max_tokens: Optional[int] = None) -> str:
        from aurora_tpu_torch.utils.http import chat_completion
        return chat_completion(
            self.base_url,
            [{"role": "system", "content": system},
             {"role": "user", "content": user}],
            max_tokens=max_tokens or self.max_tokens,
            temperature=temperature, timeout=self.timeout)

    # -- VDCScore steps ------------------------------------------------------

    def answer_from_caption(self, caption: str, question: str) -> str:
        return self.chat(ANSWER_SYSTEM, ANSWER_USER.format(
            caption=caption, question=question)).strip()

    def score_qa(self, question: str, answer: str,
                 pred_answer: str) -> Dict:
        text = self.chat(SCORE_SYSTEM, SCORE_USER.format(
            question=question, answer=answer, pred_answer=pred_answer))
        return parse_judge_dict(text)


def parse_judge_dict(text: str) -> Dict:
    """ast.literal_eval with rescue for chatty judges
    (vdc/utils.py:256 semantics, hardened)."""
    text = text.strip()
    try:
        out = ast.literal_eval(text)
        if isinstance(out, dict):
            return out
    except (ValueError, SyntaxError):
        pass
    start = text.find("{")
    end = text.rfind("}")
    if start >= 0 and end > start:
        try:
            out = ast.literal_eval(text[start:end + 1])
            if isinstance(out, dict):
                return out
        except (ValueError, SyntaxError):
            pass
    raise ValueError(f"unparseable judge output: {text!r}")


def vdcscore_for_caption(judge: JudgeClient, caption: str,
                         qa_list: List[Dict]) -> Dict[str, float]:
    """Full VDCScore for one caption (llm_eval parity, utils.py:261-306):
    answer every GT question from the caption, judge each answer,
    average score and yes-rate."""
    scores, accs = [], []
    for qa in qa_list:
        pred_answer = judge.answer_from_caption(caption, qa["question"])
        try:
            resp = judge.score_qa(qa["question"], qa["answer"],
                                  pred_answer)
        except ValueError:
            continue
        if "pred" in resp and "score" in resp:
            scores.append(float(resp["score"]))
            accs.append(1.0 if str(resp["pred"]).lower() == "yes" else 0.0)
    if not scores:
        return {"score": 0.0, "acc": 0.0}
    return {"score": sum(scores) / len(scores),
            "acc": sum(accs) / len(accs)}
