"""Multiple-choice video benchmarks: Video-MME, MVBench, EgoSchema,
NExT-QA, PerceptionTest, TempCompass.

Parity: reference/src/lmms-eval/lmms_eval/tasks/{videomme,mvbench,
egoschema,nextqa,perceptiontest,tempcompass}/utils.py — prompt
construction, answer-letter extraction and accuracy aggregation follow
each benchmark's protocol exactly (prompt strings are the benchmarks'
definitions and are kept verbatim). Each family registers both a
generation task (letter extraction over the decoded text) and — where
the reference ships one — an `_ppl` variant scored by per-choice
loglikelihood through the multimodal loglikelihood path
(output_type="loglikelihood").

Datasets are local jsonl; field names mirror each benchmark's HF schema
(see register_* docstrings).
"""

from __future__ import annotations

import os
import re
import string
from typing import List

from aurora_tpu_torch.eval.api import TaskConfig, register_task

_LETTERS = string.ascii_uppercase


# --- answer extraction protocols -------------------------------------------

def extract_characters_regex(s: str) -> str:
    """videomme/utils.py:336-356 verbatim semantics: strip known answer
    prefixes, reject long non-letter ramble, first [ABCD] hit.

    NOTE the adjacent-string concatenation in the last two entries
    ("The best option isThe correct option is", "Best answer:Best
    option:") reproduces the reference list BYTE-FOR-BYTE
    (videomme/utils.py:343-344 has the same missing commas) — so e.g.
    "Best answer: C" scores as "B" there too. Kept deliberately: the
    benchmark's published numbers were computed with this extractor,
    and separating the prefixes would silently shift our scores off
    the reference's."""
    s = s.strip()
    answer_prefixes = [
        "The best answer is",
        "The correct answer is",
        "The answer is",
        "The answer",
        "The best option is" "The correct option is",  # sic — see above
        "Best answer:" "Best option:",                 # sic — see above
    ]
    for answer_prefix in answer_prefixes:
        s = s.replace(answer_prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCD]", s):
        return ""
    matches = re.search(r"[ABCD]", s)
    if matches is None:
        return ""
    return matches[0]


def mcq_acc(answer: str, pred: str) -> int:
    """mvbench/utils.py:105-155 semantics: normalize both sides to an
    option letter (or cleaned text) and exact-match."""
    period_strip = re.compile(r"(?!<=\d)(\.)(?!\d)")
    comma_strip = re.compile(r"(\d)(,)(\d)")
    punct = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+",
             "\\", "_", "-", ">", "<", "@", "`", ",", "?", "!"]

    def process_punct(text):
        out = text
        for p in punct:
            if (p + " " in text or " " + p in text) \
                    or re.search(comma_strip, text) is not None:
                out = out.replace(p, "")
            else:
                out = out.replace(p, " ")
        return period_strip.sub("", out, re.UNICODE)

    def process(ans):
        m = re.match(r"^([A-E])\.\s*(.+)$", ans.strip(), re.IGNORECASE)
        if m:
            return m.group(1).upper()
        ans = ans.replace("\n", " ").replace("\t", " ").strip()
        ans = process_punct(ans)
        ans = ans.strip("'").strip('"').strip(")").strip("(")
        ans = ans.strip().lower()
        lm = re.search(r"\b([A-E])\b", ans, re.IGNORECASE)
        if lm:
            return lm.group(1).upper()
        return ans

    return int(process(pred) == process(answer))


def parse_multi_choice_response(response: str,
                                all_choices: List[str]) -> str:
    """MMMU-style parser (egoschema/nextqa utils.py:101-160): bracketed
    '(A)', then 'A ', then 'A.'; falls back to the last mention."""
    for char in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(char)
    response = " " + response + " "
    candidates = []
    for choice in all_choices:
        if f"({choice})" in response:
            candidates.append(choice)
    if not candidates:
        for choice in all_choices:
            if f"{choice} " in response:
                candidates.append(choice)
    if not candidates:
        for choice in all_choices:
            if f"{choice}." in response:
                candidates.append(choice)
    if not candidates:
        # reference fallback is random.choice(all_choices) — uniform
        # expected credit for EVERY unparseable response (mmmu
        # utils.py:308). We keep that semantics but seed by the
        # response text so runs stay reproducible. (The old behavior —
        # 'A' for empty, '' otherwise — gave free credit on A-gold
        # docs for degenerate runs and zero elsewhere.)
        import random as _random
        return _random.Random(response).choice(all_choices)
    if len(candidates) > 1:
        # last mentioned wins (reference start_indexes argmax)
        starts = [response.rfind(f"({c})") if f"({c})" in response
                  else response.rfind(f"{c} ") for c in candidates]
        return candidates[starts.index(max(starts))]
    return candidates[0]


# --- shared hooks ----------------------------------------------------------

def doc_to_visual(doc):
    from aurora_tpu_torch.eval.tasks.vdc import doc_to_visual as vdc_visual
    return vdc_visual(doc)


def ppl_argmax(lls: List[float]) -> int:
    """loglikelihood list → choice index (reference mc_ppl picks the
    lowest perplexity ⇔ highest total loglikelihood)."""
    return max(range(len(lls)), key=lambda i: lls[i])


# --- Video-MME -------------------------------------------------------------

VIDEOMME_OPTION_PROMPT = (
    "Select the best answer to the following multiple-choice question "
    "based on the video and the subtitles. Respond with only the "
    "letter (A, B, C, or D) of the correct option.")
VIDEOMME_POST_PROMPT = "The best answer is:"


def videomme_doc_to_text(doc, **_):
    # utils.py:191-198: question + str(options list) between the two
    # protocol prompts (the stringified list IS the protocol)
    question = doc["question"] + "\n" + str(doc["options"])
    return (VIDEOMME_OPTION_PROMPT + "\n" + question + "\n"
            + VIDEOMME_POST_PROMPT)


def videomme_process_results(doc, result):
    pred = extract_characters_regex(result[0])
    return {"videomme_score": {
        "duration": doc.get("duration", "short"),
        "pred_answer": pred, "answer": doc["answer"]}}


def videomme_aggregate(results: List[dict]) -> float:
    """Overall accuracy in % (utils.py:388-436 reduces per-duration
    matrices to the same ratio; per-duration splits land in samples)."""
    answered = len(results)
    correct = sum(r["pred_answer"] == r["answer"] for r in results)
    return 100 * correct / answered if answered else 0.0


def register_videomme(dataset_path: str, name: str = "videomme",
                      max_new_tokens: int = 16):
    """jsonl rows: {"video_name"|"videoID", "question", "options":
    ["A. ...", ...], "answer": "A", "duration": "short|medium|long"}."""
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.video_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.video_mc:videomme_doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.video_mc:videomme_target",
        process_results="aurora_tpu_torch.eval.tasks.video_mc:"
                        "videomme_process_results",
        metric_aggregations={"videomme_score":
                             "aurora_tpu_torch.eval.tasks.video_mc:"
                             "videomme_aggregate"},
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0}))


def videomme_target(doc):
    return doc["answer"]


# --- MVBench ---------------------------------------------------------------

MVBENCH_POST_PROMPT = ("Answer with the option's letter from the given "
                       "choices directly.")


def mvbench_doc_to_text(doc, **_):
    # utils.py:93-102
    option_prompt = ""
    for i, option in enumerate(doc["candidates"]):
        option_prompt += f"{_LETTERS[i]}. {option}\n"
    return doc["question"] + "\n" + option_prompt + MVBENCH_POST_PROMPT


def mvbench_target(doc):
    return doc["answer"]


def mvbench_process_results(doc, result):
    gt_letter = None
    for i, cand in enumerate(doc["candidates"]):
        if cand == doc["answer"]:
            gt_letter = _LETTERS[i]
            break
    score = mcq_acc(f"{gt_letter}. {doc['answer']}", result[0])
    return {"mvbench_accuracy": {
        "pred_answer": result[0].strip(), "gt_letter": gt_letter,
        "score": score}}


def mvbench_aggregate(results: List[dict]) -> float:
    answered = sum(1 for r in results if r["pred_answer"] != "")
    correct = sum(r["score"] for r in results if r["pred_answer"] != "")
    return 100 * correct / answered if answered else 0.0


def register_mvbench(dataset_path: str, name: str = "mvbench",
                     max_new_tokens: int = 16):
    """jsonl rows: {"video_name"|"video", "question", "candidates":
    [...], "answer": "<full option text>"}."""
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.video_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.video_mc:mvbench_doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.video_mc:mvbench_target",
        process_results="aurora_tpu_torch.eval.tasks.video_mc:"
                        "mvbench_process_results",
        metric_aggregations={"mvbench_accuracy":
                             "aurora_tpu_torch.eval.tasks.video_mc:"
                             "mvbench_aggregate"},
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0}))


# --- EgoSchema (generation + mc_ppl) ---------------------------------------

EGOSCHEMA_POST_PROMPT = ("\nAnswer with the option's letter from the "
                         "given choices directly.")


def egoschema_doc_to_text(doc, **_):
    # utils.py:50-66
    question = doc["question"]
    for op in doc["option"]:
        question += "\n" + op
    return question + EGOSCHEMA_POST_PROMPT


def egoschema_doc_to_text_ppl(doc, **_):
    return doc["question"]


def egoschema_doc_to_choice(doc):
    return [str(o) for o in doc["option"]]


def egoschema_target(doc):
    return doc["answer"]


def egoschema_process_results(doc, result):
    letters = [_LETTERS[i] for i in range(len(doc["option"]))]
    pred = parse_multi_choice_response(result[0], letters)
    gt = _LETTERS[int(doc["answer"])]
    return {"egoschema_accuracy": float(pred == gt)}


def egoschema_process_results_ppl(doc, result):
    lls = result[0]
    return {"egoschema_accuracy": float(
        ppl_argmax(lls) == int(doc["answer"]))}


def register_egoschema(dataset_path: str, name: str = "egoschema",
                       max_new_tokens: int = 16):
    """jsonl rows: {"video_idx"|"video_name", "question", "option":
    [5 strings], "answer": int}. Registers `name` (generation) and
    `name_ppl` (per-choice loglikelihood)."""
    gen = register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.video_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.video_mc:"
                    "egoschema_doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.video_mc:egoschema_target",
        process_results="aurora_tpu_torch.eval.tasks.video_mc:"
                        "egoschema_process_results",
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0}))
    ppl = register_task(TaskConfig(
        name=f"{name}_ppl", dataset_path=dataset_path,
        output_type="loglikelihood",
        doc_to_visual="aurora_tpu_torch.eval.tasks.video_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.video_mc:"
                    "egoschema_doc_to_text_ppl",
        doc_to_choice="aurora_tpu_torch.eval.tasks.video_mc:"
                      "egoschema_doc_to_choice",
        doc_to_target="aurora_tpu_torch.eval.tasks.video_mc:egoschema_target",
        process_results="aurora_tpu_torch.eval.tasks.video_mc:"
                        "egoschema_process_results_ppl"))
    return gen, ppl


# --- NExT-QA (multiple choice) ---------------------------------------------

def nextqa_doc_to_text_mc(doc, **_):
    # nextqa/utils.py:59-70
    question = [doc["question"].strip()]
    for i in range(5):
        question.append(f"{_LETTERS[i]}. {doc[f'a{i}'].strip()}")
    return "\n".join(question) + EGOSCHEMA_POST_PROMPT


def nextqa_doc_to_choice(doc):
    return [doc[f"a{i}"].strip() for i in range(5)]


def nextqa_target(doc):
    return doc["answer"]


def nextqa_mc_process_results(doc, result):
    pred = parse_multi_choice_response(result[0], list(_LETTERS[:5]))
    return {"exact_match": float(pred == _LETTERS[int(doc["answer"])])}


def nextqa_mc_process_results_ppl(doc, result):
    return {"exact_match": float(
        ppl_argmax(result[0]) == int(doc["answer"]))}


def register_nextqa(dataset_path: str, name: str = "nextqa_mc",
                    max_new_tokens: int = 16):
    """jsonl rows: {"video"|"video_name", "question", "a0".."a4",
    "answer": int}. Registers `name` and `name_ppl`."""
    gen = register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.video_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.video_mc:"
                    "nextqa_doc_to_text_mc",
        doc_to_target="aurora_tpu_torch.eval.tasks.video_mc:nextqa_target",
        process_results="aurora_tpu_torch.eval.tasks.video_mc:"
                        "nextqa_mc_process_results",
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0}))
    ppl = register_task(TaskConfig(
        name=f"{name}_ppl", dataset_path=dataset_path,
        output_type="loglikelihood",
        doc_to_visual="aurora_tpu_torch.eval.tasks.video_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.video_mc:"
                    "nextqa_doc_to_text_mc",
        doc_to_choice="aurora_tpu_torch.eval.tasks.video_mc:"
                      "nextqa_doc_to_choice",
        doc_to_target="aurora_tpu_torch.eval.tasks.video_mc:nextqa_target",
        process_results="aurora_tpu_torch.eval.tasks.video_mc:"
                        "nextqa_mc_process_results_ppl"))
    return gen, ppl


# --- PerceptionTest --------------------------------------------------------

def perceptiontest_doc_to_text(doc, **_):
    # perceptiontest/val/utils.py:49-77
    question = doc["question"]
    for i, op in enumerate(doc["options"]):
        question += "\n" + f"{_LETTERS[i]}. " + op
    return question + EGOSCHEMA_POST_PROMPT


def perceptiontest_doc_to_choice(doc):
    return [str(o) for o in doc["options"]]


def perceptiontest_target(doc):
    return doc["answer_id"]


def perceptiontest_process_results(doc, result):
    m = re.search(r"\b([A-D])\b", result[0].strip())
    pred_id = _LETTERS.index(m.group(1)) if m else -1
    return {"accuracy": float(pred_id == int(doc["answer_id"]))}


def perceptiontest_process_results_ppl(doc, result):
    return {"accuracy": float(
        ppl_argmax(result[0]) == int(doc["answer_id"]))}


def register_perceptiontest(dataset_path: str,
                            name: str = "perceptiontest_mc",
                            max_new_tokens: int = 16):
    """jsonl rows: {"video_name", "question", "options": [...],
    "answer_id": int}. Registers `name` and `name_ppl`."""
    gen = register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.video_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.video_mc:"
                    "perceptiontest_doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.video_mc:"
                      "perceptiontest_target",
        process_results="aurora_tpu_torch.eval.tasks.video_mc:"
                        "perceptiontest_process_results",
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0}))
    ppl = register_task(TaskConfig(
        name=f"{name}_ppl", dataset_path=dataset_path,
        output_type="loglikelihood",
        doc_to_visual="aurora_tpu_torch.eval.tasks.video_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.video_mc:"
                    "perceptiontest_doc_to_text",
        doc_to_choice="aurora_tpu_torch.eval.tasks.video_mc:"
                      "perceptiontest_doc_to_choice",
        doc_to_target="aurora_tpu_torch.eval.tasks.video_mc:"
                      "perceptiontest_target",
        process_results="aurora_tpu_torch.eval.tasks.video_mc:"
                        "perceptiontest_process_results_ppl"))
    return gen, ppl


# --- TempCompass (multi-choice subset) -------------------------------------

TEMPCOMPASS_PRE = ("Please select the best answer from the options "
                   "below and ONLY return the letter.\n")


def tempcompass_doc_to_text(doc, **_):
    # tempcompass multi-choice: the doc's question already embeds the
    # lettered options (tempcompass/utils.py doc["question"])
    return TEMPCOMPASS_PRE + doc["question"]


def tempcompass_target(doc):
    return doc["answer"]


def tempcompass_process_results(doc, result):
    """tempcompass/utils.py rule-based match: exact answer text, or the
    answer's letter, or 'letter. text' prefix."""
    pred, answer = result[0].strip(), doc["answer"].strip()
    m = re.match(r"^([A-D])\.\s*(.*)$", answer)
    letter = m.group(1) if m else answer[:1]
    body = m.group(2) if m else answer
    hit = (pred == answer or pred == letter
           or pred.startswith(f"{letter}.")
           or pred.rstrip(".") == letter
           or pred == body)
    return {"tempcompass_accuracy": float(hit)}


def register_tempcompass(dataset_path: str,
                         name: str = "tempcompass_mc",
                         max_new_tokens: int = 16):
    """jsonl rows: {"video_name", "question" (with embedded lettered
    options), "answer": "A. ..."}."""
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.video_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.video_mc:"
                    "tempcompass_doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.video_mc:"
                      "tempcompass_target",
        process_results="aurora_tpu_torch.eval.tasks.video_mc:"
                        "tempcompass_process_results",
        metric_aggregations={},
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0}))


# --- generic lettered video MC (LongVideoBench / MLVU) ---------------------
# Parity: lmms-eval tasks/longvideobench (lettered options + letter
# answer) and tasks/mlvu (mvbench-style candidates + full-text answer).
# One pair of hooks handles both row shapes.

GENERIC_POST_PROMPT = ("\nAnswer with the option's letter from the "
                       "given choices directly.")


def generic_mc_doc_to_text(doc, **_):
    if "options" in doc:  # lettered "A. ..." strings (longvideobench)
        opts = "\n".join(str(o) for o in doc["options"])
    else:                 # bare candidates (mlvu)
        opts = "\n".join(f"{_LETTERS[i]}. {c}"
                         for i, c in enumerate(doc["candidates"]))
    return doc["question"] + "\n" + opts + GENERIC_POST_PROMPT


def _generic_gt_letter(doc) -> str:
    a = doc["answer"]
    if isinstance(a, int):
        return _LETTERS[a]
    a = str(a).strip()
    if len(a) == 1 and a in _LETTERS:
        return a
    cands = [str(o) for o in doc.get("candidates", [])]
    if a in cands:
        return _LETTERS[cands.index(a)]
    return a[:1].upper()


def generic_mc_process_results(doc, result):
    n = len(doc.get("options") or doc.get("candidates") or [])
    letters = [_LETTERS[i] for i in range(max(n, 2))]
    pred = parse_multi_choice_response(result[0], letters)
    return {"mc_accuracy": {
        "score": float(pred == _generic_gt_letter(doc)),
        "category": doc.get("task_type", doc.get("duration", "all"))}}


def generic_mc_target(doc):
    return _generic_gt_letter(doc)


def register_video_mc(name: str, dataset_path: str,
                      max_new_tokens: int = 16,
                      by_category: bool = False):
    agg = ("aurora_tpu_torch.eval.tasks.image_mc:aggregate_by_category"
           if by_category else
           "aurora_tpu_torch.eval.tasks.image_mc:aggregate")
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_visual="aurora_tpu_torch.eval.tasks.video_mc:doc_to_visual",
        doc_to_text="aurora_tpu_torch.eval.tasks.video_mc:"
                    "generic_mc_doc_to_text",
        doc_to_target="aurora_tpu_torch.eval.tasks.video_mc:generic_mc_target",
        process_results="aurora_tpu_torch.eval.tasks.video_mc:"
                        "generic_mc_process_results",
        metric_aggregations={"mc_accuracy": agg},
        generation_kwargs={"max_new_tokens": max_new_tokens,
                           "temperature": 0.0}))


def register_longvideobench(dataset_path: str,
                            name: str = "longvideobench_val"):
    return register_video_mc(name, dataset_path)


def register_mlvu(dataset_path: str, name: str = "mlvu"):
    return register_video_mc(name, dataset_path, by_category=True)


# --- env-driven auto-registration ------------------------------------------

for _reg, _env, _default in (
        (register_longvideobench, "AURORA_LONGVIDEOBENCH",
         "data/longvideobench/val.jsonl"),
        (register_mlvu, "AURORA_MLVU", "data/mlvu/test.jsonl"),
        (register_videomme, "AURORA_VIDEOMME", "data/videomme/test.jsonl"),
        (register_mvbench, "AURORA_MVBENCH", "data/mvbench/test.jsonl"),
        (register_egoschema, "AURORA_EGOSCHEMA",
         "data/egoschema/test.jsonl"),
        (register_nextqa, "AURORA_NEXTQA", "data/nextqa/mc.jsonl"),
        (register_perceptiontest, "AURORA_PERCEPTIONTEST",
         "data/perceptiontest/val.jsonl"),
        (register_tempcompass, "AURORA_TEMPCOMPASS",
         "data/tempcompass/mc.jsonl"),
        # VITATECS temporal-concept MC (lmms-eval tasks/vitatecs) rides
        # the generic candidates/answer MC protocol per aspect
        (lambda p: register_video_mc("vitatecs", p, by_category=True),
         "AURORA_VITATECS", "data/vitatecs/test.jsonl")):
    _path = os.environ.get(_env, _default)
    if os.path.exists(_path):
        _reg(_path)
