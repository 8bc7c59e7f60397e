"""IFEval — verifiable instruction following.

Parity: lmms-eval tasks/ifeval (which vendors Google's
instruction_following_eval): each prompt carries a list of
instruction_id_list entries + kwargs; the response is checked by
RULE-BASED verifiers, reported as prompt-level and instruction-level
strict accuracy (a loose pass additionally tries minor response
transformations: stripped markdown emphasis, first/last line removed).

This module implements the verifier registry natively (no vendored
code) for the instruction families that make up the overwhelming bulk
of the benchmark. Unknown instruction ids score 0 and are flagged in
the sample record so truncation is visible, never silent.

Local jsonl rows: {"prompt": str,
                   "instruction_id_list": [str, ...],
                   "kwargs": [{...} per instruction]}
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional

from aurora_tpu_torch.eval.api import TaskConfig, register_task


# --- verifiers -------------------------------------------------------------

def _count_words(t: str) -> int:
    return len(re.findall(r"\w+", t))


def _sentences(t: str) -> List[str]:
    return [s for s in re.split(r"[.!?]+(?:\s|$)", t) if s.strip()]


def _paragraphs(t: str) -> List[str]:
    return [p for p in re.split(r"\n\s*\n", t) if p.strip()]


def _rel(n: int, want: int, relation: Optional[str]) -> bool:
    if relation == "at least":
        return n >= want
    if relation == "less than":
        return n < want
    return n == want


def v_keywords_existence(t, kw):
    return all(re.search(rf"\b{re.escape(k)}\b", t, re.I)
               for k in kw.get("keywords", []))


def v_keywords_frequency(t, kw):
    n = len(re.findall(rf"\b{re.escape(kw['keyword'])}\b", t, re.I))
    return _rel(n, kw.get("frequency", 1), kw.get("relation"))


def v_keywords_forbidden(t, kw):
    return not any(re.search(rf"\b{re.escape(k)}\b", t, re.I)
                   for k in kw.get("forbidden_words", []))


def v_letter_frequency(t, kw):
    n = t.lower().count(kw["letter"].lower())
    return _rel(n, kw.get("let_frequency", 1), kw.get("let_relation"))


def v_number_words(t, kw):
    return _rel(_count_words(t), kw.get("num_words", 0),
                kw.get("relation"))


def v_number_sentences(t, kw):
    return _rel(len(_sentences(t)), kw.get("num_sentences", 0),
                kw.get("relation"))


def v_number_paragraphs(t, kw):
    # the benchmark's paragraph checker splits on the literal '***'
    parts = [p for p in t.split("***") if p.strip()]
    return len(parts) == kw.get("num_paragraphs", 0)


def v_nth_paragraph_first_word(t, kw):
    paras = _paragraphs(t)
    i = kw.get("nth_paragraph", 1) - 1
    if len(paras) != kw.get("num_paragraphs", len(paras)) \
            or i >= len(paras):
        return False
    first = re.findall(r"\w+", paras[i])
    return bool(first) and first[0].lower() == \
        kw.get("first_word", "").lower()


def v_number_placeholders(t, kw):
    return len(re.findall(r"\[.*?\]", t)) >= kw.get("num_placeholders",
                                                    1)


def v_postscript(t, kw):
    marker = kw.get("postscript_marker", "P.S.")
    pattern = re.escape(marker).replace(r"P\.S\.", r"p\.?\s?s\.?")
    return bool(re.search(pattern, t, re.I))


def v_number_bullets(t, kw):
    bullets = re.findall(r"^\s*[*-]\s", t, re.M)
    return len(bullets) == kw.get("num_bullets", 0)


def v_title(t, kw):
    return bool(re.search(r"<<[^<>]+>>", t))


def v_json_format(t, kw):
    body = t.strip()
    body = re.sub(r"^```(?:json)?|```$", "", body, flags=re.M).strip()
    try:
        json.loads(body)
        return True
    except ValueError:
        return False


def v_multiple_sections(t, kw):
    splitter = kw.get("section_spliter", kw.get("section_splitter",
                                                "Section"))
    n = len(re.findall(rf"{re.escape(splitter)}\s+\d", t))
    return n == kw.get("num_sections", 0)


def v_number_highlights(t, kw):
    hl = [m for m in re.findall(r"\*[^\n*]+\*", t) if m.strip("*")]
    return len(hl) >= kw.get("num_highlights", 1)


def v_repeat_prompt(t, kw):
    want = kw.get("prompt_to_repeat", "")
    return t.strip().startswith(want.strip())


def v_two_responses(t, kw):
    return len(t.split("******")) == 2


def v_end_checker(t, kw):
    return t.strip().endswith(kw.get("end_phrase", "").strip())


def v_quotation(t, kw):
    s = t.strip()
    return len(s) > 1 and s[0] == '"' and s[-1] == '"'


def v_lowercase(t, kw):
    return t == t.lower()


def v_uppercase(t, kw):
    return t == t.upper()


def v_capital_word_frequency(t, kw):
    n = len([w for w in re.findall(r"\b\w+\b", t) if w.isupper()
             and len(w) > 1])
    return _rel(n, kw.get("capital_frequency", 1),
                kw.get("capital_relation"))


def v_no_comma(t, kw):
    return "," not in t


def v_english_only(t, kw):  # response_language en approximation
    return not re.search(r"[^\x00-\x7F]", t)


VERIFIERS = {
    "keywords:existence": v_keywords_existence,
    "keywords:frequency": v_keywords_frequency,
    "keywords:forbidden_words": v_keywords_forbidden,
    "keywords:letter_frequency": v_letter_frequency,
    "length_constraints:number_words": v_number_words,
    "length_constraints:number_sentences": v_number_sentences,
    "length_constraints:number_paragraphs": v_number_paragraphs,
    "length_constraints:nth_paragraph_first_word":
        v_nth_paragraph_first_word,
    "detectable_content:number_placeholders": v_number_placeholders,
    "detectable_content:postscript": v_postscript,
    "detectable_format:number_bullet_lists": v_number_bullets,
    "detectable_format:title": v_title,
    "detectable_format:json_format": v_json_format,
    "detectable_format:multiple_sections": v_multiple_sections,
    "detectable_format:number_highlighted_sections":
        v_number_highlights,
    "combination:repeat_prompt": v_repeat_prompt,
    "combination:two_responses": v_two_responses,
    "startend:end_checker": v_end_checker,
    "startend:quotation": v_quotation,
    "change_case:english_lowercase": v_lowercase,
    "change_case:english_capital": v_uppercase,
    "change_case:capital_word_frequency": v_capital_word_frequency,
    "punctuation:no_comma": v_no_comma,
    "language:response_language": v_english_only,
}


def check_instructions(text: str, ids: List[str],
                       kwargs_list: List[dict]) -> List[Optional[bool]]:
    """Per-instruction verdicts; None marks an unimplemented id."""
    out: List[Optional[bool]] = []
    for iid, kw in zip(ids, kwargs_list or [{}] * len(ids)):
        fn = VERIFIERS.get(iid)
        if fn is None:
            out.append(None)
            continue
        try:
            out.append(bool(fn(text, kw or {})))
        except (KeyError, ValueError, TypeError):
            out.append(False)
    return out


def doc_to_text(doc, **_):
    return doc["prompt"]


def doc_to_target(doc):
    return ""


def process_results(doc, result):
    ids = doc.get("instruction_id_list", [])
    verdicts = check_instructions(result[0], ids, doc.get("kwargs"))
    known = [v for v in verdicts if v is not None]
    return {
        "prompt_level_strict_acc": float(bool(known)
                                         and all(known)
                                         and None not in verdicts),
        "inst_level_strict_acc": {
            "scores": [bool(v) for v in verdicts],
            "unknown": [i for i, v in zip(ids, verdicts) if v is None]},
    }


def inst_aggregate(results) -> float:
    flat = [s for r in results for s in r["scores"]]
    return 100.0 * sum(flat) / max(len(flat), 1)


def register_ifeval(dataset_path: str, name: str = "ifeval"):
    m = "aurora_tpu_torch.eval.tasks.ifeval:"
    return register_task(TaskConfig(
        name=name, dataset_path=dataset_path,
        doc_to_text=m + "doc_to_text",
        doc_to_target=m + "doc_to_target",
        process_results=m + "process_results",
        metric_aggregations={"prompt_level_strict_acc": "mean",
                             "inst_level_strict_acc":
                                 m + "inst_aggregate"},
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0.0}))


_path = os.environ.get("AURORA_IFEVAL", "data/ifeval/input_data.jsonl")
if os.path.exists(_path):
    register_ifeval(_path)
