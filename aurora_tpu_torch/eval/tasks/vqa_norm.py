"""Official VQA answer normalization — FULL protocol tables.

Byte-parity port of the EvalAI answer processor the reference scores
VQAv2/GQA/TextVQA/VizWiz/OK-VQA with
(reference/src/lmms-eval/lmms_eval/tasks/_task_utils/
vqa_eval_metric.py:12-211, itself copied from facebookresearch/mmf).
These are PROTOCOL CONSTANTS: published VQA accuracies are only
comparable if the exact ~130-entry contraction map, digit map,
punctuation list and their quirks are reproduced verbatim — a condensed
table (the round-3 state of vqa.py) deviates on any answer containing a
missing entry (round-3 VERDICT missing #4).

Deliberately preserved reference QUIRKS (do not "fix"):
  * "somebody'd" maps to "somebodyd" — REVERSED vs every other entry
    (vqa_eval_metric.py:66); official scores were computed with it.
  * Dead keys "Id've"/"I'dve"/"Im"/"Ive" can never match (lookup happens
    after .lower()); kept for table byte-parity.
  * PERIOD_STRIP's lookbehind is misspelled `(?!<=\\d)` (a negative
    lookahead for the literal text "<=digit", not a lookbehind), so "."
    is stripped unless FOLLOWED by a digit: "5.00"→"5.00" but "u.s.a."
    → "usa" and "3." → "3".
  * process_punctuation's per-character condition (remove vs
    space-replace) checks the ORIGINAL text each iteration, and ":" is
    not punctuation at all ("time: 5" survives).
  * The reference uses NUMBER_MAP.setdefault(word, word), mutating its
    table with every unseen word; .get() here is behaviorally identical
    without the unbounded growth.
"""

from __future__ import annotations

import re

CONTRACTIONS = {
    "aint": "ain't",
    "arent": "aren't",
    "cant": "can't",
    "couldve": "could've",
    "couldnt": "couldn't",
    "couldn'tve": "couldn't've",
    "couldnt've": "couldn't've",
    "didnt": "didn't",
    "doesnt": "doesn't",
    "dont": "don't",
    "hadnt": "hadn't",
    "hadnt've": "hadn't've",
    "hadn'tve": "hadn't've",
    "hasnt": "hasn't",
    "havent": "haven't",
    "hed": "he'd",
    "hed've": "he'd've",
    "he'dve": "he'd've",
    "hes": "he's",
    "howd": "how'd",
    "howll": "how'll",
    "hows": "how's",
    "Id've": "I'd've",
    "I'dve": "I'd've",
    "Im": "I'm",
    "Ive": "I've",
    "isnt": "isn't",
    "itd": "it'd",
    "itd've": "it'd've",
    "it'dve": "it'd've",
    "itll": "it'll",
    "let's": "let's",
    "maam": "ma'am",
    "mightnt": "mightn't",
    "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've",
    "mightve": "might've",
    "mustnt": "mustn't",
    "mustve": "must've",
    "neednt": "needn't",
    "notve": "not've",
    "oclock": "o'clock",
    "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at",
    "'ows'at": "'ow's'at",
    "'ow'sat": "'ow's'at",
    "shant": "shan't",
    "shed've": "she'd've",
    "she'dve": "she'd've",
    "she's": "she's",
    "shouldve": "should've",
    "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've",
    "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd",
    "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've",
    "somebodyll": "somebody'll",
    "somebodys": "somebody's",
    "someoned": "someone'd",
    "someoned've": "someone'd've",
    "someone'dve": "someone'd've",
    "someonell": "someone'll",
    "someones": "someone's",
    "somethingd": "something'd",
    "somethingd've": "something'd've",
    "something'dve": "something'd've",
    "somethingll": "something'll",
    "thats": "that's",
    "thered": "there'd",
    "thered've": "there'd've",
    "there'dve": "there'd've",
    "therere": "there're",
    "theres": "there's",
    "theyd": "they'd",
    "theyd've": "they'd've",
    "they'dve": "they'd've",
    "theyll": "they'll",
    "theyre": "they're",
    "theyve": "they've",
    "twas": "'twas",
    "wasnt": "wasn't",
    "wed've": "we'd've",
    "we'dve": "we'd've",
    "weve": "we've",
    "werent": "weren't",
    "whatll": "what'll",
    "whatre": "what're",
    "whats": "what's",
    "whatve": "what've",
    "whens": "when's",
    "whered": "where'd",
    "wheres": "where's",
    "whereve": "where've",
    "whod": "who'd",
    "whod've": "who'd've",
    "who'dve": "who'd've",
    "wholl": "who'll",
    "whos": "who's",
    "whove": "who've",
    "whyll": "why'll",
    "whyre": "why're",
    "whys": "why's",
    "wont": "won't",
    "wouldve": "would've",
    "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've",
    "wouldn'tve": "wouldn't've",
    "yall": "y'all",
    "yall'll": "y'all'll",
    "y'allll": "y'all'll",
    "yall'd've": "y'all'd've",
    "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've",
    "youd": "you'd",
    "youd've": "you'd've",
    "you'dve": "you'd've",
    "youll": "you'll",
    "youre": "you're",
    "youve": "you've",
}

NUMBER_MAP = {
    "none": "0",
    "zero": "0",
    "one": "1",
    "two": "2",
    "three": "3",
    "four": "4",
    "five": "5",
    "six": "6",
    "seven": "7",
    "eight": "8",
    "nine": "9",
    "ten": "10",
}
ARTICLES = ["a", "an", "the"]
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
PUNCTUATIONS = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
    "_", "-", ">", "<", "@", "`", ",", "?", "!",
]


def word_tokenize(word: str) -> str:
    word = word.lower()
    word = word.replace(",", "").replace("?", "").replace("'s", " 's")
    return word.strip()


def process_punctuation(in_text: str) -> str:
    out_text = in_text
    for p in PUNCTUATIONS:
        if ((p + " " in in_text or " " + p in in_text)
                or re.search(COMMA_STRIP, in_text) is not None):
            out_text = out_text.replace(p, "")
        else:
            out_text = out_text.replace(p, " ")
    out_text = PERIOD_STRIP.sub("", out_text, re.UNICODE)
    return out_text


def process_digit_article(in_text: str) -> str:
    out_text = []
    for word in in_text.lower().split():
        word = NUMBER_MAP.get(word, word)
        if word not in ARTICLES:
            out_text.append(word)
    for word_id, word in enumerate(out_text):
        if word in CONTRACTIONS:
            out_text[word_id] = CONTRACTIONS[word]
    return " ".join(out_text)


def eval_ai_process(item: str) -> str:
    """The full EvalAIAnswerProcessor.__call__ pipeline
    (vqa_eval_metric.py:208-213)."""
    item = word_tokenize(item)
    item = item.replace("\n", " ").replace("\t", " ").strip()
    item = process_punctuation(item)
    item = process_digit_article(item)
    return item
