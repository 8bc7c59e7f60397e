"""Evaluation metrics.

Parity: xtuner's evaluation/metrics (MMLUMetric, RewardMetric — SURVEY
§2.8) plus the standard caption/VQA aggregations the lmms-eval tasks use.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def mmlu_accuracy(model, docs: Sequence[dict], tokenizer,
                  choices=("A", "B", "C", "D")) -> Dict[str, float]:
    """Multiple-choice accuracy via per-choice loglikelihood
    (MMLUMetric semantics): pick argmax_c log p(c | prompt)."""
    correct = 0
    for doc in docs:
        ctx = tokenizer.encode(doc["prompt"])
        scores = []
        for c in choices:
            cont = tokenizer.encode(" " + c, add_special_tokens=False)
            scores.append(model.loglikelihood(ctx, cont))
        pred = choices[max(range(len(choices)),
                           key=lambda i: scores[i])]
        correct += int(pred == doc["answer"])
    n = max(len(docs), 1)
    return {"accuracy": correct / n, "n": len(docs)}


def reward_accuracy(chosen_scores: Sequence[float],
                    rejected_scores: Sequence[float]) -> Dict[str, float]:
    """RewardMetric: fraction of pairs where chosen outranks rejected."""
    assert len(chosen_scores) == len(rejected_scores)
    wins = sum(c > r for c, r in zip(chosen_scores, rejected_scores))
    n = max(len(chosen_scores), 1)
    return {"accuracy": wins / n,
            "margin": sum(c - r for c, r in zip(chosen_scores,
                                                rejected_scores)) / n}


def exact_match(preds: Sequence[str], targets: Sequence[str],
                normalize=str.strip) -> float:
    hits = sum(normalize(p) == normalize(t)
               for p, t in zip(preds, targets))
    return hits / max(len(preds), 1)


def anls(pred: str, target: str) -> float:
    """Average normalized Levenshtein similarity (OCR/VQA tasks)."""
    a, b = pred.strip().lower(), target.strip().lower()
    if not a and not b:
        return 1.0
    m, n = len(a), len(b)
    dp = list(range(n + 1))
    for i in range(1, m + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, n + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1,
                        prev + (a[i - 1] != b[j - 1]))
            prev = cur
    dist = dp[n] / max(m, n, 1)
    return 1.0 - dist if dist < 0.5 else 0.0


# ---------------------------------------------------------------------------
# CIDEr-D (caption benchmarks: coco_cap / flickr30k / nocaps — the
# token-ratio sweep metrics in BASELINE.md §6 / figure_in_paper.ipynb)
# ---------------------------------------------------------------------------

def _caption_tokens(text: str):
    """Lowercase word tokenization (approximates the PTB tokenizer the
    pycocoevalcap pipeline uses; scores track within ~1 point)."""
    import re
    return re.findall(r"[a-z0-9]+(?:'[a-z]+)?", text.lower())


def _ngram_counts(tokens, n_max=4):
    from collections import Counter
    out = []
    for n in range(1, n_max + 1):
        out.append(Counter(tuple(tokens[i:i + n])
                           for i in range(len(tokens) - n + 1)))
    return out


def cider_d(candidates, references, *, n_max: int = 4,
            sigma: float = 6.0):
    """CIDEr-D over a corpus (pycocoevalcap cider_scorer.py semantics):
    tf-idf n-gram vectors (idf from the reference corpus), candidate
    counts clipped to reference counts, gaussian length penalty,
    10 × mean over n of mean-over-refs cosine similarity.

    candidates: List[str]; references: List[List[str]].
    Returns (corpus_score, per_sample_scores)."""
    import math
    from collections import Counter

    assert len(candidates) == len(references)
    N = len(candidates)
    ref_counts = [[_ngram_counts(_caption_tokens(r), n_max) for r in refs]
                  for refs in references]
    cand_counts = [_ngram_counts(_caption_tokens(c), n_max)
                   for c in candidates]

    # document frequency over reference sets (one doc per image)
    df = [Counter() for _ in range(n_max)]
    for refs in ref_counts:
        seen = [set() for _ in range(n_max)]
        for r in refs:
            for n in range(n_max):
                seen[n] |= set(r[n])
        for n in range(n_max):
            for g in seen[n]:
                df[n][g] += 1
    log_n = math.log(max(N, 1))

    def tfidf(counts):
        vecs, norms = [], []
        for n in range(n_max):
            vec = {g: c * max(log_n - math.log(max(df[n].get(g, 0), 1)),
                              0.0)
                   for g, c in counts[n].items()}
            vecs.append(vec)
            norms.append(math.sqrt(sum(v * v for v in vec.values())))
        return vecs, norms

    scores = []
    for ci in range(N):
        cvec, cnorm = tfidf(cand_counts[ci])
        clen = sum(cand_counts[ci][0].values())
        per_ref = []
        for ri, r in enumerate(ref_counts[ci]):
            rvec, rnorm = tfidf(r)
            rlen = sum(r[0].values())
            delta = float(clen - rlen)
            val = 0.0
            for n in range(n_max):
                num = sum(min(cvec[n][g], rvec[n].get(g, 0.0))
                          * rvec[n].get(g, 0.0) for g in cvec[n])
                if cnorm[n] > 0 and rnorm[n] > 0:
                    val += (num / (cnorm[n] * rnorm[n])
                            * math.exp(-delta ** 2 / (2 * sigma ** 2)))
            per_ref.append(val / n_max)
        scores.append(10.0 * (sum(per_ref) / max(len(per_ref), 1)))
    return (sum(scores) / max(N, 1)), scores


def bleu(candidates, references, *, n: int = 4):
    """Corpus BLEU-n with uniform weights and brevity penalty
    (pycocoevalcap Bleu semantics, closest-reference length).
    candidates: List[str]; references: List[List[str]].
    Returns (corpus_score, per_sample_scores)."""
    import math
    from collections import Counter

    assert len(candidates) == len(references)
    # corpus-level accumulators
    match = [0] * n
    total = [0] * n
    c_len = r_len = 0
    per_sample = []
    for cand, refs in zip(candidates, references):
        ct = _caption_tokens(cand)
        rts = [_caption_tokens(r) for r in refs]
        c_len += len(ct)
        r_len += min((abs(len(rt) - len(ct)), len(rt))
                     for rt in rts)[1] if rts else 0
        s_match, s_total = [0] * n, [0] * n
        for k in range(1, n + 1):
            cc = Counter(tuple(ct[i:i + k])
                         for i in range(len(ct) - k + 1))
            rmax = Counter()
            for rt in rts:
                rc = Counter(tuple(rt[i:i + k])
                             for i in range(len(rt) - k + 1))
                for g, v in rc.items():
                    rmax[g] = max(rmax[g], v)
            m = sum(min(v, rmax.get(g, 0)) for g, v in cc.items())
            t = max(sum(cc.values()), 0)
            match[k - 1] += m
            total[k - 1] += t
            s_match[k - 1], s_total[k - 1] = m, t
        # per-sample smoothed score (for stderr only)
        logs = [math.log((s_match[k] + 1e-9) / max(s_total[k], 1e-9))
                for k in range(n)]
        rl = (min((abs(len(rt) - len(ct)), len(rt)) for rt in rts)[1]
              if rts else len(ct))
        bp_s = 1.0 if len(ct) >= rl else math.exp(
            1 - rl / max(len(ct), 1))
        per_sample.append(bp_s * math.exp(sum(logs) / n))
    if any(t == 0 for t in total) or any(m == 0 for m in match):
        corpus = 0.0
    else:
        logs = [math.log(match[k] / total[k]) for k in range(n)]
        bp = 1.0 if c_len >= r_len else math.exp(1 - r_len
                                                 / max(c_len, 1))
        corpus = bp * math.exp(sum(logs) / n)
    return corpus, per_sample


def rouge_l(candidates, references, *, beta: float = 1.2):
    """ROUGE-L F-measure against the best reference (pycocoevalcap Rouge
    semantics). Returns (corpus_mean, per_sample_scores)."""
    def lcs(a, b):
        m, n = len(a), len(b)
        dp = [0] * (n + 1)
        for i in range(1, m + 1):
            prev = 0
            for j in range(1, n + 1):
                cur = dp[j]
                dp[j] = prev + 1 if a[i - 1] == b[j - 1] \
                    else max(dp[j], dp[j - 1])
                prev = cur
        return dp[n]

    per = []
    for cand, refs in zip(candidates, references):
        ct = _caption_tokens(cand)
        best = 0.0
        for r in refs:
            rt = _caption_tokens(r)
            ll = lcs(ct, rt)
            p = ll / max(len(ct), 1)
            rr = ll / max(len(rt), 1)
            if p > 0 and rr > 0:
                f = ((1 + beta ** 2) * p * rr) / (rr + beta ** 2 * p)
                best = max(best, f)
        per.append(best)
    return (sum(per) / max(len(per), 1)), per
