"""Decoupled VDC scoring — step 2 of the two-step eval flow (a copy of
aurora_tpu/eval/post_eval.py; `main` takes argv).

Parity: reference/post_eval/process_vdc_result.py:116-290 — take
generation-only caption dumps + ground-truth QA jsonl, run the VDCScore
judge over them, aggregate per-subset accuracy and score.

  python -m aurora_tpu_torch post-eval \
      --captions captions.jsonl --gt camera.jsonl \
      --judge-url http://localhost:30000 --out camera_scores.json

captions.jsonl rows: {"video_name": ..., "pred": ...}
gt rows:            {"video_name": ..., "qa_list": [{question, answer}]}
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

from aurora_tpu_torch.eval.judge import JudgeClient, vdcscore_for_caption


def _load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def score_captions(captions: List[dict], gt: List[dict],
                   judge: JudgeClient) -> Dict:
    gt_by_name = {g["video_name"]: g for g in gt}
    rows = []
    for cap in captions:
        g = gt_by_name.get(cap["video_name"])
        if g is None:
            continue
        out = vdcscore_for_caption(judge, cap["pred"], g["qa_list"])
        rows.append({"video_name": cap["video_name"], **out})
    n = max(len(rows), 1)
    return {
        "acc": 100.0 * sum(r["acc"] for r in rows) / n,
        "score": sum(r["score"] for r in rows) / n,
        "n": len(rows),
        "rows": rows,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--captions", required=True,
                   help="predictions jsonl (captions, or full records "
                        "for qa/mmvet/llava_wild modes)")
    p.add_argument("--gt", default=None,
                   help="ground-truth jsonl (captions mode only)")
    p.add_argument("--mode", default="captions",
                   choices=["captions", "qa", "mmvet", "llava_wild"],
                   help="judge protocol: VDCScore captions (default), "
                        "ActivityNet/VideoChatGPT QA, MM-Vet 0-1 "
                        "grading, or llava-bench relative scoring")
    p.add_argument("--judge-url", default="http://localhost:30000")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    if args.mode == "qa":
        from aurora_tpu_torch.eval.tasks.videoqa import score_qa_predictions
        result = score_qa_predictions(_load_jsonl(args.captions),
                                      args.judge_url)
    elif args.mode == "mmvet":
        from aurora_tpu_torch.eval.tasks.image_judge import \
            score_mmvet_predictions
        result = score_mmvet_predictions(_load_jsonl(args.captions),
                                         args.judge_url)
    elif args.mode == "llava_wild":
        from aurora_tpu_torch.eval.tasks.image_judge import \
            score_llava_wild_predictions
        result = score_llava_wild_predictions(
            _load_jsonl(args.captions), args.judge_url)
    else:
        if not args.gt:
            p.error("--gt is required for captions mode")
        judge = JudgeClient(args.judge_url)
        result = score_captions(_load_jsonl(args.captions),
                                _load_jsonl(args.gt), judge)
    print(json.dumps({k: v for k, v in result.items() if k != "rows"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    main()
