"""MMBench evaluation CLI (aurora_tpu/cli/mmbench.py on the port: `main`
takes argv, and --device picks the card (default) or the CPU).

Parity: xtuner's mmbench tool (src/xtuner/xtuner/tools/mmbench.py:1-513,
`xtuner mmbench` entry_point mode): evaluate an AuroraCap checkpoint on an
MMBench TSV and report accuracy (+ CircularEval when rotations exist).

  python -m aurora_tpu_torch mmbench --model_path <xtuner dir> \
      --data-path MMBench_DEV_EN.tsv --work-dir out/
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_path", required=True,
                   help="xtuner-format AuroraCap dir")
    p.add_argument("--data-path", required=True, help="MMBench TSV")
    p.add_argument("--work-dir", default="mmbench_out")
    p.add_argument("--token-merge-ratio", type=float, default=0.8,
                   help="README.md:95 recommends >0.5 for VQA-style tasks")
    p.add_argument("--image-size", type=int, default=378)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from aurora_tpu_torch.cli.infer import _DTYPES
    from aurora_tpu_torch.eval.evaluator import simple_evaluate
    from aurora_tpu_torch.eval.models import AuroraCapEval
    from aurora_tpu_torch.eval.tasks import mmbench

    mmbench.register(args.data_path, name="mmbench_cli")
    model = AuroraCapEval(
        pretrained=args.model_path,
        token_merge_ratio=args.token_merge_ratio,
        num_frames=1, image_size=args.image_size,
        max_new_tokens=args.max_new_tokens,
        dtype=_DTYPES[args.dtype], device=args.device)
    res = simple_evaluate(model, ["mmbench_cli"], limit=args.limit,
                          log_samples=True, output_dir=args.work_dir)

    samples = res["samples"]["mmbench_cli"]
    per_doc = [s["metrics"] for s in samples]
    circular = mmbench.circular_aggregate(per_doc)
    out = {"accuracy": res["results"]["mmbench_cli"].get("acc"),
           "circular_accuracy": circular, "n": len(samples)}
    os.makedirs(args.work_dir, exist_ok=True)
    with open(os.path.join(args.work_dir, "mmbench_results.json"),
              "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    main()
