"""Evaluation CLI (a copy of aurora_tpu/eval/__main__.py; `main` takes
argv, and `dtype=` in --model_args names a torch dtype).

Parity: lmms-eval __main__ (src/lmms-eval/lmms_eval/__main__.py:273-548).

  python -m aurora_tpu_torch eval --model auroracap \
      --model_args pretrained=/ckpt,token_merge_ratio=0.2,num_frames=8 \
      --tasks vdc_detailed_test,vdc_camera_test \
      --output_path results/ --log_samples

AuroraCapEval runs on the card; `device=cpu,dtype=float32` in
--model_args runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json


def _parse_model_args(s: str) -> dict:
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        k, v = kv.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="auroracap",
                   choices=["auroracap", "http"])
    p.add_argument("--model_args", default="")
    p.add_argument("--tasks", required=True,
                   help="comma-separated task names")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--output_path", default=None)
    p.add_argument("--log_samples", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--list_tasks", action="store_true")
    args = p.parse_args(argv)

    import aurora_tpu_torch.eval.tasks  # noqa: F401
    from aurora_tpu_torch.eval.api import list_tasks
    if args.list_tasks:
        print("\n".join(list_tasks()))
        return 0

    kwargs = _parse_model_args(args.model_args)
    if args.model == "auroracap":
        from aurora_tpu_torch.cli.infer import _DTYPES
        from aurora_tpu_torch.eval.models import AuroraCapEval
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = _DTYPES[kwargs["dtype"]]
        model = AuroraCapEval(**kwargs)
    else:
        from aurora_tpu_torch.eval.models import HTTPModelEval
        model = HTTPModelEval(**kwargs)

    from aurora_tpu_torch.eval.evaluator import simple_evaluate
    results = simple_evaluate(model, args.tasks.split(","),
                              limit=args.limit,
                              log_samples=args.log_samples,
                              output_dir=args.output_path,
                              seed=args.seed)
    print(json.dumps(results["results"], indent=2))
    return 0


if __name__ == "__main__":
    main()
