"""Time the W4/W8 decode-matmul kernels and their library yardsticks for
the aurora_tpu_torch package of a given source tree, on one GPU, so that
two trees can be compared in one call on one card:

    python3 aurora_tpu_torch/tools/time_weights.py --tree OTHER_TREE
    python3 aurora_tpu_torch/tools/time_weights.py          # this checkout
    python3 aurora_tpu_torch/tools/time_weights.py --rows 1,8,16,28,64

The cases and the timing are chip_smoke.py's own (`w4a8_phase`,
`w4_flat_phase`, `fused_mlp_phase`, `w8a8_phase`, loaded from this
checkout whatever the tree): a 7B layer's four decode projections (qkv,
o, gateup, down) at B 4 and B 64 (or at the --rows given: the W4A8
stripe and flat, W4A16 and W8A8 cases), and one 7B layer's fused MLP at
B 4 and B 64 beside the two-call W4A8 path. Each case holds the tree's kernel
against the tree's plain twin at chip_smoke's bounds (the fused MLP's
where the tree has `fused_mlp_w4_bound`) and prints
chip_smoke's `[kernels]` line: `ms` and `library_ms` are CUDA-graph
replays (device time), `eager_ms` and `library_eager_ms` one call
between two CUDA events (the host's issue time included). A last
`[weights]` line sums each kernel's four projections. The weights and
activations come from chip_smoke's seed, so two trees see the same
inputs (not chip_smoke's own: its generator has served the attention
cases first). A failed check prints a `[check-failed]` line and the
timing goes on; the exit code is then 1.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MAX_ROWS = 64        # the most decode rows the kernels take


def parse_rows(text):
    """"1,8,16" → (1, 8, 16): distinct token-row counts in 1..MAX_ROWS."""
    try:
        rows = tuple(int(r) for r in text.split(","))
    except ValueError:
        rows = ()
    if not rows or len(set(rows)) != len(rows) \
            or not all(0 < r <= MAX_ROWS for r in rows):
        raise argparse.ArgumentTypeError(
            f"--rows takes distinct row counts in 1..{MAX_ROWS}, "
            f"comma-separated; got {text!r}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO,
                    help="root of the source tree whose aurora_tpu_torch "
                         "is timed (default: this checkout)")
    ap.add_argument("--rows", type=parse_rows, default=(4, MAX_ROWS),
                    help="token rows of the W4A8, W4A16 and W8A8 cases, "
                         "comma-separated (default: 4,64, chip_smoke's)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_weights: CUDA is not available", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from aurora_tpu_torch.ops import cuda_build
    from aurora_tpu_torch.ops.pallas import quant_matmul as qm
    from aurora_tpu_torch.serve import engine as engine_mod
    if not qm.__file__.startswith(tree + os.sep):
        print(f"time_weights: imported {qm.__file__}, not from {tree}",
              file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    head = subprocess.run(["git", "-C", tree, "rev-parse", "--short",
                           "HEAD"], capture_output=True, text=True)
    smoke.phase("tree", path=tree, commit=head.stdout.strip() or None,
                card=repr(smoke.card_line()))
    failed = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            smoke.phase("check-failed", msg=repr(msg))

    smoke.check = check
    cuda_build.load_library()
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
    sums = {("w4a8_matmul_tiled", B): acc for B, acc in smoke.w4a8_phase(
        torch, qm, engine_mod._w4, dev, g, rows=args.rows).items()}
    for (kname, B), acc in smoke.w4_flat_phase(
            torch, qm, engine_mod._w4, dev, g, rows=args.rows).items():
        sums[(kname + "_matmul", B)] = acc
    mlp = smoke.fused_mlp_phase(torch, qm, engine_mod._w4, dev, g)
    sums[("fused_mlp_w4", 4)] = mlp
    sums[("fused_mlp_w4", qm.MAX_TOKENS)] = dict(
        ms=mlp["ms_b64"], eager_ms=mlp["eager_ms_b64"], library_ms=None,
        bound=mlp["bound_b64"], two_call_ms=mlp["two_call_ms_b64"])
    for B, acc in smoke.w8a8_phase(torch, qm, engine_mod._w8, dev, g,
                                   rows=args.rows).items():
        sums[("w8a8_matmul", B)] = acc
    for (name, B), acc in sums.items():
        lib = acc["library_ms"]
        extra = ({"two_call_ms": f"{acc['two_call_ms']:.4f}"}
                 if "two_call_ms" in acc else {})
        smoke.phase("weights", kernel=name, B=B, ms=f"{acc['ms']:.4f}",
                    eager_ms=f"{acc['eager_ms']:.4f}",
                    library_ms="none" if lib is None else f"{lib:.4f}",
                    bound_ms=f"{acc['bound'][0]:.4f}",
                    bound_share=f"{acc['bound'][0] / acc['ms']:.3f}",
                    **extra)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
