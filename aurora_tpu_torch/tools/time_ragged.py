"""Time both ragged-attention kernels and their SDPA yardsticks for the
aurora_tpu_torch package of a given source tree, on one GPU, so that two
trees can be compared in one call on one card:

    python3 aurora_tpu_torch/tools/time_ragged.py --tree OTHER_TREE
    python3 aurora_tpu_torch/tools/time_ragged.py          # this checkout

The cases and the timing are chip_smoke.py's own (`attention_case`,
loaded from this checkout whatever the tree): the serving shapes (rows of
1792, extend of 1536, 32 and 8 KV heads) in every KV mode, from
chip_smoke's generator, then Mistral-7B's (rows of 7168, Hkv 8, window
4096). Each case holds the tree's kernels against the tree's plain twins
at chip_smoke's bounds and prints chip_smoke's `[kernels]` line: `*_ms`
are CUDA-graph replays (device time), `*_eager_ms` one call between two
CUDA events (the host's issue time included). The Mistral cases draw
their inputs from a generator of their own (same shapes and lengths as
chip_smoke's, other values).
"""

import argparse
import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO,
                    help="root of the source tree whose aurora_tpu_torch "
                         "is timed (default: this checkout)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_ragged: CUDA is not available", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from aurora_tpu_torch.ops import cuda_build
    from aurora_tpu_torch.ops.pallas import ragged_attention as ra
    if not ra.__file__.startswith(tree + os.sep):
        print(f"time_ragged: imported {ra.__file__}, not from {tree}",
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
    cuda_build.load_library()
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
    for mode in smoke.KV_MODES:
        for hkv in (32, 8):
            smoke.attention_case(torch, ra, dev, g, hkv, mode)
    gw = torch.Generator(device=dev).manual_seed(smoke.SEED + 6)
    for mode in smoke.KV_MODES:
        smoke.attention_case(torch, ra, dev, gw, 8, mode,
                             **smoke.MISTRAL_CASE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
