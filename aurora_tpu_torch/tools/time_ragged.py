"""Time both ragged-attention kernels and their SDPA yardsticks for the
aurora_tpu_torch package of a given source tree, on one GPU, so that two
trees can be compared in one call on one card:

    python3 aurora_tpu_torch/tools/time_ragged.py --tree OTHER_TREE
    python3 aurora_tpu_torch/tools/time_ragged.py          # this checkout

The cases and the timing are chip_smoke.py's own (`attention_case`,
loaded from this checkout whatever the tree): the serving shapes (rows of
1792, extend of 1536, 32 and 8 KV heads) in every KV mode, from
chip_smoke's generator, then Mistral-7B's (rows of 7168, Hkv 8, window
4096), then Gemma-2-9B's (head_dim 256, Hq 16, Hkv 8): chip_smoke's
`[kernels]` family shape and its served extend (the [serve-gemma2-*]
runs' four prompts in one 6144 wave, rows of 6144) with the even layers'
window 4096 and cap 50 and with neither, both from chip_smoke's own
generators; then the narrow heads ("narrow"): chip_smoke's `[kernels]`
family shapes whose head is 96 wide or narrower (Phi-3-mini, MiniCPM-2B,
Qwen2-0.5B) and its served extends of Phi-3-mini (window 2047) and
StableLM-3B (hd 80); then "pad128", the other route for a head of 65-96:
the width-128 kernel at Phi-3-mini's heads and lengths (its family shape
and its served extend) on rows 128 wide. `--cases` picks some of the
five. Each case holds the tree's
kernels against the tree's plain twins at chip_smoke's bounds and prints
chip_smoke's `[kernels]` line: `*_ms` are CUDA-graph replays (device
time), `*_eager_ms` one call between two CUDA events (the host's issue
time included). The Mistral cases draw their inputs from a generator of
their own (same shapes and lengths as chip_smoke's, other values).

    python3 aurora_tpu_torch/tools/time_ragged.py --cases gemma2
    python3 aurora_tpu_torch/tools/time_ragged.py --cases narrow,pad128
"""

CASES = ("serving", "mistral", "gemma2", "narrow", "pad128")

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
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated subset of " + ", ".join(CASES))
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    if not set(cases) <= set(CASES):
        ap.error(f"--cases takes {', '.join(CASES)}, got {args.cases}")
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
    if "serving" in cases:
        g = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
        for mode in smoke.KV_MODES:
            for hkv in (32, 8):
                smoke.attention_case(torch, ra, dev, g, hkv, mode)
    if "mistral" in cases:
        gw = torch.Generator(device=dev).manual_seed(smoke.SEED + 6)
        for mode in smoke.KV_MODES:
            smoke.attention_case(torch, ra, dev, gw, 8, mode,
                                 **smoke.MISTRAL_CASE)
    if "gemma2" in cases:
        fam, hd, Hq, hkv = smoke.FAMILY_SHAPES[0]     # gemma2-9b
        gf = torch.Generator(device=dev).manual_seed(smoke.SEED + 11)
        for mode in smoke.KV_MODES:
            smoke.attention_case(torch, ra, dev, gf, hkv, mode,
                                 L=smoke.FAMILY_L, hd=hd, Hq=Hq, family=fam)
        gs = torch.Generator(device=dev).manual_seed(smoke.SEED + 14)
        for mode in smoke.KV_MODES:
            for opts in smoke.GEMMA2_SERVED_OPTIONS:
                smoke.attention_case(torch, ra, dev, gs, 8, mode,
                                     **smoke.gemma2_served_case(), **opts)
    if "narrow" in cases:
        gf = torch.Generator(device=dev).manual_seed(smoke.SEED + 11)
        for fam, hd, Hq, hkv in smoke.FAMILY_SHAPES:
            if hd <= 96:
                for mode in smoke.KV_MODES:
                    smoke.attention_case(torch, ra, dev, gf, hkv, mode,
                                         L=smoke.FAMILY_L, hd=hd, Hq=Hq,
                                         family=fam)
        gn = torch.Generator(device=dev).manual_seed(smoke.SEED + 17)
        for fam, hkv, case in smoke.SERVED_CASES:
            for mode in smoke.KV_MODES:
                smoke.attention_case(torch, ra, dev, gn, hkv, mode, **case())
    if "pad128" in cases:
        gp = torch.Generator(device=dev).manual_seed(smoke.SEED + 18)
        phi3 = next(f for f in smoke.FAMILY_SHAPES if f[0] == "phi3-mini")
        for mode in smoke.KV_MODES:
            smoke.attention_case(torch, ra, dev, gp, phi3[3], mode,
                                 L=smoke.FAMILY_L, hd=128, Hq=phi3[2],
                                 family="phi3-mini-pad128")
            smoke.attention_case(torch, ra, dev, gp, 32, mode,
                                 **dict(smoke.phi3_served_case(), hd=128,
                                        family="phi3-mini-served-pad128"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
