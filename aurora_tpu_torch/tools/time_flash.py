"""Time the flash kernels (forward, dK/dV, dQ) and their SDPA yardsticks
for the aurora_tpu_torch package of a given source tree, on one GPU, so
that two trees can be compared in one call on one card:

    python3 aurora_tpu_torch/tools/time_flash.py --tree OTHER_TREE
    python3 aurora_tpu_torch/tools/time_flash.py          # this checkout

The cases and the timing are chip_smoke.py's own (`flash_case` with
`timed`, loaded from this checkout whatever the tree), at the widths
given by --widths: 256 is FLASH_D256 (google/gemma-7b's 16 heads, B 2,
T 2048), 512 FLASH_D512, 128 chip_smoke's training shape (B 4, T 2048,
H 32). Each case holds the tree's kernels against the tree's plain twin
at chip_smoke's tolerances (with a random lse cotangent, so that the
case runs on trees whose launcher predates the head padding) and prints
the tree's kernels' registers, spill and shared bytes (a `[build]` line)
and chip_smoke's `[kernels]` line: `*_ms` are CUDA-event medians, `*_bound`
the least time at 989 TFLOP/s or 3.35 TB/s, `library_*` SDPA's.
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
    ap.add_argument("--widths", default="256",
                    help="comma-separated head widths among 128, 256, 512")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_flash: CUDA is not available", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from aurora_tpu_torch.ops import cuda_build
    from aurora_tpu_torch.ops.pallas import flash_attention as fa
    if not fa.__file__.startswith(tree + os.sep):
        print(f"time_flash: imported {fa.__file__}, not from {tree}",
              file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = {128: (4, 2048, 32), 256: (smoke.FLASH_D256["B"],
                                        smoke.FLASH_D256["T"],
                                        smoke.FLASH_D256["H"]),
              512: (smoke.FLASH_D512["B"], smoke.FLASH_D512["T"],
                    smoke.FLASH_D512["H"])}
    widths = [int(w) for w in args.widths.split(",")]
    if any(w not in shapes for w in widths):
        print(f"time_flash: --widths takes {sorted(shapes)}",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    head = subprocess.run(["git", "-C", tree, "rev-parse", "--short",
                           "HEAD"], capture_output=True, text=True)
    smoke.phase("tree", path=tree, commit=head.stdout.strip() or None,
                card=repr(smoke.card_line()))
    cuda_build.load_library()
    # registers, spill and shared bytes of the tree's kernels at each width
    smoke.phase("build", **{
        name: "regs={regs}/local={local_bytes}/smem={smem}".format(
            **cuda_build.kernel_attrs(name))
        for w in widths for k in ("fwd", "bwd_dkv", "bwd_dq")
        for name in [f"flash_{k}" + ("" if w == 128 else f"_d{w}")]})
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 11)
    for w in widths:
        B, T, H = shapes[w]
        smoke.flash_case(torch, fa, dev, g, B, T, H, H, with_lse=True,
                         timed=True, D=w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
