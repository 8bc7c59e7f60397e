"""Time the fused W4 MLP kernel against its two-call W4A8 path across row
counts, for the aurora_tpu_torch package of a given source tree, on one
GPU:

    python3 aurora_tpu_torch/tools/time_fused_mlp.py --tree OTHER_TREE
    python3 aurora_tpu_torch/tools/time_fused_mlp.py --rows 1,4,8,16,64

One 7B layer's MLP (D 4096, I 11008, random W4 weights from chip_smoke's
seed), for each row count B: `fused_mlp_w4` and the two-call path
(chip_smoke's `fused_two_call`) as CUDA-graph replays (chip_smoke's
`graph_ms`), and the fused kernel's cluster plan where the tree has
`fused_mlp_grid` (I/ti clusters of C blocks of CB channels). One
`[fused]` line a row count.
"""

import argparse
import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO,
                    help="root of the source tree whose aurora_tpu_torch "
                         "is timed (default: this checkout)")
    ap.add_argument("--rows", default="1,4,8,9,16,17,32,33,64",
                    help="comma-separated row counts (1..64)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_fused_mlp: CUDA is not available", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from aurora_tpu_torch.ops.pallas import quant_matmul as qm
    from aurora_tpu_torch.serve.engine import _w4
    if not qm.__file__.startswith(tree + os.sep):
        print(f"time_fused_mlp: imported {qm.__file__}, not from {tree}",
              file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    dev = torch.device("cuda", 0)
    D, I = 4096, 11008
    g = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
    gu = _w4(torch.randn((2 * I, D), generator=g, device=dev) * 0.02)
    dn = _w4(torch.randn((D, I), generator=g, device=dev) * 0.02)
    tiles = qm.w4_mlp_tile_layout(*qm.w4_to_flat(*gu), *qm.w4_to_flat(*dn))
    grid = getattr(qm, "fused_mlp_grid", None)
    smoke.phase("tree", path=tree, card=repr(smoke.card_line()))

    for B in (int(b) for b in args.rows.split(",")):
        h = torch.randn((B, D), generator=g, device=dev, dtype=torch.bfloat16)
        fields = {}
        if grid is not None:
            C, CB = grid(B, *tiles[:3])
            fields["clusters"] = f"{tiles[0].shape[0]}x{C}/{CB}ch"
        fused = smoke.graph_ms(lambda: qm.fused_mlp_w4(h, *tiles))
        two = smoke.graph_ms(
            lambda: smoke.fused_two_call(torch, qm, gu, dn, h))
        smoke.phase("fused", B=B, **fields, ms=f"{fused:.4f}",
                    two_call_ms=f"{two:.4f}", ratio=f"{fused / two:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
