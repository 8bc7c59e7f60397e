"""The grouped-expert kernel's host-side plan (`moe_plan` of ops/moe.py),
with the kernel's device-side tile walk written out here
(csrc/moe_grouped_mm.cu).

Extend plan (`extend_kernel`): each expert's rows cut into blocks of
EXTEND_CLUSTER x EXTEND_ROWS from its first row; the blocks of all
experts in expert order (`cum`, a scan of the block counts), cut into
bands of EXTEND_BAND; inside a band the (column tile, block) items
column-major; persistent cluster c (of EXTEND_CLUSTER CTAs) takes items c,
c + clusters, ... With bf16 experts the CTA of rank r stores the block's
rows [b0 + EXTEND_ROWS r, + EXTEND_ROWS) inside the expert (none where
that starts past it) at the tile's EXTEND_COLS columns; with int8 experts
it stores all the block's rows at the tile's columns [EXTEND_COLS r / 2,
EXTEND_COLS (r + 1) / 2). Decode plan (`decode_kernel`):
block (x, y) takes column stripe x of the y-th expert that has rows (none:
it exits) and its rows in chunks of the plan's token tile. For seeded
offsets (empty experts, every row in one expert, rows outside
[offsets[0], offsets[E]), M < 64, M = 1; E 8, 64, 128), every row of
every expert must be stored exactly once in each column block by both
plans, and no row outside [offsets[0], offsets[E]) at all. No JAX:
`pytest --noconftest` runs this file alone in a few seconds.
"""

import numpy as np
import pytest

from aurora_tpu_torch.ops import moe as tmoe
from aurora_tpu_torch.ops.moe import (DECODE_COLS, DECODE_ROWS_PER_EXPERT,
                                      EXTEND_BAND, EXTEND_CLUSTER,
                                      EXTEND_COLS, EXTEND_ROWS, moe_plan)

H100_SMS = 132


def _offsets(M, E, layout, seed):
    """[E + 1] sorted offsets into M rows: `spread` random cuts with
    every third expert empty; `one` every row in expert E // 2; `inside`
    random cuts that leave rows before offsets[0] and past offsets[E]."""
    rng = np.random.default_rng(seed)
    if layout == "one":
        sizes = np.zeros(E, np.int64)
        sizes[E // 2] = M
        lo = 0
    else:
        lo, hi = 0, M
        if layout == "inside":
            lo, hi = sorted(rng.integers(0, M + 1, size=2).tolist())
        sizes = np.diff(np.sort(np.concatenate(
            [[0], rng.integers(0, hi - lo + 1, size=E - 1), [hi - lo]])))
        sizes[::3] = 0
        sizes[-1] = hi - lo - sizes[:-1].sum()
    return np.concatenate([[lo], lo + np.cumsum(sizes)]).astype(np.int64)


def _extend_walk(offs, N, grid, int8=False):
    """The extend kernel's tiles, walking its items for both ranks of a
    cluster: arrays (r0, r1, n0, cluster, e), item-major (rank 0's tile,
    then rank 1's); r1 <= r0 where the rank has no rows. Tiles are
    EXTEND_COLS columns wide with bf16 experts, half that with int8."""
    E = len(offs) - 1
    rows = np.diff(offs)
    size = EXTEND_CLUSTER * EXTEND_ROWS
    blocks = np.where(rows > 0, -(-rows // size), 0)
    cum = np.concatenate([[0], np.cumsum(blocks)])
    R, NC = int(cum[E]), -(-N // EXTEND_COLS)
    w = np.arange(R * NC)
    band = w // (EXTEND_BAND * NC)
    inside = w - band * EXTEND_BAND * NC
    nb = np.minimum(EXTEND_BAND, R - band * EXTEND_BAND)
    c = inside // nb
    p = band * EXTEND_BAND + inside % nb
    # the last expert e < E with cum[e] <= p (the kernel's binary search)
    e = np.searchsorted(cum[:E], p, side="right") - 1
    b0 = offs[e] + (p - cum[e]) * size
    b1 = np.minimum(offs[e + 1], b0 + size)
    rank = np.arange(EXTEND_CLUSTER)
    if int8:
        r0 = np.repeat(b0[:, None], EXTEND_CLUSTER, 1)
        r1 = np.repeat(b1[:, None], EXTEND_CLUSTER, 1)
        n0 = (c * EXTEND_COLS)[:, None] + rank * EXTEND_COLS // 2
    else:
        r0 = b0[:, None] + rank * EXTEND_ROWS
        r1 = np.minimum(b1[:, None], r0 + EXTEND_ROWS)
        n0 = np.repeat((c * EXTEND_COLS)[:, None], EXTEND_CLUSTER, 1)
    rep = lambda a: np.repeat(a, EXTEND_CLUSTER)
    return (r0.ravel(), r1.ravel(), n0.ravel(),
            rep(w % (grid // EXTEND_CLUSTER)), rep(e))


def _stores(r0, r1, n0, N):
    """The tiles that store anything: rows left, and columns inside N
    (an int8 tile's second half can start past it)."""
    live = (r1 > r0) & (n0 < N)
    return zip(r0[live], r1[live], n0[live])


def _decode_walk(offs, N, grid, tokens):
    """(r0, r1, n0) of every store of the decode kernel: block (x, y)
    finds the y-th expert with rows and stores its rows in chunks of
    `tokens` over stripe x."""
    stripes, slots = grid
    live = [e for e in range(len(offs) - 1) if offs[e + 1] > offs[e]]
    assert len(live) <= slots          # every expert with rows has a slot
    out = []
    for y in range(slots):
        if y >= len(live):
            continue                   # the block exits, reading nothing
        e = live[y]
        lo, hi = int(offs[e]), int(offs[e + 1])
        for x in range(stripes):
            for r in range(lo, hi, tokens):
                out.append((r, min(hi, r + tokens), x * DECODE_COLS))
    return out


def _check_stores(offs, N, stores, cols):
    """Each (r0, r1, n0) store covers rows [r0, r1) x columns [n0, n0 +
    cols) ∩ [0, N): every row of [offsets[0], offsets[E]) exactly once per
    column, no other row."""
    M = int(offs[-1]) + 3
    NB = -(-N // cols)
    hits = np.zeros((M, NB), np.int64)
    for r0, r1, n0 in stores:
        assert offs[0] <= r0 < r1 <= offs[-1]
        assert n0 % cols == 0 and n0 < N
        hits[r0:r1, n0 // cols] += 1
    want = np.zeros((M, NB), np.int64)
    want[int(offs[0]):int(offs[-1])] = 1
    np.testing.assert_array_equal(hits, want)


CASES = [(M, E, layout) for E in (8, 64, 128) for M in (1, 37, 63, 300, 2049)
         for layout in ("spread", "one", "inside")]


@pytest.mark.parametrize("M,E,layout", CASES)
def test_both_plans_store_every_row_once(M, E, layout):
    N = 1408
    offs = _offsets(M, E, layout, seed=M * 1000 + E)
    grid = moe_plan(M, 2048, N, E, False, H100_SMS)
    ext = moe_plan(max(M, DECODE_ROWS_PER_EXPERT * E + 1), 2048, N, E,
                   False, H100_SMS).grid
    for int8, cols in ((False, EXTEND_COLS), (True, EXTEND_COLS // 2)):
        r0, r1, n0, _, e = _extend_walk(offs, N, ext[0], int8)
        # a tile starts on its expert's row and never runs past the expert
        assert (r0 >= offs[e]).all() and (r1 <= offs[e + 1]).all()
        _check_stores(offs, N, _stores(r0, r1, n0, N), cols)
    for tokens in (8, 16):
        dec = (-(-N // DECODE_COLS), min(E, M))
        _check_stores(offs, N, _decode_walk(offs, N, dec, tokens),
                      DECODE_COLS)
    if grid.kind == "decode":
        assert grid.grid == (-(-N // DECODE_COLS), min(E, M))


@pytest.mark.parametrize("int8", [False, True])
def test_extend_walk_at_mixtral_extend(int8):
    """Mixtral's gate at 4 x 2048 tokens routed top-2: the extend plan,
    one block an SM, every row stored once; the first wave of clusters
    spans one band's rows and a few column tiles, so the rows and the
    weight columns it reads sit together in L2."""
    M, K, N, E = 16384, 4096, 14336, 8
    plan = moe_plan(M, K, N, E, int8, H100_SMS)
    assert plan.kind == "extend" and plan.grid == (H100_SMS,)
    offs = np.concatenate([[0], np.cumsum(np.full(E, M // E))])
    r0, r1, n0, _, _ = _extend_walk(offs, N, plan.grid[0], int8)
    _check_stores(offs, N, _stores(r0, r1, n0, N),
                  EXTEND_COLS // 2 if int8 else EXTEND_COLS)
    wave = slice(0, H100_SMS)                  # 66 clusters' first items
    assert (len(np.unique(n0[wave] // EXTEND_COLS))
            <= -(-H100_SMS // EXTEND_BAND))
    assert (r0[wave].max() - r0[wave].min()
            < EXTEND_BAND * EXTEND_CLUSTER * EXTEND_ROWS)


def test_plan_picks_decode_at_decode_rows_and_extend_past_them():
    # Mixtral at 4 tokens (8 rows), Qwen3-MoE (32), DeepSeek-V2-Lite (24)
    for M, K, N, E in ((8, 4096, 14336, 8), (32, 2048, 768, 128),
                       (24, 2048, 1408, 64)):
        for int8 in (False, True):
            plan = moe_plan(M, K, N, E, int8, H100_SMS)
            assert plan.kind == "decode" and plan.tokens == 8
            assert plan.grid == (-(-N // DECODE_COLS), min(E, M))
    assert moe_plan(16384, 4096, 14336, 8, True, H100_SMS).kind == "extend"
    assert moe_plan(65536, 2048, 768, 128, False, H100_SMS).kind == "extend"
    # the boundary: DECODE_ROWS_PER_EXPERT rows an expert on average
    for E in (8, 64, 128):
        at = DECODE_ROWS_PER_EXPERT * E
        assert moe_plan(at, 2048, 768, E, False).kind == "decode"
        assert moe_plan(at, 2048, 768, E, False).tokens == 16
        assert moe_plan(2 * E, 2048, 768, E, False).tokens == 8
        assert moe_plan(at + 1, 2048, 768, E, False).kind == "extend"


@pytest.mark.parametrize("sm_count", [132, 8])
def test_extend_grid_is_persistent_and_never_idle_by_plan(sm_count):
    """Whole clusters, at most one CTA an SM, and no more clusters than
    the most row blocks any split of M rows over E experts can give."""
    for M, N, E in ((300, 768, 8), (257, 256, 64), (16384, 14336, 8),
                    (65536, 4096, 128)):
        plan = moe_plan(M, 2048, N, E, False, sm_count)
        rows = EXTEND_CLUSTER * EXTEND_ROWS
        most = (-(-N // EXTEND_COLS)) * (-(-M // rows) + E)
        assert plan.kind == "extend"
        assert plan.grid == (EXTEND_CLUSTER * min(sm_count // 2, most),)
        assert plan.grid[0] % EXTEND_CLUSTER == 0
        assert plan.grid[0] <= sm_count
        for layout in ("spread", "one", "inside"):
            offs = _offsets(M, E, layout, seed=M + E)
            sizes = np.diff(offs)
            blocks = np.where(sizes > 0, -(-sizes // rows), 0).sum()
            assert blocks * (-(-N // EXTEND_COLS)) <= most


def test_module_exports_the_plan_constants():
    """The tile shape the kernel compiles in (XM, XN, DN, the cluster
    size), which the walks above assume."""
    assert tmoe.MoePlan._fields == ("kind", "grid", "tokens")
    assert EXTEND_ROWS == 128 and EXTEND_COLS == 256 and DECODE_COLS == 128
    assert EXTEND_CLUSTER == 2
