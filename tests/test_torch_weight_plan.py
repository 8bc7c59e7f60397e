"""The weight streamers' host-side grid plan (`weight_plan` of
ops/pallas/quant_matmul.py), with the kernels' reading of it written out
here (csrc/weight_stream.cuh): block (tile t, split s) owns the output
columns [t·tile, min((t+1)·tile, N)) and the k range [s·span, min((s+1)·
span, K)), span = per·group. Every column and every group of K must fall
in exactly one block, the splits on group boundaries, with at least two
blocks per SM at the 7B decode projections."""

import pytest

from aurora_tpu_torch.ops.pallas.quant_matmul import (W8_GROUP, WEIGHT_TILE,
                                                      weight_plan)

H100_SMS = 132
# the 7B's four decode projections (fused streams): N, K
SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008)]


def _blocks(N, K, group, sm_count):
    tile, per, nsplit = weight_plan(N, K, group, sm_count)
    span = per * group
    cols = [(t * tile, min((t + 1) * tile, N)) for t in range(-(-N // tile))]
    ks = [(s * span, min((s + 1) * span, K)) for s in range(nsplit)]
    return tile, cols, ks


def _check_cover(N, K, group, sm_count):
    tile, cols, ks = _blocks(N, K, group, sm_count)
    assert tile == WEIGHT_TILE
    col_hits = [0] * N
    for a, b in cols:
        assert a < b
        for n in range(a, b):
            col_hits[n] += 1
    assert col_hits == [1] * N
    G = -(-K // group)
    group_hits = [0] * G
    for a, b in ks:
        assert a < b                            # no empty split
        assert a % group == 0                   # starts on a group boundary
        assert b % group == 0 or b == K         # ends on one, or at K
        for g in range(a // group, -(-b // group)):
            group_hits[g] += 1
    assert group_hits == [1] * G
    return cols, ks


@pytest.mark.parametrize("N,K", SHAPES_7B)
@pytest.mark.parametrize("group", [128, W8_GROUP])
def test_weight_plan_at_the_7b_projections(N, K, group):
    cols, ks = _check_cover(N, K, group, H100_SMS)
    assert len(cols) * len(ks) >= 2 * H100_SMS


@pytest.mark.parametrize("N", [1028, 772, 100, 4096 + 4])
@pytest.mark.parametrize("K", [256, 512, 11008])
@pytest.mark.parametrize("group", [16, 64, 128, 256])
@pytest.mark.parametrize("sm_count", [H100_SMS, 8])
def test_weight_plan_covers_off_tile_shapes(N, K, group, sm_count):
    assert K % group == 0                       # W4 groups divide K
    _check_cover(N, K, group, sm_count)


@pytest.mark.parametrize("K", [4112, 11008 + 16, 48])
def test_weight_plan_w8_ends_on_a_partial_group(K):
    """W8's split unit need not divide K (K % 16 == 0 only): the last
    split ends at K, inside its last group."""
    _, ks = _check_cover(4096, K, W8_GROUP, H100_SMS)
    assert ks[-1][1] == K


def test_weight_plan_has_a_short_last_split_at_7b_down():
    """down (K 11008 = 86 groups): the splits cannot all be equal, and the
    last one is the short one."""
    _, per, nsplit = weight_plan(4096, 11008, 128, H100_SMS)
    assert nsplit > 1 and 86 - (nsplit - 1) * per < per
