"""The decode kernel's split-KV grid, planned on the host.

`decode_plan` picks the split size and count from what the host knows (S,
the window, lanes x KV heads, the SM count); `_split_range` below is the
kernel's device-side rule for the keys a split attends over
(csrc/ragged_decode.cu, `decode_kernel`), written out in Python. For every
kv_len a lane can have, the live splits of the plan must cover the keys
the query sees exactly once, on packing-segment boundaries, with the new
token in exactly one of them; at the Mistral-7B and AuroraCap serving
shapes the grid must fill an H100's 132 SMs at least twice.
"""

import pytest

from aurora_tpu_torch.ops.pallas import ragged_attention as tra

SEG = tra.PACK_SEG
H100_SMS = 132


def _split_range(S, window, kv_len, split, sp):
    """(lo, hi): the keys [lo, hi) that split sp of a lane attends over
    (none when lo >= hi), as the kernel computes them: the split's range
    [base0 + sp * split, base0 + (sp + 1) * split), with base0 the segment
    of the first visible key under a window and 0 without, clipped to that
    key and to kv_len (at most S)."""
    kstart = max(0, kv_len - window) if window > 0 else 0
    base0 = kstart // SEG * SEG if window > 0 else 0
    return (max(base0 + sp * split, kstart),
            min(base0 + (sp + 1) * split, min(kv_len, S)))


@pytest.mark.parametrize("S", [256, 1792, 7168])
@pytest.mark.parametrize("window", [0, 512, 4096])
def test_decode_splits_cover_the_visible_keys_once(S, window):
    for heads in (1, 32, 128):
        split, nsplit = tra.decode_plan(S, window, heads, H100_SMS)
        assert split > 0 and split % SEG == 0 and nsplit >= 1
        for kv_len in range(0, S + 1, 1 if S <= 1792 else 7):
            kstart = max(0, kv_len - window) if window > 0 else 0
            covered = []
            holders = 0
            for sp in range(nsplit):
                lo, hi = _split_range(S, window, kv_len, split, sp)
                if lo >= hi:
                    continue
                # a live split starts on a segment or at the first visible
                # key, and ends on a segment or at kv_len
                assert lo % SEG == 0 or lo == kstart, (kv_len, sp, lo)
                assert hi % SEG == 0 or hi == kv_len, (kv_len, sp, hi)
                covered.append((lo, hi))
                holders += lo <= kv_len - 1 < hi
            keys = [k for lo, hi in covered for k in range(lo, hi)]
            assert keys == list(range(kstart, kv_len)), (kv_len, covered)
            assert holders == (1 if kv_len > 0 else 0), (kv_len, covered)


@pytest.mark.parametrize("name,S,window,lanes,hkv,want", [
    ("mistral-7b", 7168, 4096, 4, 8, (SEG, 17)),
    ("auroracap-7b", 1792, 0, 4, 32, (SEG, 7))])
def test_decode_grid_fills_the_card(name, S, window, lanes, hkv, want):
    split, nsplit = tra.decode_plan(S, window, lanes * hkv, H100_SMS)
    assert (split, nsplit) == want
    assert nsplit * lanes * hkv >= 2 * H100_SMS


def test_decode_plan_lengthens_splits_past_four_blocks_an_sm():
    # 32k-token rows at 64 lanes x 8 heads: one segment a split would be
    # 65,536 blocks; splits grow instead, still segment multiples
    split, nsplit = tra.decode_plan(32768, 0, 512, H100_SMS)
    assert split % SEG == 0 and split > SEG
    assert nsplit * split >= 32768
    assert nsplit * 512 <= 4 * H100_SMS * 2
    assert tra.decode_plan(128, 0, 4, H100_SMS) == (SEG, 1)
