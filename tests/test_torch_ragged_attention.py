"""The port's ragged attention vs the JAX Pallas kernels.

On CPU tensors the port's public functions run their plain PyTorch twins;
the JAX kernels run in interpret mode (off-TPU default), as
tests/test_ragged_attention.py runs them. Inputs come from one numpy
generator; float32 on both sides; tolerance 2e-5 (the JAX kernel tests'
own bound: online vs one-shot softmax), 1e-5 for the packed int4 mode.
Row writes, packed bytes and scales are compared exactly. The sliding
window and the logit softcap run in every KV mode; there the JAX kernels
are jitted with the window as a traced scalar (as the JAX engine passes
it), so each (mode, G, cap) compiles once.
The zoo's head widths (64, 96, 256) and groups (9, 16, 48) are compared
too (`test_family_shapes_*`). The CUDA kernels
themselves are held against these twins on the card by
tests/test_torch_cuda_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.ops.pallas import ragged_attention as jra
from aurora_tpu.serve.engine import _kv_quantize
from aurora_tpu_torch.ops.pallas import ragged_attention as tra

TOL = dict(rtol=2e-5, atol=2e-5)
L, B, S, HD = 3, 4, 256, 64


def _rows(rng, hkv):
    k = rng.standard_normal((L, B, hkv, S, HD)).astype(np.float32)
    v = rng.standard_normal((L, B, hkv, S, HD)).astype(np.float32)
    return k, v


def _counts():
    return (tra.ragged_attention.launches,
            tra.ragged_decode_attention.launches)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_extend_plain_matches_jax(G):
    rng = np.random.default_rng(G)
    hkv, T = 2, 24
    k, v = _rows(rng, hkv)
    q = rng.standard_normal((4, T, hkv * G, HD)).astype(np.float32)
    # lane 0 from scratch, lane 1 after a cached prefix, lane 2 partially
    # padded queries, lane 3 a padded lane (kv_len 0); rows permuted
    offs = np.array([0, 100, 7, 0], np.int32)
    lens = np.array([T, 100 + T, 7 + T - 5, 0], np.int32)
    rows = np.array([2, 0, 3, 1], np.int32)
    layer = 1
    before = _counts()
    want = jra.ragged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        jnp.asarray(offs), jnp.asarray(rows), layer=layer, chunk=128)
    got = tra.ragged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), torch.from_numpy(offs),
        torch.from_numpy(rows), layer=layer)
    assert _counts() == before            # CPU tensors never launch
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3], **TOL)
    # padded lane: zeros, not NaN
    np.testing.assert_array_equal(got.numpy()[3], 0.0)


def test_extend_plain_4d_rows_and_unported_options():
    """4-D rows (no layer axis) against the XLA oracle, plain and with
    the sliding window, the logit cap and both (options the port once
    refused); packed rows without scales still raise ValueError."""
    rng = np.random.default_rng(7)
    k, v = _rows(rng, 1)
    q = 3 * rng.standard_normal((2, 1, 1, HD)).astype(np.float32)
    lens = np.array([60, 200], np.int32)
    offs = lens - 1
    rows = np.array([3, 1], np.int32)
    args = (torch.from_numpy(q), torch.from_numpy(k[0]),
            torch.from_numpy(v[0]), lens, offs, rows)
    for kw in (dict(), dict(window=16), dict(logit_cap=30.0),
               dict(window=16, logit_cap=30.0)):
        want = jra.ragged_attention_reference(
            jnp.asarray(q), jnp.asarray(k[0]), jnp.asarray(v[0]),
            jnp.asarray(lens), jnp.asarray(offs), jnp.asarray(rows), **kw)
        got = tra.ragged_attention(*args, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):      # packed int4 rows need scales
        tra.ragged_attention(*args, kv_pack=True)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_plain_matches_jax(G):
    rng = np.random.default_rng(10 + G)
    hkv = 2
    k, v = _rows(rng, hkv)
    q = rng.standard_normal((B, 1, hkv * G, HD)).astype(np.float32)
    k_new = rng.standard_normal((B, hkv, HD)).astype(np.float32)
    v_new = rng.standard_normal((B, hkv, HD)).astype(np.float32)
    lens = np.array([5, 130, 0, 256], np.int32)     # lane 2 inactive
    rows = np.array([1, 3, 0, 2], np.int32)
    layer = 2
    before = _counts()
    w_out, w_k, w_v = jra.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), jnp.asarray(rows),
        layer=layer, chunk=128)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    g_out, g_k, g_v = tra.ragged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tk, tv, torch.from_numpy(lens), torch.from_numpy(rows), layer=layer)
    assert _counts() == before
    assert g_k is tk and g_v is tv                   # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(w_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(w_v))
    np.testing.assert_allclose(g_out.numpy()[[0, 1, 3]],
                               np.asarray(w_out)[[0, 1, 3]], **TOL)
    np.testing.assert_array_equal(g_out.numpy()[2], 0.0)


def test_plain_counters_count_twin_calls():
    rng = np.random.default_rng(20)
    k, v = _rows(rng, 1)
    q = torch.from_numpy(rng.standard_normal((1, 1, 1, HD)).astype(
        np.float32))
    e0 = tra.ragged_attention_plain.calls
    d0 = tra.ragged_decode_attention_plain.calls
    tra.ragged_decode_attention(q, q[:, 0], q[:, 0], torch.from_numpy(k),
                                torch.from_numpy(v), [3], [0], layer=0)
    assert tra.ragged_decode_attention_plain.calls == d0 + 1
    assert tra.ragged_attention_plain.calls == e0


# --- nibble-packed int4 KV (kv_pack) ---------------------------------------

SP = 512                 # two 256-token packing segments
PACK_TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_kv_quantize(x):
    """The JAX engine's jitted _kv_quantize to the int4 grid (maxq 7)."""
    q, s = jax.jit(_kv_quantize, static_argnums=1)(jnp.asarray(x), 7.0)
    return np.array(q), np.array(s)


def _grid_rows(rng, hkv):
    """Packed K/V rows on the maxq-7 grid with their token-space scales,
    as the JAX package packs them → numpy (k4, v4, ks, vs) with k4/v4
    [L, B, hkv, SP/2, HD]."""
    out = []
    for _ in "kv":
        q4, s = _jax_kv_quantize(rng.standard_normal(
            (L, B, hkv, SP, HD)).astype(np.float32))
        out.append((np.array(jra.pack_int4_rows(jnp.asarray(q4))), s))
    (k4, ks), (v4, vs) = out
    return k4, v4, ks, vs


def test_pack_unpack_int4_rows_match_jax():
    rng = np.random.default_rng(50)
    q4 = rng.integers(-7, 8, size=(2, 3, SP, HD)).astype(np.int8)
    want = np.asarray(jra.pack_int4_rows(jnp.asarray(q4)))
    got = tra.pack_int4_rows(torch.from_numpy(q4))
    assert got.dtype == torch.int8 and got.shape == (2, 3, SP // 2, HD)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tra.unpack_int4_rows(got).numpy(), q4)
    np.testing.assert_array_equal(
        tra.unpack_int4_rows(got).numpy(),
        np.asarray(jra.unpack_int4_rows(jnp.asarray(want))))


@pytest.mark.parametrize("G", [1, 4])
def test_packed_extend_plain_matches_jax(G):
    rng = np.random.default_rng(60 + G)
    hkv, T = 2, 40
    k4, v4, ks, vs = _grid_rows(rng, hkv)
    q = rng.standard_normal((B, T, hkv * G, HD)).astype(np.float32)
    # lane 0 from scratch, lane 1 across the first segment's two planes
    # and into the second segment, lane 2 padded queries, lane 3 padded
    offs = np.array([0, 300, 100, 0], np.int32)
    lens = np.array([T, 300 + T, 100 + T - 7, 0], np.int32)
    rows = np.array([2, 0, 3, 1], np.int32)
    want = jra.ragged_attention(
        jnp.asarray(q), jnp.asarray(k4), jnp.asarray(v4), jnp.asarray(lens),
        jnp.asarray(offs), jnp.asarray(rows), layer=1, chunk=256,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), kv_pack=True)
    before = tra.ragged_attention.launches_int4
    got = tra.ragged_attention(
        torch.from_numpy(q), torch.from_numpy(k4), torch.from_numpy(v4),
        lens, offs, rows, layer=1, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs), kv_pack=True)
    assert tra.ragged_attention.launches_int4 == before
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3],
                               **PACK_TOL)
    np.testing.assert_array_equal(got.numpy()[3], 0.0)


@pytest.mark.parametrize("G", [1, 4])
def test_packed_decode_plain_matches_jax(G):
    """The new token's nibble lands in the low plane (position 4), the
    high plane (299), the second segment's high plane (511, the row's
    last) and nowhere (inactive lane); packed bytes, mate nibbles and
    scales are bitwise the reference kernel's."""
    rng = np.random.default_rng(70 + G)
    hkv = 2
    k4, v4, ks, vs = _grid_rows(rng, hkv)
    q = rng.standard_normal((B, 1, hkv * G, HD)).astype(np.float32)
    k_new = rng.standard_normal((B, hkv, HD)).astype(np.float32)
    v_new = rng.standard_normal((B, hkv, HD)).astype(np.float32)
    v_new[3, 1] = 0.0                            # all-zero token: 1e-8 floor
    lens = np.array([5, 300, 0, SP], np.int32)   # lane 2 inactive
    rows = np.array([1, 3, 0, 2], np.int32)
    w_out, w_k, w_v, w_ks, w_vs = jra.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(k4), jnp.asarray(v4), jnp.asarray(lens),
        jnp.asarray(rows), layer=1, chunk=256, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs), kv_maxq=7.0, kv_pack=True)
    tk, tv, tks, tvs = (torch.from_numpy(a.copy()) for a in (k4, v4, ks, vs))
    res = tra.ragged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tk, tv, lens, rows, layer=1, k_scales=tks, v_scales=tvs,
        kv_maxq=7.0, kv_pack=True)
    assert all(a is b for a, b in zip(res[1:], (tk, tv, tks, tvs)))
    for got, want in ((tk, w_k), (tv, w_v), (tks, w_ks), (tvs, w_vs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(tk.numpy(), k4)    # the writes happened
    np.testing.assert_allclose(res[0].numpy()[[0, 1, 3]],
                               np.asarray(w_out)[[0, 1, 3]], **PACK_TOL)
    np.testing.assert_array_equal(res[0].numpy()[2], 0.0)
    with pytest.raises(ValueError):              # a nibble holds ±7 at most
        tra.ragged_decode_attention(
            torch.from_numpy(q), torch.from_numpy(k_new),
            torch.from_numpy(v_new), tk, tv, lens, rows, layer=1,
            k_scales=tks, v_scales=tvs, kv_pack=True)


# --- sliding window and logit softcap, every KV mode -----------------------

WINDOWS = [0, 8, 100]    # off, inside a 24-token wave, mid-segment start
CAPS = [0.0, 30.0]


@functools.partial(jax.jit, static_argnames=("cap", "pack"))
def _jax_extend(q, k, v, lens, offs, rows, ks, vs, w, cap, pack):
    return jra.ragged_attention(q, k, v, lens, offs, rows, layer=1,
                                chunk=256, k_scales=ks, v_scales=vs,
                                window=w, logit_cap=cap, kv_pack=pack)


@functools.partial(jax.jit, static_argnames=("cap", "pack", "maxq"))
def _jax_decode(q, kn, vn, k, v, lens, rows, ks, vs, w, cap, pack, maxq):
    return jra.ragged_decode_attention(q, kn, vn, k, v, lens, rows, layer=1,
                                       chunk=256, k_scales=ks, v_scales=vs,
                                       window=w, logit_cap=cap,
                                       kv_maxq=maxq, kv_pack=pack)


@functools.lru_cache(maxsize=None)
def _mode_rows(mode, hkv):
    """(k, v, k_scales, v_scales, maxq) numpy rows of one seeded draw
    (cached: callers copy what they write into):
    fp32, int8 on the JAX engine's _kv_quantize grid, or packed int4
    (S = 256, one packing segment)."""
    rng = np.random.default_rng({"fp32": 80, "int8": 81, "int4": 82}[mode])
    if mode == "int4":
        return _grid_rows_s(rng, hkv, S) + (7.0,)
    k, v = _rows(rng, hkv)
    if mode == "fp32":
        return k, v, None, None, 127.0
    quant = jax.jit(_kv_quantize, static_argnums=1)
    (k8, ks), (v8, vs) = quant(jnp.asarray(k), 127.0), quant(jnp.asarray(v),
                                                              127.0)
    return (np.array(k8), np.array(v8), np.array(ks), np.array(vs), 127.0)


def _grid_rows_s(rng, hkv, s_tokens):
    out = []
    for _ in "kv":
        q4, sc = _jax_kv_quantize(rng.standard_normal(
            (L, B, hkv, s_tokens, HD)).astype(np.float32))
        out.append((np.array(jra.pack_int4_rows(jnp.asarray(q4))), sc))
    (k4, ks), (v4, vs) = out
    return k4, v4, ks, vs


def _opt(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("mode", ["fp32", "int8", "int4"])
def test_window_cap_extend_plain_matches_jax(mode, G, window, cap):
    """Lane 0 from scratch, lane 1 at offset 200 (a window of 100 then
    starts in the segment's high plane), lane 2 with padded queries, lane
    3 padded; q scaled by 3 so that the cap of 30 bends the scores."""
    hkv, T = 2, 24
    k, v, ks, vs, _ = _mode_rows(mode, hkv)
    rng = np.random.default_rng(90 + G)
    q = 3 * rng.standard_normal((B, T, hkv * G, HD)).astype(np.float32)
    offs = np.array([0, 200, 30, 0], np.int32)
    lens = np.array([T, 200 + T, 30 + T - 5, 0], np.int32)
    rows = np.array([2, 0, 3, 1], np.int32)
    pack = mode == "int4"
    want = _jax_extend(q, k, v, lens, offs, rows, ks, vs, window, cap=cap,
                       pack=pack)
    before = (tra.ragged_attention.launches_window,
              tra.ragged_attention_plain.calls)
    got = tra.ragged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lens, offs, rows, layer=1, window=window, logit_cap=cap,
        k_scales=_opt(ks), v_scales=_opt(vs), kv_pack=pack)
    assert (tra.ragged_attention.launches_window,
            tra.ragged_attention_plain.calls) == (before[0], before[1] + 1)
    tol = PACK_TOL if pack else TOL
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3], **tol)
    np.testing.assert_array_equal(got.numpy()[3], 0.0)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("mode", ["fp32", "int8", "int4"])
def test_window_cap_decode_plain_matches_jax(mode, G, window, cap):
    """Queries at 4 (the window of 8 sees the row start), 129 (a window
    of 100 starts in the low plane), nowhere (inactive lane) and 255 (it
    starts in the high plane, the new token in the high plane too); row
    writes and scales bitwise the reference kernel's."""
    hkv = 2
    k, v, ks, vs, maxq = _mode_rows(mode, hkv)
    rng = np.random.default_rng(95 + G)
    q = 3 * rng.standard_normal((B, 1, hkv * G, HD)).astype(np.float32)
    k_new = rng.standard_normal((B, hkv, HD)).astype(np.float32)
    v_new = rng.standard_normal((B, hkv, HD)).astype(np.float32)
    lens = np.array([5, 130, 0, S], np.int32)
    rows = np.array([1, 3, 0, 2], np.int32)
    pack = mode == "int4"
    want = _jax_decode(q, k_new, v_new, k, v, lens, rows, ks, vs, window,
                       cap=cap, pack=pack, maxq=maxq)
    state = [torch.from_numpy(a.copy()) for a in (k, v) + (
        () if ks is None else (ks, vs))]
    res = tra.ragged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        state[0], state[1], lens, rows, layer=1, window=window,
        logit_cap=cap, k_scales=state[2] if ks is not None else None,
        v_scales=state[3] if ks is not None else None, kv_maxq=maxq,
        kv_pack=pack)
    for got_t, want_t in zip(state, want[1:]):
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    tol = PACK_TOL if pack else TOL
    np.testing.assert_allclose(res[0].numpy()[[0, 1, 3]],
                               np.asarray(want[0])[[0, 1, 3]], **tol)
    np.testing.assert_array_equal(res[0].numpy()[2], 0.0)


def test_window_cap_change_the_twins():
    """The window and the cap each move the twins' output (so the parity
    cases above are not passing on options that were ignored), and a
    window of None, 0 or -3 is the unwindowed result bitwise."""
    hkv, T = 2, 24
    k, v, _, _, _ = _mode_rows("fp32", hkv)
    rng = np.random.default_rng(99)
    q = torch.from_numpy(
        3 * rng.standard_normal((B, T, hkv * 4, HD)).astype(np.float32))
    lens, offs, rows = [T, 200 + T, 49, 0], [0, 200, 30, 0], [2, 0, 3, 1]
    args = (q, torch.from_numpy(k), torch.from_numpy(v), lens, offs, rows)
    base = tra.ragged_attention(*args, layer=1)
    for w in (None, 0, -3):
        assert torch.equal(tra.ragged_attention(*args, layer=1, window=w),
                           base)
    for kw in (dict(window=8), dict(logit_cap=30.0)):
        moved = (tra.ragged_attention(*args, layer=1, **kw) - base).abs()
        assert moved[:3].max().item() > 1e-2, kw
    with pytest.raises(ValueError):
        tra.ragged_attention(*args, layer=1, logit_cap=-1.0)


# (head_dim, G) of the dense zoo's families beside the llama shapes:
# MiniCPM-2B (64, 1), Phi-3-mini (96, 1), Gemma-2-9B (256, 2),
# StarCoder2-7B (128, 9), GLM-4-9B (128, 16), StarCoder (128, 48, MQA);
# and head widths off the kernels' compile-time ones, which they run
# padded with zero columns: StableLM-3B's 80 (MHA), 160 with G 2
FAMILY_SHAPES = [(64, 1), (96, 1), (256, 2), (128, 9), (128, 16), (128, 48),
                 (80, 1), (160, 2)]


def _family_rows(rng, hd):
    k = rng.standard_normal((2, 4, 1, 256, hd)).astype(np.float32)
    v = rng.standard_normal((2, 4, 1, 256, hd)).astype(np.float32)
    return k, v


@pytest.mark.parametrize("hd,G", FAMILY_SHAPES)
def test_family_shapes_extend_plain_matches_jax(hd, G):
    """The extend twin at the zoo's head widths and groups (one KV head,
    G query heads) against the Pallas kernel: a lane from scratch, one
    after a prefix, one partially padded, one padded lane."""
    rng = np.random.default_rng(hd + G)
    k, v = _family_rows(rng, hd)
    T = 12
    q = rng.standard_normal((4, T, G, hd)).astype(np.float32)
    offs = np.array([0, 100, 7, 0], np.int32)
    lens = np.array([T, 100 + T, 7 + T - 5, 0], np.int32)
    rows = np.array([2, 0, 3, 1], np.int32)
    want = jra.ragged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        jnp.asarray(offs), jnp.asarray(rows), layer=1, chunk=128)
    got = tra.ragged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), torch.from_numpy(offs),
        torch.from_numpy(rows), layer=1)
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3], **TOL)
    np.testing.assert_array_equal(got.numpy()[3], 0.0)


@pytest.mark.parametrize("hd,G", FAMILY_SHAPES)
def test_family_shapes_decode_plain_matches_jax(hd, G):
    """The fused decode twin at the zoo's head widths and groups: row
    writes exact, outputs within TOL, an inactive lane's zeros."""
    rng = np.random.default_rng(100 + hd + G)
    k, v = _family_rows(rng, hd)
    q = rng.standard_normal((4, 1, G, hd)).astype(np.float32)
    k_new = rng.standard_normal((4, 1, hd)).astype(np.float32)
    v_new = rng.standard_normal((4, 1, hd)).astype(np.float32)
    lens = np.array([5, 130, 0, 256], np.int32)
    rows = np.array([1, 3, 0, 2], np.int32)
    w_out, w_k, w_v = jra.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), jnp.asarray(rows),
        layer=1, chunk=128)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    g_out = tra.ragged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tk, tv, torch.from_numpy(lens), torch.from_numpy(rows), layer=1)[0]
    np.testing.assert_array_equal(tk.numpy(), np.asarray(w_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(w_v))
    np.testing.assert_allclose(g_out.numpy()[[0, 1, 3]],
                               np.asarray(w_out)[[0, 1, 3]], **TOL)
    np.testing.assert_array_equal(g_out.numpy()[2], 0.0)
