"""Port ops vs the JAX reference ops, on the same numpy inputs in float32
on the CPU. Tolerance: 1e-5 relative (and absolute) for every float op —
both sides compute in fp32 and differ only in summation order. ToMe merge
indices and merge_source's provenance must be equal exactly; the merges
of every mode and matcher (bipartite, kth, random given the reference's
split) are float ops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.ops import attention as jattn
from aurora_tpu.ops import norms as jnorms
from aurora_tpu.ops import rope as jrope
from aurora_tpu.ops import tome as jtome
from aurora_tpu_torch.ops import attention as tattn
from aurora_tpu_torch.ops import norms as tnorms
from aurora_tpu_torch.ops import rope as trope
from aurora_tpu_torch.ops import tome as ttome

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_layer_norm_and_quick_gelu():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tnorms.quick_gelu(torch.from_numpy(x))),
                               _np(jnorms.quick_gelu(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("scaling", [None, 4.0])
def test_rope_with_linear_scaling(scaling):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 4000, size=(2, 9)).astype(np.int32)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 16, 10000.0, scaling)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0, scaling)
    np.testing.assert_allclose(_np(tc), _np(jc), **TOL)
    np.testing.assert_allclose(_np(ts), _np(js), **TOL)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                              tc, ts)
    np.testing.assert_allclose(_np(tq), _np(jq), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)


@pytest.mark.parametrize("causal,hkv", [(False, 4), (True, 2)])
def test_mha_reference_with_bias(causal, hkv):
    rng = np.random.default_rng(3)
    B, T, H, D = 2, 11, 4, 16
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, D)).astype(np.float32)
    size = rng.integers(1, 5, size=(B, T, 1)).astype(np.float32)
    bias = np.log(size)[:, None, None, :, 0]                 # [B,1,1,T]
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               bias=jnp.asarray(bias), scale=D ** -0.5)
    got = tattn.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              bias=torch.from_numpy(bias), scale=D ** -0.5)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_tome_r_and_schedule():
    # AuroraCap-7B: 378 px, patch 14, 32 layers, kept ratio 0.2 → r = 18
    assert ttome.tome_r(378, 378, 14, 0.2, 32) == jtome.tome_r(
        378, 378, 14, 0.2, 32) == 18
    assert ttome.tome_schedule(730, 18, 32) == [
        tuple(s) for s in jtome.tome_schedule(730, 18, 32)]


@pytest.mark.parametrize("r,class_token", [(5, True), (9, False)])
def test_tome_merge_indices_exact(r, class_token):
    rng = np.random.default_rng(4)
    metric = rng.standard_normal((3, 37, 16)).astype(np.float32)
    want = jtome.compute_merge_indices(jnp.asarray(metric), r,
                                       class_token=class_token)
    got = ttome.compute_merge_indices(torch.from_numpy(metric), r,
                                      class_token=class_token)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_tome_merge_wavg():
    rng = np.random.default_rng(5)
    metric = rng.standard_normal((2, 21, 8)).astype(np.float32)
    x = rng.standard_normal((2, 21, 12)).astype(np.float32)
    size = rng.integers(1, 4, size=(2, 21, 1)).astype(np.float32)
    jm = jtome.bipartite_soft_matching(jnp.asarray(metric), 6)
    tm = ttome.bipartite_soft_matching(torch.from_numpy(metric), 6)
    jx, js = jtome.merge_wavg(jm, jnp.asarray(x), jnp.asarray(size))
    tx, ts = ttome.merge_wavg(tm, torch.from_numpy(x), torch.from_numpy(size))
    assert tx.shape == (2, 15, 12)
    np.testing.assert_allclose(_np(tx), _np(jx), **TOL)
    np.testing.assert_allclose(_np(ts), _np(js), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tome_merge_sums_in_fp32(dtype):
    """The merge's sum, many proposals to one target included, is the
    exact sum rounded to the dtype within one fp32 rounding of it: a
    one-hot product, which adds in a fixed order on the card too (where
    scatter_add's atomics add in any order)."""
    g = torch.Generator().manual_seed(0)
    tol = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}[dtype]
    for trial in range(40):
        t_b = int(torch.randint(3, 40, (1,), generator=g))
        r = int(torch.randint(1, 30, (1,), generator=g))
        b = torch.randn(2, t_b, 16, generator=g).to(dtype)
        idx = torch.randint(0, max(1, t_b // (1 + trial % 5)), (2, r),
                            generator=g)
        src = torch.randn(2, r, 16, generator=g).to(dtype)
        exact = b.double().scatter_add(
            1, idx[..., None].expand(-1, -1, 16), src.double())
        got = ttome._merge_add(b, idx, src)
        assert got.dtype == dtype
        torch.testing.assert_close(got.double(), exact, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["sum", "amax", "mean"])
def test_tome_apply_merge_modes(mode):
    """apply_merge in each mode vs the reference's, at indices from the
    same metric (several proposals to one target included)."""
    rng = np.random.default_rng(6)
    metric = rng.standard_normal((2, 25, 8)).astype(np.float32)
    x = rng.standard_normal((2, 25, 12)).astype(np.float32)
    idx = jtome.compute_merge_indices(jnp.asarray(metric), 9)
    want = jtome.apply_merge(jnp.asarray(x), *idx, mode=mode)
    got = ttome.apply_merge(torch.from_numpy(x),
                            *(torch.from_numpy(np.asarray(i, np.int64))
                              for i in idx), mode=mode)
    assert tuple(got.shape) == (2, 16, 12)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # the returned merge's default mode is the reference's ("mean")
    if mode == "mean":
        tm = ttome.bipartite_soft_matching(torch.from_numpy(metric), 9)
        np.testing.assert_allclose(_np(tm(torch.from_numpy(x))), _np(want),
                                   **TOL)


def test_tome_merge_source():
    """Provenance after two merges: the amax of the one-hot rows."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 17, 8)).astype(np.float32)
    m2 = rng.standard_normal((2, 12, 8)).astype(np.float32)
    jm1 = jtome.bipartite_soft_matching(jnp.asarray(x), 5)
    tm1 = ttome.bipartite_soft_matching(torch.from_numpy(x), 5)
    want = jtome.merge_source(jm1, jnp.asarray(x))
    got = ttome.merge_source(tm1, torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), _np(want))
    jm2 = jtome.bipartite_soft_matching(jnp.asarray(m2), 3,
                                        class_token=False)
    tm2 = ttome.bipartite_soft_matching(torch.from_numpy(m2), 3,
                                        class_token=False)
    want = jtome.merge_source(jm2, jnp.asarray(m2), want)
    got = ttome.merge_source(tm2, torch.from_numpy(m2), got)
    assert tuple(got.shape) == (2, 9, 17)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("k,mode", [(3, "mean"), (4, "sum"), (3, "amax"),
                                    (1, "mean")])
def test_tome_kth_matching(k, mode):
    rng = np.random.default_rng(8)
    metric = rng.standard_normal((2, 24, 8)).astype(np.float32)
    x = rng.standard_normal((2, 24, 6)).astype(np.float32)
    want = jtome.kth_bipartite_soft_matching(jnp.asarray(metric), k)(
        jnp.asarray(x), mode=mode)
    got = ttome.kth_bipartite_soft_matching(torch.from_numpy(metric), k)(
        torch.from_numpy(x), mode=mode)
    assert tuple(got.shape) == (2, 24 // k, 6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_tome_kth_matching_refuses_t_not_divisible():
    metric = torch.zeros((1, 25, 4))
    with pytest.raises(ValueError, match="k | T"):
        ttome.kth_bipartite_soft_matching(metric, 4)
    with pytest.raises(ValueError, match="k | T"):
        jtome.kth_bipartite_soft_matching(jnp.zeros((1, 25, 4)), 4)


@pytest.mark.parametrize("mode", ["mean", "sum", "amax"])
def test_tome_random_matching_given_the_reference_split(mode):
    """The reference draws its split from a JAX key (PRNGKey(0) by
    default), the port from a torch.Generator: given the reference's
    split, the port's matching gives the reference's merge."""
    import jax
    rng = np.random.default_rng(9)
    metric = rng.standard_normal((2, 20, 8)).astype(np.float32)
    x = rng.standard_normal((2, 20, 5)).astype(np.float32)
    r = 7
    want = jtome.random_bipartite_soft_matching(jnp.asarray(metric), r)(
        jnp.asarray(x), mode=mode)
    perm = np.asarray(jnp.argsort(jax.random.uniform(
        jax.random.PRNGKey(0), (2, 20)), axis=1)).astype(np.int64)
    got = ttome.split_soft_matching(
        torch.from_numpy(metric), torch.from_numpy(perm[:, :r]),
        torch.from_numpy(perm[:, r:]))(torch.from_numpy(x), mode=mode)
    assert tuple(got.shape) == (2, 13, 5)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # the port's own draw: a permutation from the generator, the same
    # split for the same seed
    a, b = ttome.random_split(torch.from_numpy(metric), r,
                              torch.Generator().manual_seed(3))
    a2, _ = ttome.random_split(torch.from_numpy(metric), r,
                               torch.Generator().manual_seed(3))
    assert torch.equal(a, a2)
    assert torch.equal(torch.cat([a, b], 1).sort(1).values,
                       torch.arange(20).expand(2, 20))
    out = ttome.random_bipartite_soft_matching(
        torch.from_numpy(metric), r, torch.Generator().manual_seed(3))(
        torch.from_numpy(x), mode=mode)
    assert tuple(out.shape) == (2, 13, 5)
    xt = torch.from_numpy(x)
    assert ttome.random_bipartite_soft_matching(
        torch.from_numpy(metric), 0)(xt) is xt
