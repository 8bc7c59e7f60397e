"""Port ops vs the JAX reference ops, on the same numpy inputs in float32
on the CPU. Tolerance: 1e-5 relative (and absolute) for every float op —
both sides compute in fp32 and differ only in summation order. ToMe merge
indices must be equal exactly."""

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
