"""The port's flash attention (CPU tensors → its plain twin) against the
JAX package's Pallas `flash_attention` / `flash_attention_lse` (interpret
mode on the CPU, blocks of 128), float32, inputs made with numpy from a
seed. Tolerances as the JAX package's own flash tests: 2e-5 for the
forward (out, lse), 1e-4 for the q/k/v gradients (fp32 summation order
over up to 500 keys). Also the dispatch `mha` and `mha_reference` with
segment ids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.ops import attention as jattn
from aurora_tpu.ops.pallas import flash_attention as jfa
from aurora_tpu_torch.ops import attention as tattn
from aurora_tpu_torch.ops.pallas import flash_attention as tfa

TOL_FWD = dict(rtol=2e-5, atol=2e-5)
TOL_GRAD = dict(rtol=1e-4, atol=1e-4)
BLOCKS = dict(block_q=128, block_kv=128)

# name: (T, S, H, Hkv, causal, q_offset, segments[, head_dim])
CASES = {
    "t128": (128, 128, 2, 2, False, 0, False),
    "t128_causal": (128, 128, 2, 2, True, 0, False),
    "t160": (160, 160, 2, 2, False, 0, False),
    "t160_causal": (160, 160, 2, 2, True, 0, False),
    "t300": (300, 300, 2, 2, False, 0, False),
    "t300_causal": (300, 300, 2, 2, True, 0, False),
    "gqa": (160, 160, 4, 2, True, 0, False),
    "q_offset": (128, 256, 2, 2, True, 128, False),
    "segments": (200, 200, 2, 2, True, 0, True),
    # the diagonal crosses two key tiles of 128, T ends inside a tile
    "t300_q_offset200": (300, 500, 2, 2, True, 200, False),
    "t200_s330": (200, 330, 2, 2, False, 0, False),
    "d64_causal": (160, 160, 2, 2, True, 0, False, 64),
}


def _inputs(case, seed=0, B=2, D=None):
    T, S, H, Hkv, causal, off, segs, *head = CASES[case]
    D = D or (head[0] if head else 128)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kw = dict(causal=causal, q_offset=off)
    if segs:
        # three packed segments; row 1's queries 150.. carry an id no key
        # has, so they see nothing (out 0, zero gradients)
        seg = np.zeros((B, T), np.int32)
        seg[:, 70:130] = 1
        seg[:, 130:] = 2
        qseg = seg.copy()
        qseg[1, 150:] = 7
        kw.update(q_segment_ids=qseg, kv_segment_ids=seg)
    return q, k, v, g, kw


def _jax_kw(kw):
    return {k: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
            for k, x in kw.items()}


def _torch_kw(kw):
    return {k: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
            for k, x in kw.items()}


def _leaves(*arrays):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]


@pytest.mark.parametrize("case", list(CASES))
def test_flash_forward_matches_jax(case):
    q, k, v, _, kw = _inputs(case)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **_jax_kw(kw), **BLOCKS)
    calls = tfa.flash_attention_plain.calls
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              **_torch_kw(kw))
    assert tfa.flash_attention_plain.calls == calls + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_FWD)
    if case == "segments":
        assert np.all(got.numpy()[1, 150:] == 0)


@pytest.mark.parametrize("case", list(CASES))
def test_flash_grads_match_jax(case):
    q, k, v, g, kw = _inputs(case, seed=1)
    jkw = _jax_kw(kw)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, **jkw, **BLOCKS)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _leaves(q, k, v)
    out = tfa.flash_attention(tq, tk, tv, **_torch_kw(kw))
    (out * torch.from_numpy(g)).sum().backward()
    for name, got, ref in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   err_msg=name, **TOL_GRAD)
    if case == "segments":
        assert np.all(tq.grad.numpy()[1, 150:] == 0)


@pytest.mark.parametrize("case", ["t160_causal", "gqa", "q_offset"])
def test_flash_lse_matches_jax(case):
    """out, lse and the gradients of a loss that uses both."""
    q, k, v, g, kw = _inputs(case, seed=2)
    B, H, T = q.shape[0], q.shape[2], q.shape[1]
    g_lse = np.random.default_rng(3).standard_normal((B, H, T)).astype(
        np.float32)

    def loss(q, k, v):
        out, lse = jfa.flash_attention_lse(q, k, v, **kw, **BLOCKS)
        return (jnp.sum(out * jnp.asarray(g))
                + jnp.sum(lse * jnp.asarray(g_lse))), (out, lse)

    (_, (j_out, j_lse)), j_grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _leaves(q, k, v)
    out, lse = tfa.flash_attention_lse(tq, tk, tv, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **TOL_FWD)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(j_lse),
                               **TOL_FWD)
    ((out * torch.from_numpy(g)).sum()
     + (lse * torch.from_numpy(g_lse)).sum()).backward()
    for name, got, ref in zip("qkv", (tq, tk, tv), j_grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   err_msg=name, **TOL_GRAD)


def test_rows_that_see_no_key():
    """q_offset < 0 under causal leaves the first rows with no key: out 0,
    lse at the mask value, zero gradients (the kernels' contract)."""
    rng = np.random.default_rng(4)
    q, k, v = _leaves(*(rng.standard_normal((1, 16, 2, 32)).astype(
        np.float32) for _ in range(3)))
    out, lse = tfa.flash_attention_lse(q, k, v, causal=True, q_offset=-4)
    assert torch.all(out[:, :4] == 0)
    assert torch.all(lse[:, :, :4] == np.float32(-2.3819763e38))
    (out.sum() + lse[:, :, 4:].sum()).backward()
    assert torch.all(q.grad[:, :4] == 0)
    assert torch.isfinite(q.grad).all() and torch.isfinite(k.grad).all()


@pytest.mark.parametrize("causal", [False, True])
def test_mha_reference_segments_match_jax(causal):
    q, k, v, _, kw = _inputs("segments", seed=5, D=32)
    segs = {n: kw[n] for n in ("q_segment_ids", "kv_segment_ids")}
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               **_jax_kw(segs))
    got = tattn.mha_reference(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, **_torch_kw(segs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_FWD)


def test_mha_dispatch_on_cpu():
    """CPU tensors take mha_reference unless use_flash=True; forcing flash
    with a mask raises (the reference would drop the mask)."""
    q, k, v, _, _ = _inputs("t128_causal", seed=6)
    q, k, v = map(torch.from_numpy, (q, k, v))
    calls = tfa.flash_attention_plain.calls
    ref = tattn.mha(q, k, v, causal=True)
    assert tfa.flash_attention_plain.calls == calls
    flash = tattn.mha(q, k, v, causal=True, use_flash=True)
    assert tfa.flash_attention_plain.calls == calls + 1
    np.testing.assert_allclose(flash.numpy(), ref.numpy(), **TOL_FWD)
    mask = torch.ones((2, 1, 1, 128), dtype=torch.bool)
    with pytest.raises(ValueError):
        tattn.mha(q, k, v, causal=True, mask=mask, use_flash=True)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v, q_segment_ids=torch.zeros(2, 128))
