"""The port's flash attention (CPU tensors → its plain twin) against the
JAX package's Pallas `flash_attention` / `flash_attention_lse` (interpret
mode on the CPU, blocks of 128), float32, inputs made with numpy from a
seed. Tolerances as the JAX package's own flash tests: 2e-5 for the
forward (out, lse), 1e-4 for the q/k/v gradients (fp32 summation order
over up to 500 keys). Also the launcher's head padding (the width table,
the padded twin at head_dim 72, 200 and 384), the dispatch `mha` and
`mha_reference` with segment ids."""

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
    # the widest heads the kernels take (384 pads to 512 on the card)
    "d512_causal": (160, 160, 2, 2, True, 0, False, 512),
    "d384_segments": (200, 200, 2, 2, True, 0, True, 384),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side in one fixed summation order: torch's CPU ops on
    one thread for this file, whatever the worker count or the load
    beside it (restored after). The twin measured bitwise equal at 1-16
    threads and beside 10 busy processes, and XLA's side at one Eigen
    thread and at its pool, so this pins an order that did not vary
    here; the one failure seen (t128, 20 outputs 3.9e-5 off) was 260x
    the 1.5e-7 that the two sides differ by."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("case", ["t160_causal", "gqa", "q_offset",
                                  "d512_causal"])
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


# head widths the CUDA kernels do not take as they are: the launcher pads
# the head with zero columns to the next width a kernel takes (72 → 80,
# 200 → 256, 384 → 512), keeps the caller's width's scale and slices the
# result back. That path (`_kernel_width`, `_pad_head`, the slice) on the
# twin against the Pallas kernel at the original width.
# D: (T, S, H, Hkv, causal, q_offset, segments)
PAD_CASES = {72: (160, 160, 2, 1, True, 0, False),
             200: (128, 256, 2, 2, True, 128, False),
             384: (160, 160, 2, 2, True, 0, True)}


def _padded_twin(q, k, v, **kw):
    D = q.shape[-1]
    W = tfa._kernel_width(D)
    out, _ = tfa.flash_attention_plain(
        *(tfa._pad_head(x, W) for x in (q, k, v)), scale=D ** -0.5, **kw)
    return out[..., :D]


@pytest.mark.parametrize("D", list(PAD_CASES))
def test_padded_head_matches_jax(D):
    T, S, H, Hkv, causal, off, segs = PAD_CASES[D]
    rng = np.random.default_rng(D)
    q, g = (rng.standard_normal((1, T, H, D)).astype(np.float32)
            for _ in "qg")
    k, v = (rng.standard_normal((1, S, Hkv, D)).astype(np.float32)
            for _ in "kv")
    kw = dict(causal=causal, q_offset=off)
    if segs:
        # queries 150.. carry an id no key has, so they see nothing
        seg = np.zeros((1, T), np.int32)
        seg[:, 70:130] = 1
        seg[:, 130:] = 2
        qseg = seg.copy()
        qseg[:, 150:] = 7
        kw.update(q_segment_ids=qseg, kv_segment_ids=seg)
    jkw = _jax_kw(kw)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, **jkw, **BLOCKS)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), want_g = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _leaves(q, k, v)
    out = _padded_twin(tq, tk, tv, **_torch_kw(kw))
    assert out.shape == (1, T, H, D)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **TOL_FWD)
    (out * torch.from_numpy(g)).sum().backward()
    for name, got, ref in zip("qkv", (tq, tk, tv), want_g):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   err_msg=name, **TOL_GRAD)


def test_kernel_width_table():
    """The widths the kernels take: multiples of 16 up to 128 as they are
    (no copy), else the next multiple of 16, then 256, then 512; 0 and
    past 512 raise. `_pad_head` appends zero columns, and returns its
    input when the width is already the kernel's."""
    widths = {1: 16, 8: 16, 16: 16, 64: 64, 72: 80, 96: 96, 100: 112,
              128: 128, 129: 256, 200: 256, 256: 256, 257: 512, 384: 512,
              500: 512, 512: 512}
    assert {d: tfa._kernel_width(d) for d in widths} == widths
    for d in (0, 513, 640):
        with pytest.raises(ValueError, match="512"):
            tfa._kernel_width(d)
    x = torch.randn(2, 3, 4, 72)
    padded = tfa._pad_head(x, 80)
    assert padded.shape == (2, 3, 4, 80)
    assert torch.equal(padded[..., :72], x)
    assert not padded[..., 72:].any()
    assert tfa._pad_head(x, 72) is x
    # the launcher's inputs: KV heads repeated, every head padded
    q, k = (torch.randn(1, 16, h, 72).bfloat16() for h in (4, 2))
    qp, kp, vp, _, _ = tfa._card_inputs(q, k, k, None, None)
    assert qp.shape == (1, 16, 4, 80) and kp.shape == vp.shape == qp.shape
    assert torch.equal(qp[..., :72], q) and not qp[..., 72:].any()
    assert torch.equal(kp[:, :, 1, :72], k[:, :, 0])


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


@pytest.mark.parametrize("D", [128, 256, 384, 512])
def test_mha_dispatch_sends_head_dim_128_and_256_to_flash(D):
    """The reference's rule (head_dim % 128 == 0) up to the kernels'
    ceiling of 512: a CUDA q of head_dim 256 (Gemma), 384 or 512 goes to
    the flash kernels, which take them on the card
    (test_flash_takes_head_dim_256_on_card,
    test_flash_takes_every_head_dim_up_to_512_on_card); 64 and 96, 640,
    a mask, a cap, T < 128 or a CPU q do not."""
    from types import SimpleNamespace
    cuda_q = SimpleNamespace(is_cuda=True, shape=(2, 256, 4, D))
    assert tattn.flash_dispatch(cuda_q)
    for other in ((2, 256, 4, 64), (2, 256, 4, 96), (2, 256, 4, 640),
                  (2, 64, 4, D)):
        assert not tattn.flash_dispatch(SimpleNamespace(is_cuda=True,
                                                        shape=other))
    assert not tattn.flash_dispatch(cuda_q, mask=object())
    assert not tattn.flash_dispatch(cuda_q, logit_cap=30.0)
    assert not tattn.flash_dispatch(torch.zeros((2, 256, 4, D)))
