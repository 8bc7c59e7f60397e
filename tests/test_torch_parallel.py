"""The port's sequence-parallel attention (aurora_tpu_torch/parallel/
{ulysses,ring,hybrid}.py) and its autograd collectives
(parallel/collectives.py) against the JAX package, on 4 gloo ranks on
the CPU.

One group of 4 ranks (tests/torch_mp_worker.py, suite "attn", sp = 4)
runs every case once, module-scoped; the tests compare what each rank
wrote with JAX on the same seeded numpy inputs:
  * every case's output and dq / dk / dv (a seeded output cotangent)
    against `mha_reference` of the whole sequence (plain XLA) and
    `jax.vjp` of it, reordered for the zigzag and stripe layouts (the
    port's ranks take sequences reordered by `zigzag_split` /
    `stripe_split`);
  * one case each against the reference's own `ulysses_mha`, `ring_mha`
    and `hybrid_mha` on the 8 virtual devices (forward; its Pallas flash
    runs in interpret mode, seconds a call);
  * each collective against its transpose (<f(x), w> = <x, fᵀ(w)>);
  * the flash calls each rank makes (the ring's case rules: contiguous
    causal rank r calls r + 1 blocks, a skipped block calls nothing).
Tolerances are the reference's tests/test_parallel.py ones: 2e-3 for
outputs, 5e-3 for gradients (fp32; the measured differences are ~1e-6),
1e-12 relative for the transposes (fp64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mp_worker as W
from aurora_tpu.ops.attention import mha_reference
from aurora_tpu.parallel import hybrid as jhybrid
from aurora_tpu.parallel import ring as jring
from aurora_tpu.parallel import ulysses as julysses
from aurora_tpu.parallel.mesh import MeshConfig, create_mesh
from aurora_tpu_torch.parallel import ring as tring
from aurora_tpu_torch.parallel.ring import _merge

OUT_TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = dict(rtol=5e-3, atol=5e-3)
SP = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("attn")
    W.launch("attn", SP, str(outdir))
    return [np.load(outdir / f"attn_rank{r}.npz") for r in range(SP)]


def _gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


def _jax_want(case):
    """mha_reference of the whole sequence and its vjp, in the case's
    layout order."""
    c = W.ATTN_CASES[case]
    q, k, v, dout, seg = W.attn_inputs(case)
    kw = {}
    if c.get("segments"):
        kw = dict(q_segment_ids=jnp.asarray(seg),
                  kv_segment_ids=jnp.asarray(seg))
    out, vjp = jax.vjp(lambda q, k, v: mha_reference(
        q, k, v, causal=c["causal"], **kw), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    grads = vjp(jnp.asarray(dout))
    order = W.layout_order(case, SP)
    return {name: np.asarray(x)[:, order] for name, x in
            zip(("out", "dq", "dk", "dv"), (out, *grads))}


@pytest.mark.parametrize("case", list(W.ATTN_CASES))
def test_sp_attention_and_grads_match_jax(ranks, case):
    want = _jax_want(case)
    for name, w in want.items():
        got = _gathered(ranks, f"{case}/{name}")
        tol = OUT_TOL if name == "out" else GRAD_TOL
        np.testing.assert_allclose(got, w, err_msg=f"{case} {name}", **tol)


@pytest.mark.parametrize("case,fn", [
    ("ulysses-causal", "ulysses"), ("ring-contiguous", "ring"),
    ("hybrid", "hybrid")])
def test_sp_attention_matches_the_reference_sp_functions(devices, ranks,
                                                         case, fn):
    """The reference's own shard_map attention on its 8 virtual devices
    (dp 2 × sp 4), forward, against the port's ranks."""
    c = W.ATTN_CASES[case]
    q, k, v, _, _ = (jnp.asarray(x) for x in W.attn_inputs(case))
    mesh = create_mesh(MeshConfig(dp=2, sp=SP), devices=devices)
    if fn == "ulysses":
        want = julysses.ulysses_mha(q, k, v, mesh, causal=c["causal"])
    elif fn == "ring":
        want = jring.ring_mha(q, k, v, mesh, causal=c["causal"])
    else:
        want = jhybrid.hybrid_mha(q, k, v, mesh, ulysses=W.ULYSSES,
                                  causal=c["causal"])
    np.testing.assert_allclose(_gathered(ranks, f"{case}/out"),
                               np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("name", list(W.TRANSPOSES))
def test_collective_backward_is_its_transpose(ranks, name):
    for r in ranks:
        lhs, rhs = r[f"transpose/{name}"]
        np.testing.assert_allclose(lhs, rhs, rtol=1e-12, err_msg=name)
        np.testing.assert_array_equal(r[f"transpose/{name}"],
                                      ranks[0][f"transpose/{name}"])


def _want_calls(case, rank):
    """Flash (twin) calls of one rank's forward by the ring's case rules."""
    c = W.ATTN_CASES[case]
    layout = c.get("layout", "contiguous")
    if c["mode"] == "ulysses":
        return 0                      # mha on the CPU: mha_reference
    if c.get("segments"):             # llama3 ring: one call a head chunk
        return 2 if c.get("heads_k_stride") == 1 else 1
    n = SP if c["mode"] == "ring" else SP // W.ULYSSES
    r = rank if c["mode"] == "ring" else rank // W.ULYSSES
    if not c["causal"]:
        return n
    if layout == "contiguous":
        return r + 1                  # later ranks' blocks are skipped
    if layout == "zigzag":
        return 2 + (n - 1)            # the diagonal takes two calls
    return n


@pytest.mark.parametrize("case", list(W.ATTN_CASES))
def test_flash_calls_follow_the_case_rules(ranks, case):
    got = [int(r[f"{case}/flash_calls"]) for r in ranks]
    assert got == [_want_calls(case, r) for r in range(SP)], case


def test_merge_takes_the_kernels_empty_rows():
    """lse -2.3819763e38 (the kernels' row that sees no key) and -1e30 (a
    skipped half-block) both count as empty: the merge keeps the other
    side exactly, and a row empty on both sides stays empty and finite,
    with finite gradients."""
    g = torch.Generator().manual_seed(0)
    acc = torch.randn(1, 3, 2, 4, generator=g)
    out = torch.randn(1, 3, 2, 4, generator=g)
    lse_acc = torch.tensor([[[0.5, -1e30, -2.3819763e38]] * 2])
    lse = torch.tensor([[[-2.3819763e38, 1.25, -1e30]] * 2])
    lse_acc.requires_grad_(True)
    lse.requires_grad_(True)
    merged, lse_new = _merge(acc, lse_acc, out, lse)
    np.testing.assert_array_equal(merged[:, 0].detach(), acc[:, 0])
    np.testing.assert_allclose(merged[:, 1].detach(), out[:, 1], rtol=1e-7)
    np.testing.assert_array_equal(merged[:, 2].detach(), 0 * acc[:, 2])
    np.testing.assert_allclose(lse_new[..., :2].detach(),
                               [[[0.5, 1.25]] * 2], rtol=1e-7)
    assert (lse_new[..., 2] <= -1e30).all()
    grads = torch.autograd.grad((merged.sum() + lse_new[..., :2].sum()),
                                (lse_acc, lse))
    assert all(bool(torch.isfinite(x).all()) for x in grads)


@pytest.mark.parametrize("kind", ["zigzag", "stripe"])
def test_reorders_match_jax(kind):
    x = np.random.default_rng(3).standard_normal((2, 16, 3)).astype(
        np.float32)
    split = getattr(tring, f"{kind}_split")
    unsplit = getattr(tring, f"{kind}_unsplit")
    want = np.asarray(getattr(jring, f"{kind}_split")(jnp.asarray(x), 4))
    got = split(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(unsplit(got, 4).numpy(), x)
