"""The port's offline generation (aurora_tpu_torch/generate/) against the
JAX package's on the tiny llama config, fp32 on the CPU.

`generate` must give JAX's greedy tokens and lengths exactly and its
logprobs within 1e-5, on a right-padded batch of two prompts (decoded
tokens at uniform cache slots, true RoPE positions), with an EOS that
ends rows early, with `min_new_tokens` banning the EOS, and with the
eos_ids=(-1,) sentinel, which must not ban the last vocabulary token.
`beam_generate` must give JAX's tokens and length for 2 and 4 beams,
with and without an EOS that finishes hypotheses mid-search. The top-k
and min-p filters keep JAX's sets; top-p keeps the nucleus (the serving
engines' rule: JAX's offline `_apply_top_p` keeps every token once any is
cut, which the port does not copy). 20,000 seeded draws at temperature
0.7 and top-p 0.9 must pass a chi-square test against the softmax of the
filtered logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from aurora_tpu.generate import beam as jbeam
from aurora_tpu.generate import engine as jengine
from aurora_tpu.generate import sampler as jsampler
from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu_torch import bridge
from aurora_tpu_torch.generate import beam as tbeam
from aurora_tpu_torch.generate import engine as tengine
from aurora_tpu_torch.generate import sampler as tsampler

V = 128


@pytest.fixture(scope="module")
def tiny():
    cfg = JLlamaConfig.tiny(vocab_size=V)
    tree = jax.device_get(init_llama_params(jax.random.PRNGKey(3), cfg,
                                            dtype=jnp.float32))
    tcfg = bridge.llama_config_from(cfg)
    model = bridge.llama_from_params(tree, tcfg, device="cpu",
                                     dtype=torch.float32)
    return cfg, tree, tcfg, model


def _batch(tree, prompts):
    """Right-padded ids → (JAX embeds, mask), (port embeds, mask)."""
    T = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), T), np.int64)
    mask = np.zeros((len(prompts), T), bool)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
        mask[i, :len(p)] = True
    emb = np.asarray(tree["embed_tokens"])[ids]
    return ((jnp.asarray(emb), jnp.asarray(mask)),
            (torch.from_numpy(emb), torch.from_numpy(mask)))


def _prompts(seed, lens=(13, 7)):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(3, V, size=n)] for n in lens]


def _both(tiny, prompts, max_new, **kw):
    cfg, tree, tcfg, model = tiny
    (je, jm), (te, tm) = _batch(tree, prompts)
    jsamp = jsampler.SamplingParams(**kw.pop("sampling", {}))
    tsamp = tsampler.SamplingParams(**jsamp.__dict__)
    want = jengine.generate(tree, cfg, je, jm, max_new_tokens=max_new,
                            sampling=jsamp, return_logprobs=True, **kw)
    got = tengine.generate(model, tcfg, te, tm, max_new_tokens=max_new,
                           sampling=tsamp, return_logprobs=True,
                           generator=torch.Generator().manual_seed(0), **kw)
    return got, want


def _assert_same(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.logprobs.numpy(),
                               np.asarray(want.logprobs), rtol=0, atol=1e-5)


def test_greedy_right_padded_batch_matches_jax(tiny):
    got, want = _both(tiny, _prompts(0), 10, eos_ids=(-1,))
    _assert_same(got, want)
    assert got.lengths.tolist() == [10, 10]


def test_eos_ends_rows_early_like_jax(tiny):
    prompts = _prompts(1)
    free, _ = _both(tiny, prompts, 10, eos_ids=(-1,))
    eos = int(free.tokens[1, 3])            # row 1 meets it at step 3
    got, want = _both(tiny, prompts, 10, eos_ids=(eos,))
    _assert_same(got, want)
    assert got.lengths[1] <= 4 and got.tokens[1, 4:].eq(0).all()


def test_min_new_tokens_bans_eos_like_jax(tiny):
    prompts = _prompts(2, (9,))
    first, _ = _both(tiny, prompts, 8, eos_ids=(-1,))
    eos = int(first.tokens[0, 0])
    got, want = _both(tiny, prompts, 8, eos_ids=(eos,),
                      sampling=dict(min_new_tokens=4))
    _assert_same(got, want)
    assert eos not in got.tokens[0, :4].tolist()


def test_never_stop_sentinel_does_not_wrap(tiny):
    """eos_ids=(-1,) with min_new_tokens: -1 must not ban token V-1. The
    head is scaled so that the greedy run picks V-1 at some steps; a
    wrapped ban would change them."""
    cfg, tree, tcfg, model = tiny
    tree = dict(tree, lm_head=np.asarray(tree["lm_head"]).copy())
    tree["lm_head"][:, V - 1] = 10.0 * np.abs(tree["lm_head"]).max()
    tiny = (cfg, tree, tcfg, bridge.llama_from_params(
        tree, tcfg, device="cpu", dtype=torch.float32))
    free, _ = _both(tiny, _prompts(3), 6, eos_ids=(-1,))
    got, want = _both(tiny, _prompts(3), 6, eos_ids=(-1,),
                      sampling=dict(min_new_tokens=6))
    _assert_same(got, want)
    assert torch.equal(got.tokens, free.tokens)
    assert got.tokens.eq(V - 1).any()


def test_top_k_one_sampling_is_greedy_like_jax(tiny):
    got, want = _both(tiny, _prompts(4), 8,
                      sampling=dict(temperature=0.7, top_k=1))
    _assert_same(got, want)


def test_penalties_warn(tiny):
    with pytest.warns(UserWarning, match="penalties are ignored"):
        _both(tiny, _prompts(5, (5,)), 2,
              sampling=dict(repetition_penalty=1.2))


def test_decode_tokens_trims_eos():
    class Tok:
        def decode(self, ids, skip_special_tokens=True):
            return ",".join(map(str, ids))
    res = tengine.GenerateResult(tokens=torch.tensor([[5, 6, 2, 0]]),
                                 lengths=torch.tensor([3]))
    assert tengine.decode_tokens(Tok(), res) == ["5,6"]


@pytest.mark.parametrize("beams", [2, 4])
@pytest.mark.parametrize("eos_at", [None, 0, 2])
def test_beam_matches_jax(tiny, beams, eos_at):
    """eos_at: the EOS is the never-stopping search's token at that step,
    so that hypotheses finish on the first step or mid-search (on this
    prompt the winner then ends in its EOS at length 3)."""
    cfg, tree, tcfg, model = tiny
    prompt = _prompts(11, (6,))
    (je, jm), (te, tm) = _batch(tree, prompt)
    eos = (2,)
    if eos_at is not None:
        toks, _ = jbeam.beam_generate(tree, cfg, je, jm, num_beams=beams,
                                      max_new_tokens=10, eos_ids=(-1,))
        eos = (int(np.asarray(toks)[eos_at]),)
    w_toks, w_len = jbeam.beam_generate(tree, cfg, je, jm, num_beams=beams,
                                        max_new_tokens=10, eos_ids=eos)
    g_toks, g_len = tbeam.beam_generate(model, tcfg, te, tm,
                                        num_beams=beams, max_new_tokens=10,
                                        eos_ids=eos)
    assert g_len == int(w_len)
    np.testing.assert_array_equal(g_toks.numpy(), np.asarray(w_toks))
    if eos_at == 2:
        assert g_len == 3 and int(g_toks[2]) == eos[0]


def _kept(x):
    return np.isfinite(np.asarray(x))


@pytest.mark.parametrize("k", [1, 5, 40])
def test_top_k_keeps_jax_set(k):
    logits = np.random.default_rng(k).standard_normal((4, 64)).astype(
        np.float32)
    got = tsampler._apply_top_k(torch.from_numpy(logits), k)
    want = jsampler._apply_top_k(jnp.asarray(logits), k)
    np.testing.assert_array_equal(_kept(got), _kept(want))
    assert (_kept(got).sum(-1) == k).all()


@pytest.mark.parametrize("min_p", [0.05, 0.3])
def test_min_p_keeps_jax_set(min_p):
    logits = np.random.default_rng(7).standard_normal((4, 64)).astype(
        np.float32) * 3
    got = tsampler._apply_min_p(torch.from_numpy(logits), min_p)
    want = jsampler._apply_min_p(jnp.asarray(logits), min_p)
    np.testing.assert_array_equal(_kept(got), _kept(want))


@pytest.mark.parametrize("p", [0.3, 0.9, 0.99])
def test_top_p_keeps_the_nucleus(p):
    """The smallest descending-probability set whose mass reaches p: a
    token is kept while the mass before it is at most p (written out per
    row; the JAX serving engine's `(cum - probs) > top_p` rule)."""
    logits = np.random.default_rng(8).standard_normal((6, 64)).astype(
        np.float32) * 2
    got = _kept(tsampler._apply_top_p(torch.from_numpy(logits), p))
    for row, kept in zip(logits, got):
        probs = np.exp(row - row.max())
        probs /= probs.sum()
        want = np.zeros(64, bool)
        before = 0.0
        for j in np.argsort(-row, kind="stable"):
            if before > p:
                break
            want[j] = True
            before += probs[j]
        np.testing.assert_array_equal(kept, want)


def test_sampler_distribution_chi_square():
    """20,000 draws over 16 tokens at temperature 0.7, top-p 0.9: counts
    against the softmax of the filtered logits, below the chi-square
    0.999 quantile; filtered tokens are never drawn."""
    n = 20000
    logits = torch.from_numpy(np.random.default_rng(9).standard_normal(
        16).astype(np.float32) * 1.5)
    params = tsampler.SamplingParams(temperature=0.7, top_p=0.9)
    draws = tsampler.sample_logits(logits.expand(n, 16), params,
                                   torch.Generator().manual_seed(0))
    counts = np.bincount(draws.numpy(), minlength=16)
    expect = torch.softmax(tsampler.filter_logits(logits[None], params),
                           dim=-1)[0].double().numpy() * n
    kept = expect > 0
    assert 1 < kept.sum() < 16
    assert counts[~kept].sum() == 0
    chi2 = (((counts[kept] - expect[kept]) ** 2) / expect[kept]).sum()
    assert chi2 < stats.chi2.ppf(0.999, kept.sum() - 1)


def test_sampling_needs_a_generator():
    with pytest.raises(ValueError):
        tsampler.sample_logits(torch.zeros(1, 4),
                               tsampler.SamplingParams(temperature=1.0))


def test_penalty_helpers_match_jax():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((3, 32)).astype(np.float32)
    counts = rng.integers(0, 3, size=(3, 32)).astype(np.float32)
    np.testing.assert_allclose(
        tsampler.apply_frequency_presence_penalties(
            torch.from_numpy(logits), torch.from_numpy(counts), 0.3,
            0.5).numpy(),
        np.asarray(jsampler.apply_frequency_presence_penalties(
            jnp.asarray(logits), jnp.asarray(counts), 0.3, 0.5)),
        rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tsampler.apply_repetition_penalty(
            torch.from_numpy(logits), torch.from_numpy(counts),
            1.3).numpy(),
        np.asarray(jsampler.apply_repetition_penalty(
            jnp.asarray(logits), jnp.asarray(counts), 1.3)))
