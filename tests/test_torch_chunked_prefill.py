"""Interleaved chunked prefill: the port's ServeEngine against the JAX
ServeEngine on the CPU.

A prompt whose new tokens exceed the largest prefill bucket (32 here) is
admitted with its row and its prefix hit, and each engine step extends
one chunk of it beside the running batch's decode; its last chunk samples
its first token. Both engines serve the same requests from the same
float32 weights (the JAX ones bridged into the port), the radix cache on
(the JAX engine on its Python tree), the JAX kernels in interpret mode:

* a prompt of 3 chunks, greedy tokens exact and the same cache state;
* the interleave contract of tests/test_serve.py's
  `test_chunked_prefill_interleaves_with_decode`: the incumbent gains
  tokens on every step while the chunks run;
* an abort after the first chunk: nothing enters the tree, nothing leaks;
* a radix hit on a long prompt (the chunks start at an odd offset);
* a windowed config whose window (40) reaches back across chunks;
* int8 and packed int4 KV under the near-tie contract of
  tests/test_torch_engine_quant.py;
* a multimodal long prompt with fused embeds made from its ids;
* the port alone: a chunk that raises aborts its own request (a request
  error) or reaches the step() caller (a system error), whose
  fail_running drops the chunked prefill.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.serve import engine as jengine
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch import bridge
from aurora_tpu_torch.ops.pallas import ragged_attention as tra
from aurora_tpu_torch.serve import engine as tengine
from aurora_tpu_torch.serve.scheduler import Request

from test_torch_engine_quant import assert_near_tie_parity
from test_torch_prefix_cache import _fused_embeds
from utils import drain_engine

# one 32-token bucket: every chunk is one [Bk, 32] extend, so that the JAX
# engine's jitted steps compile once per lane count for the file
BUCKETS = (32,)
MAX_NEW = 5       # the first token, then one 4-step decode block


def _llm(seed=0, **knobs):
    cfg = dataclasses.replace(JLlamaConfig.tiny(vocab_size=512),
                              num_hidden_layers=2, **knobs)
    tree = jax.device_get(jax.jit(init_llama_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg))
    model = bridge.llama_from_params(tree, bridge.llama_config_from(cfg),
                                     dtype=torch.float32, device="cpu")
    return cfg, tree, model


@pytest.fixture(scope="module")
def tiny():
    return _llm()


def _engines(llm, monkeypatch, embed_fns=(None, None), **kw):
    """The JAX engine on its Python tree, the port's on its C++ tree."""
    cfg, tree, model = llm
    common = dict(max_batch=4, max_seq_len=160, prefill_buckets=BUCKETS,
                  kv_chunk=32, decode_steps=4, num_slots=1024)
    common.update(kw)
    with monkeypatch.context() as m:
        m.setenv("AURORA_NATIVE_RADIX", "0")
        jeng = jengine.ServeEngine(
            tree, cfg, jengine.EngineConfig(kv_dtype=jnp.float32, **common),
            embed_fn=embed_fns[0])
    teng = tengine.ServeEngine(
        model, model.cfg, tengine.EngineConfig(kv_dtype=torch.float32,
                                               **common),
        embed_fn=embed_fns[1])
    return jeng, teng


def _toks(rng, n):
    return [int(x) for x in rng.integers(3, 512, size=n)]


def _reqs(cls, prompts, logprobs=False, max_new=MAX_NEW):
    return [cls(rid=r, input_ids=list(p), eos_ids=(), logprobs=logprobs,
                max_new_tokens=max_new) for r, p in prompts]


def _both(jeng, teng, prompts, **kw):
    want = drain_engine(jeng, _reqs(JRequest, prompts, **kw))
    got = drain_engine(teng, _reqs(Request, prompts, **kw))
    return want, got


def _same(want, got):
    for rid, w in want.items():
        assert got[rid].output_ids == w.output_ids, rid
        assert got[rid].n_cached == w.n_cached, rid


def test_three_chunk_prompt_matches_jax_fp32(tiny, monkeypatch):
    """70 new tokens: chunks of 32, 32 and 6 in three steps, beside a
    short prompt's wave; the cache then holds both prompts."""
    jeng, teng = _engines(tiny, monkeypatch)
    rng = np.random.default_rng(0)
    prompts = [("long", _toks(rng, 70)), ("short", _toks(rng, 9))]
    launches = tra.ragged_attention.launches
    want, got = _both(jeng, teng, prompts)
    _same(want, got)
    assert all(len(r.output_ids) == MAX_NEW for r in got.values())
    assert tra.ragged_attention.launches == launches   # CPU: the twins
    mem = teng.check_memory()
    assert mem == jeng.check_memory() and mem["leaked"] == 0
    assert mem["cached"] == 79
    assert teng.prefilling == [] and not teng.has_work()


def test_chunks_interleave_with_decode(tiny, monkeypatch):
    """tests/test_serve.py's interleave contract, on both engines: while
    the long prompt's chunks run (one a step), the incumbent decodes a
    block every step; both finish with the JAX engine's tokens."""
    jeng, teng = _engines(tiny, monkeypatch)
    rng = np.random.default_rng(1)
    short, long_ids = _toks(rng, 8), _toks(rng, 90)     # 3 chunks
    out = {}
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        a = cls(rid="a", input_ids=list(short), max_new_tokens=17,
                eos_ids=())
        eng.add_request(a)
        eng.step()                     # a admitted, first token, a block
        n_before = len(a.output_ids)
        b = cls(rid="b", input_ids=list(long_ids), max_new_tokens=MAX_NEW,
                eos_ids=())
        eng.add_request(b)
        ticks = 0
        while b.prefill_active or not b.output_ids:
            eng.step()
            ticks += 1
            assert ticks < 10
            assert len(a.output_ids) >= n_before + ticks \
                or a.finished is not None
        assert ticks == 3               # 90 new tokens in chunks of 32
        drain_engine(eng, [])
        out[eng is teng] = (a, b)
        assert eng.check_memory()["leaked"] == 0
    for jr, tr in zip(out[False], out[True]):
        assert tr.output_ids == jr.output_ids, tr.rid


def test_abort_mid_prefill_caches_nothing(tiny, monkeypatch):
    """Aborted after its first chunk: the row is released unlocked, no
    token of the prompt enters the tree, no slot leaks; the same prompt
    sent again prefills from scratch and matches the JAX engine."""
    jeng, teng = _engines(tiny, monkeypatch)
    rng = np.random.default_rng(2)
    ids = _toks(rng, 75)
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        req = cls(rid="x", input_ids=list(ids), max_new_tokens=MAX_NEW,
                  eos_ids=())
        eng.add_request(req)
        eng.step()
        assert req.prefill_active and req.prefill_done == 32
        assert eng.abort("x")
        done = drain_engine(eng, [])
        assert done["x"].finished.value == "abort"
        assert done["x"].output_ids == [] and not req.prefill_active
        assert req.prefill_embeds is None and not req.prefix_locked
        assert eng.prefilling == [] and all(r is None for r in eng.row_reqs)
        mem = eng.check_memory()
        assert mem["cached"] == 0 and mem["leaked"] == 0, mem
        assert len(eng.radix.match_prefix(ids)[0]) == 0
    want, got = _both(jeng, teng, [("again", ids)])
    _same(want, got)
    assert got["again"].n_cached == 0
    assert teng.check_memory() == jeng.check_memory()


def test_radix_hit_on_a_long_prompt(tiny, monkeypatch):
    """A 3-chunk prompt cached, then one that shares its first 37 tokens
    and adds 60: it hits 37 and prefills 60 in two chunks from position
    37; a full hit of the first prompt re-extends its last token only."""
    jeng, teng = _engines(tiny, monkeypatch)
    rng = np.random.default_rng(3)
    first = _toks(rng, 80)
    want, got = _both(jeng, teng, [("first", first)])
    more_w, more_g = _both(jeng, teng, [("hit", first[:37] + _toks(rng, 60)),
                                        ("full", list(first))])
    want.update(more_w)
    got.update(more_g)
    _same(want, got)
    assert (got["hit"].n_cached, got["full"].n_cached) == (37, 79)
    assert got["full"].output_ids == got["first"].output_ids
    mem = teng.check_memory()
    assert mem == jeng.check_memory() and mem["leaked"] == 0


def test_window_reaches_across_chunks():
    """sliding_window=40 with chunks of 32: each chunk's queries see keys
    written by the chunk before it, and the window's edge falls inside
    the earlier chunk. Greedy tokens exact against the JAX engine, and
    the windowed extend ran three times a layer (three chunks)."""
    llm = _llm(seed=5, sliding_window=40)
    with pytest.MonkeyPatch.context() as mp:
        jeng, teng = _engines(llm, mp, disable_radix_cache=True)
    rng = np.random.default_rng(5)
    plain = tra.ragged_attention_plain.calls
    want, got = _both(jeng, teng, [("w", _toks(rng, 88))], max_new=8)
    _same(want, got)
    assert tra.ragged_attention_plain.calls - plain == 3 * 2


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_quantized_kv_chunks_match_jax(tiny, monkeypatch, kv_quant):
    """int8 and packed int4 KV: a cached stem of 37 tokens (odd: the
    chunks start inside a packed byte), then 70 new tokens in 3 chunks;
    the near-tie contract against the JAX engine."""
    jeng, teng = _engines(tiny, monkeypatch, kv_quant=kv_quant)
    rng = np.random.default_rng(6)
    stem = _toks(rng, 37)
    want, got = _both(jeng, teng, [("stem", stem + _toks(rng, 3))],
                      logprobs=True)
    w2, g2 = _both(jeng, teng, [("long", stem + _toks(rng, 70))],
                   logprobs=True)
    want.update(w2)
    got.update(g2)
    assert got["long"].n_cached == want["long"].n_cached == 37
    assert_near_tie_parity(got, want)
    mem = teng.check_memory()
    assert mem == jeng.check_memory() and mem["leaked"] == 0


def test_multimodal_long_prompt(tiny, monkeypatch):
    """A prompt of 96 visual placeholders and 8 text ids (AuroraCap's
    layout) whose fused embeds come from the ids: chunked on both
    engines from the same embed_fn, tokens exact; a second question on
    the clip hits its visual prefix and extends one wave."""
    cfg, tree, model = tiny
    embed_fn = _fused_embeds(np.asarray(tree["embed_tokens"]))
    jeng, teng = _engines(tiny, monkeypatch, (embed_fn, embed_fn))
    rng = np.random.default_rng(7)
    visual = [cfg.vocab_size + 1000 + i for i in range(96)]
    head = _toks(rng, 4)
    waves = [[("q1", head + visual + _toks(rng, 8))],
             [("q2", head + visual + _toks(rng, 6))]]
    want, got = {}, {}
    for wave in waves:
        for eng, cls, out in ((jeng, JRequest, want), (teng, Request, got)):
            reqs = _reqs(cls, wave)
            for r in reqs:
                r.pixel_values = np.zeros((1,), np.uint8)  # a multimodal lane
            out.update(drain_engine(eng, reqs))
    _same(want, got)
    assert got["q2"].n_cached == 100
    mem = teng.check_memory()
    assert mem == jeng.check_memory() and mem["leaked"] == 0


@pytest.mark.parametrize("error", [ValueError, RuntimeError])
def test_a_failed_chunk(tiny, monkeypatch, error):
    """A chunk whose extend raises: a request error (ValueError) aborts
    that chunk's request only, and the short request beside it finishes;
    a system error (RuntimeError: torch's CUDA and memory errors, the
    kernels' launch failures) reaches the step() caller, whose
    fail_running then drops the chunked prefill. Nothing leaks and
    nothing of the partial prompt is cached either way."""
    _, teng = _engines(tiny, monkeypatch)
    rng = np.random.default_rng(8)
    long_ids = _toks(rng, 75)
    real = teng.runner.extend
    calls = []

    def extend(embeds, row_ids, q_offsets, kv_lens):
        calls.append(int(np.max(q_offsets)))
        if len(calls) == 3:               # the long prompt's second chunk
            raise error("injected chunk failure")
        return real(embeds, row_ids, q_offsets, kv_lens)

    monkeypatch.setattr(teng.runner, "extend", extend)
    teng.add_request(Request(rid="long", input_ids=list(long_ids),
                             max_new_tokens=MAX_NEW, eos_ids=()))
    teng.add_request(Request(rid="short", input_ids=_toks(rng, 9),
                             max_new_tokens=13, eos_ids=()))
    done = {r.rid: r for r in teng.step()}     # the wave, then chunk 1
    assert calls == [0, 0] and not done
    if error is ValueError:
        done.update(drain_engine(teng, []))
        assert done["long"].finished.value == "abort"
        assert "injected" in done["long"].error
        assert len(done["short"].output_ids) == 13
    else:
        with pytest.raises(RuntimeError, match="injected"):
            teng.step()
        failed = teng.fail_running()
        assert sorted(r.rid for r in failed) == ["long", "short"]
        assert all(not r.prefill_active and r.prefill_embeds is None
                   for r in failed)
        assert not teng.has_work()
    assert teng.prefilling == [] and all(r is None for r in teng.row_reqs)
    mem = teng.check_memory()
    assert mem["leaked"] == 0, mem
    assert len(teng.radix.match_prefix(long_ids)[0]) == 0
