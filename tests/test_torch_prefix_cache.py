"""The port's prefix cache against the JAX package's.

* The trees: the port's Python RadixCache, its C++ tree (built from
  aurora_tpu_torch/native into build/native/) and the JAX RadixCache run
  the same seeded sequence of match / insert / lock / unlock / evict
  operations in lockstep, one operation on each in turn, so that their LRU
  orders agree: every result must be equal.
* The prefix copies: the port's `_load_prefix` / `_store_prompt` and the
  JAX jitted ones on bf16 rows, int8 rows with scale planes and packed
  int4 rows must leave bitwise-equal rows and pools, at a start of 0, an
  odd start inside a PACK_SEG segment, a window at the row tail, a chunk
  wider than the row and padded slots.
* The engines: both serve prompts that share prefixes with the radix
  cache on (the JAX engine on its Python tree, so that the JAX package's
  native library is neither built nor loaded; the port on its C++ tree):
  the cached lengths, `check_memory()` and `flush_cache()` must be equal,
  tokens exactly in fp32 and under the near-tie contract of
  tests/test_torch_engine_quant.py with int8 KV, packed int4 KV and W4
  weights; then an abort of a running request that holds a prefix,
  eviction under a pool of 64 slots, and multimodal prompts that share a
  clip.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models import aurora as jaurora
from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.serve import engine as jengine
from aurora_tpu.serve.kv_pool import KVPool as JKVPool
from aurora_tpu.serve.multimodal import AuroraCapServing as JServing
from aurora_tpu.serve.radix_cache import RadixCache as JRadixCache
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch import bridge
from aurora_tpu_torch.native import NativeRadixCache
from aurora_tpu_torch.ops.pallas.ragged_attention import unpack_int4_rows
from aurora_tpu_torch.serve import engine as tengine
from aurora_tpu_torch.serve.kv_pool import KVPool, SlotAllocator
from aurora_tpu_torch.serve.multimodal import AuroraCapServing
from aurora_tpu_torch.serve.radix_cache import NullPrefixCache, RadixCache
from aurora_tpu_torch.serve.scheduler import Request

from test_torch_engine_quant import assert_near_tie_parity
from utils import drain_engine, random_frames


# ---------------------------------------------------------------------------
# The trees
# ---------------------------------------------------------------------------

TREES = ("port", "native", "jax")


def test_radix_trees_agree_in_lockstep():
    freed = {name: [] for name in TREES}

    def sink(name):
        return lambda s: freed[name].extend(int(x) for x in s)

    trees = {"port": RadixCache(free_slots=sink("port")),
             "native": NativeRadixCache(free_slots=sink("native")),
             "jax": JRadixCache(free_slots=sink("jax"))}
    rng = np.random.default_rng(0)
    next_slot, locks, counts = 0, [], {}
    ops = ("match", "insert", "insert", "lock", "unlock", "evict")
    for step in range(800):
        op = ops[rng.integers(len(ops))]
        counts[op] = counts.get(op, 0) + 1
        # a 3-token alphabet: prompts share prefixes of every length, so
        # inserts and matches split nodes all the time
        prompt = rng.integers(0, 3, size=rng.integers(1, 14)).tolist()
        if op == "insert":
            slots = np.arange(next_slot, next_slot + len(prompt),
                              dtype=np.int32)
            next_slot += len(prompt)
            got = {n: t.insert(prompt, slots) for n, t in trees.items()}
        elif op in ("match", "lock"):
            res = {n: t.match_prefix(prompt) for n, t in trees.items()}
            got = {n: r[0].tolist() for n, r in res.items()}
            if op == "lock":
                for n, t in trees.items():
                    t.lock(res[n][1], +1)
                locks.append({n: r[1] for n, r in res.items()})
        elif op == "unlock":
            if not locks:
                continue
            handles = locks.pop(int(rng.integers(len(locks))))
            for n, t in trees.items():
                t.lock(handles[n], -1)
            got = {}
        else:
            k = int(rng.integers(1, 12))
            got = {n: t.evict(k) for n, t in trees.items()}
        for n in TREES:
            assert got.get(n) == got.get("jax"), (step, op, n, got)
            assert freed[n] == freed["jax"], (step, op, n)
            assert (trees[n].total_cached_tokens()
                    == trees["jax"].total_cached_tokens()), (step, op, n)
            assert (trees[n].evictable_size
                    == trees["jax"].evictable_size), (step, op, n)
    assert min(counts.values()) >= 80 and len(freed["jax"]) > 100, counts
    for n, t in trees.items():
        for handles in locks:
            t.lock(handles[n], -1)
        t.evict(1 << 20)
        assert t.total_cached_tokens() == 0 and t.evictable_size == 0, n


def test_slot_allocator_and_null_cache():
    a = SlotAllocator(8)
    s1 = a.alloc(5)
    assert a.available() == 3 and a.alloc(4) is None
    a.free(s1[:2])
    assert a.available() == 5
    with pytest.raises(RuntimeError):
        a.free(np.arange(4))
    null = NullPrefixCache()
    slots, node = null.match_prefix([1, 2, 3])
    assert len(slots) == 0 and node is null.root
    assert null.evict(10) == 0 and null.total_cached_tokens() == 0
    with pytest.raises(NotImplementedError):
        null.insert([1], np.zeros(1, np.int32))


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_kv_pool_bytes_match_jax_and_the_engine_sizing(kv_quant):
    jc = JLlamaConfig.tiny()
    tc = bridge.llama_config_from(jc)
    quant = kv_quant != "none"
    pool = KVPool(tc, 96, torch.float32, quant=quant, device="cpu")
    jpool = JKVPool(jc, 96, jnp.float32, quant=quant)
    assert pool.hbm_bytes() == jpool.hbm_bytes()
    assert {n: tuple(t.shape) for n, t in pool.planes.items()} == \
        {n: tuple(a.shape) for n, a in jpool.as_dict().items()}
    # the pool is token-granular: int4 KV sizes it as int8 KV does
    per_token = tengine.kv_bytes_per_token_layer(
        tc, "int8" if quant else "none", torch.float32)
    assert pool.hbm_bytes() == 96 * tc.num_hidden_layers * per_token
    # an MLA config's latent pool: one plane of one "head", no V
    jm = dataclasses.replace(jc, mla_kv_lora_rank=8, num_key_value_heads=1,
                             head_dim_override=12)
    mpool = KVPool(bridge.llama_config_from(jm), 4, torch.float32,
                   quant=quant, device="cpu")
    jmpool = JKVPool(jm, 4, jnp.float32, quant=quant)
    assert {n: tuple(t.shape) for n, t in mpool.planes.items()} == \
        {n: tuple(a.shape) for n, a in jmpool.as_dict().items()}
    assert mpool.hbm_bytes() == jmpool.hbm_bytes()


# ---------------------------------------------------------------------------
# The prefix copies
# ---------------------------------------------------------------------------

L_, B_, HKV, S_, HD, NSLOTS = 2, 3, 2, 1024, 8, 700

# (start, n_valid, chunk width): from 0 with padding; an odd start in the
# high half of a PACK_SEG segment; a chunk across a segment boundary; the
# row's tail (the reference's window shifts back); a chunk wider than the
# row. Two chunk widths: the JAX functions compile once for each
COPY_CASES = [(0, 100, 128), (131, 77, 128), (200, 120, 128),
              (S_ - 37, 37, 128), (5, 300, 2048)]


def _bf16(x):
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _copy_state(mode, rng):
    """Random rows and pool (numpy) of one KV mode."""
    f32 = np.float32
    if mode == "bf16":
        val = lambda *s: _bf16(rng.normal(size=s)).float().numpy()  # noqa
        return ({n: val(L_, B_, HKV, S_, HD) for n in "kv"},
                {n: val(L_, NSLOTS, HKV, HD) for n in "kv"})
    Sv = S_ // 2 if mode == "int4" else S_
    rows = {n: rng.integers(-128, 128, size=(L_, B_, HKV, Sv, HD),
                            dtype=np.int8) for n in "kv"}
    lo = -8 if mode == "int4" else -127
    pool = {n: rng.integers(lo, -lo, size=(L_, NSLOTS, HKV, HD),
                            dtype=np.int8) for n in "kv"}
    for n in ("ks", "vs"):
        rows[n] = rng.random((L_, B_, HKV, S_), dtype=f32)
        pool[n] = rng.random((L_, NSLOTS, HKV), dtype=f32)
    return rows, pool


def _to_torch(d, mode):
    return {n: (_bf16(a) if mode == "bf16" and n in "kv"
                else torch.from_numpy(a.copy())) for n, a in d.items()}


def _to_jax(d, mode):
    return {n: jnp.asarray(a, jnp.bfloat16 if mode == "bf16" and n in "kv"
                           else a.dtype) for n, a in d.items()}


def _assert_bitwise(got, want, what):
    for n in want:
        g = got[n].float().numpy() if got[n].dtype == torch.bfloat16 \
            else got[n].numpy()
        w = np.asarray(jnp.asarray(want[n], jnp.float32)
                       if want[n].dtype == jnp.bfloat16 else want[n])
        np.testing.assert_array_equal(g, w, err_msg=f"{what}/{n}")


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_prefix_copies_match_jax_bitwise(mode):
    rng = np.random.default_rng(["bf16", "int8", "int4"].index(mode))
    rows, pool = _copy_state(mode, rng)
    for start, n_valid, nb in COPY_CASES:
        what = f"{mode}/start{start}/n{n_valid}/nb{nb}"
        row = int(rng.integers(B_))
        # load: slots past n_valid are padding (zeros, as _prepare pads)
        slots = np.zeros(nb, np.int32)
        slots[:n_valid] = rng.choice(NSLOTS, size=n_valid, replace=False)
        got = tengine._load_prefix(_to_torch(rows, mode),
                                   _to_torch(pool, mode), slots, row,
                                   start, n_valid)
        want = jengine._load_prefix(
            _to_jax(rows, mode), _to_jax(pool, mode), jnp.asarray(slots),
            jnp.asarray(row, np.int32), jnp.asarray(start, np.int32),
            jnp.asarray(n_valid, np.int32))
        _assert_bitwise(got, want, "load/" + what)
        # the load changed the row (so the case tests something)
        assert any(not np.array_equal(np.asarray(want[n], np.float32),
                                      rows[n].astype(np.float32))
                   for n in want), what
        # store: the slots past the chunk are padding (== NSLOTS, dropped)
        n = min(n_valid, S_ - start)
        slots = np.full(nb, NSLOTS, np.int32)
        slots[:n] = rng.choice(NSLOTS, size=n, replace=False)
        got = tengine._store_prompt(_to_torch(pool, mode),
                                    _to_torch(rows, mode), row, start, slots)
        want = jengine._store_prompt(
            _to_jax(pool, mode), _to_jax(rows, mode),
            jnp.asarray(row, np.int32), jnp.asarray(start, np.int32),
            jnp.asarray(slots))
        _assert_bitwise(got, want, "store/" + what)


def test_packed_store_then_load_round_trips_the_row():
    """int4: a row stored into the pool and loaded into another row gives
    back the same packed bytes, mate nibbles of the seam included."""
    rng = np.random.default_rng(5)
    rows, pool = _copy_state("int4", rng)
    rows, pool = _to_torch(rows, "int4"), _to_torch(pool, "int4")
    slots = rng.choice(NSLOTS, size=300, replace=False).astype(np.int32)
    tengine._store_prompt(pool, rows, 0, 0, slots)
    # the second row: its first 131 tokens from the pool, the rest its own
    before = unpack_int4_rows(rows["k"][:, 1])
    tengine._load_prefix(rows, pool, slots[:131], 1, 0, 131)
    for name in ("k", "v"):
        a = unpack_int4_rows(rows[name][:, 1])
        b = unpack_int4_rows(rows[name][:, 0])
        assert torch.equal(a[:, :, :131], b[:, :, :131]), name
    assert torch.equal(unpack_int4_rows(rows["k"][:, 1])[:, :, 131:],
                       before[:, :, 131:])


# ---------------------------------------------------------------------------
# The engines
# ---------------------------------------------------------------------------

# Every engine test keeps to the same wave shape (4 lanes of one 64-token
# bucket, 5 new tokens: one 4-step decode block), so that the JAX engine's
# jitted steps compile once for the file (its interpret-mode kernels'
# compiles are most of the file's time); a hit is seen in n_cached and
# q_offsets, not in a smaller bucket
BUCKETS = (64,)
MAX_NEW = 5


@pytest.fixture(scope="module")
def tiny():
    """The tiny AuroraCap's config and its LLM (2 layers): the JAX params
    and the same weights in the port. No test here runs the ViT, and the
    JAX side's compiles are most of this file's time."""
    cfg = jaurora.AuroraConfig.tiny()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        JLlamaConfig.tiny(vocab_size=512), num_hidden_layers=2))
    tree = jax.device_get(jax.jit(init_llama_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg.llm))
    llm = bridge.llama_from_params(tree, bridge.llama_config_from(cfg.llm),
                                   dtype=torch.float32, device="cpu")
    return cfg, tree, llm


def _engines(tiny, monkeypatch, embed_fns=(None, None), **kw):
    """The JAX engine on its Python tree, the port's on its C++ tree; radix
    cache on, LPM, the reference's defaults but for the sizes in kw."""
    cfg, tree, model = tiny
    common = dict(max_batch=4, max_seq_len=128, prefill_buckets=BUCKETS,
                  kv_chunk=64, decode_steps=4, num_slots=1024)
    common.update(kw)
    with monkeypatch.context() as m:
        m.setenv("AURORA_NATIVE_RADIX", "0")
        jeng = jengine.ServeEngine(
            tree, cfg.llm,
            jengine.EngineConfig(kv_dtype=jnp.float32, **common),
            embed_fn=embed_fns[0])
    assert isinstance(jeng.radix, JRadixCache)
    monkeypatch.delenv("AURORA_NATIVE_RADIX", raising=False)
    teng = tengine.ServeEngine(
        model, model.cfg,
        tengine.EngineConfig(kv_dtype=torch.float32, **common),
        embed_fn=embed_fns[1])
    assert teng.radix_impl == "native", teng.radix_error
    return jeng, teng


def _text_prompts(seed, stem_len=37):
    """Wave 1: A (an odd-length stem + 6) and unrelated X and Y. Wave 2: B
    (the stem + 9: a hit of the stem), A again (a full hit) and D (the
    stem's first 2/5 + 7: a hit that splits A's node)."""
    rng = np.random.default_rng(seed)

    def toks(n):
        return [int(x) for x in rng.integers(3, 512, size=n)]
    stem = toks(stem_len)
    A = stem + toks(6)
    return ([("A", A), ("X", toks(30)), ("Y", toks(12))],
            [("B", stem + toks(9)), ("A2", list(A)),
             ("D", stem[:stem_len * 2 // 5] + toks(7))])


def _requests(cls, wave, logprobs=False, max_new=None):
    return [cls(rid=r, input_ids=list(p), eos_ids=(), logprobs=logprobs,
                max_new_tokens=(max_new or {}).get(r, MAX_NEW))
            for r, p in wave]


def _drive(jeng, teng, waves, logprobs=False):
    """Both engines through the same waves (each drained before the next);
    → ({rid: JAX request}, {rid: port request})."""
    want, got = {}, {}
    for wave in waves:
        want.update(drain_engine(jeng, _requests(JRequest, wave, logprobs)))
        got.update(drain_engine(teng, _requests(Request, wave, logprobs)))
        assert jeng.check_memory() == teng.check_memory()
    return want, got


def _assert_cache_parity(jeng, teng, want, got):
    assert {r: q.n_cached for r, q in got.items()} == \
        {r: q.n_cached for r, q in want.items()}
    mem = teng.check_memory()
    assert mem == jeng.check_memory() and mem["leaked"] == 0, mem
    stats = teng.decode_stats()
    assert stats["slot_usage"] == jeng.decode_stats()["slot_usage"] > 0
    assert teng.flush_cache() == jeng.flush_cache() == 0
    assert teng.check_memory() == jeng.check_memory()


def _assert_same_tokens(want, got):
    for rid, w in want.items():
        assert got[rid].output_ids == w.output_ids, rid


def test_engine_prefix_hits_match_jax_fp32(tiny, monkeypatch):
    jeng, teng = _engines(tiny, monkeypatch)
    want, got = _drive(jeng, teng, _text_prompts(0))
    n_cached = {r: q.n_cached for r, q in got.items()}
    assert n_cached == {"A": 0, "X": 0, "Y": 0, "B": 37, "A2": 42, "D": 14}
    _assert_same_tokens(want, got)
    assert got["A2"].output_ids == got["A"].output_ids
    _assert_cache_parity(jeng, teng, want, got)


# weights and KV → (engine options, stem). Packed int4 KV: a stem of 131
# tokens, odd and in the high half of a PACK_SEG segment, so that B's
# extend writes the high nibble of a byte whose low nibble the prefix load
# put there (a bucket of 256 then)
QUANT = {"kv4": (dict(kv_quant="int4", prefill_buckets=(256,),
                      max_seq_len=256), 131),
         "w4kv8": (dict(weight_quant="int4", kv_quant="int8"), 37)}


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_engine_prefix_hits_match_jax_quantized(tiny, monkeypatch, quant):
    kw, stem = QUANT[quant]
    jeng, teng = _engines(tiny, monkeypatch, **kw)
    want, got = _drive(jeng, teng, _text_prompts(1, stem), logprobs=True)
    assert got["B"].n_cached == stem and got["A2"].n_cached == stem + 5
    assert_near_tie_parity(got, want)
    _assert_cache_parity(jeng, teng, want, got)


def test_engine_abort_of_a_running_request_with_a_prefix(tiny, monkeypatch):
    """B, which holds the stem's prefix, is aborted after its first step:
    both engines cache its prompt, unlock, and serve on; B again is then a
    full hit that repeats B's tokens."""
    jeng, teng = _engines(tiny, monkeypatch)
    wave1, wave2 = _text_prompts(2)
    want, got = _drive(jeng, teng, [wave1])
    for eng, cls, out in ((jeng, JRequest, want), (teng, Request, got)):
        for r in _requests(cls, wave2, max_new={"B": 40}):
            eng.add_request(r)
        out.update({r.rid: r for r in eng.step()})
        assert eng.abort("B")
        out.update(drain_engine(eng, []))
        assert out["B"].finished.value == "abort" and out["B"].n_cached == 37
        assert len(out["B"].output_ids) == MAX_NEW
        assert eng.check_memory()["leaked"] == 0
    again = [("B2", wave2[0][1]), ("A3", wave1[0][1]), ("D2", wave2[2][1])]
    more_w, more_g = _drive(jeng, teng, [again])
    want.update(more_w)
    got.update(more_g)
    assert got["B2"].n_cached == len(wave2[0][1]) - 1
    assert got["B2"].output_ids == got["B"].output_ids
    _assert_same_tokens(want, got)
    _assert_cache_parity(jeng, teng, want, got)


def test_engine_eviction_under_a_small_pool(tiny, monkeypatch):
    """48 slots: each new prompt evicts the least recently used unlocked
    prefixes it needs room for; a prompt sharing a surviving prefix hits."""
    jeng, teng = _engines(tiny, monkeypatch, num_slots=48)
    rng = np.random.default_rng(3)
    ps = [[int(t) for t in rng.integers(3, 512, size=28)] for _ in range(3)]
    waves = [[("e0", ps[0])], [("e1", ps[1])],
             [("e2", ps[0][:20] + ps[2][:6])],
             [("e3", ps[0][:15] + ps[2][:3])], [("e4", ps[2])]]
    want, got = _drive(jeng, teng, waves)
    _assert_same_tokens(want, got)
    n_cached = {r: q.n_cached for r, q in got.items()}
    assert n_cached == {"e0": 0, "e1": 0, "e2": 0, "e3": 15, "e4": 0}
    _assert_cache_parity(jeng, teng, want, got)


class ByteTokenizer:
    """BOS 1, then one id per UTF-8 byte past the special ids."""

    def encode(self, text, add_special_tokens=True):
        ids = [b + 3 for b in text.encode("utf-8")]
        return ([1] + ids) if add_special_tokens else ids


def _fused_embeds(table):
    """An embed_fn for both engines: the prompt's fused embeddings as a
    function of its ids (text ids from `table`, each visual placeholder id
    a vector seeded by the id), so that both see the same inputs without
    a ViT (tests/test_torch_engine.py holds the two front ends' ViT,
    projector and fusion to each other)."""
    V, D = table.shape

    def embed_fn(req):
        ids = np.asarray(req.input_ids)
        out = table[np.clip(ids, 0, V - 1)].astype(np.float32)
        for i in np.flatnonzero(ids >= V):
            rng = np.random.default_rng(int(ids[i]))
            out[i] = 0.02 * rng.standard_normal(D)
        return out
    return embed_fn


def test_engine_multimodal_prompts_share_a_clip(tiny, monkeypatch):
    """Two prompts a clip, built by both AuroraCapServing front ends: the
    second hits the clip's visual prefix; a clip's first prompt again is a
    full hit; the extend slices the fused embeds at n_cached."""
    cfg, tree, _ = tiny
    tok = ByteTokenizer()
    # the front ends build the requests (their ViTs are not run here)
    jmm = JServing({}, cfg, tok, kept_ratio=0.5, image_size=56)
    tmm = AuroraCapServing(
        types.SimpleNamespace(cfg=bridge.aurora_config_from(cfg)), tok,
        kept_ratio=0.5, image_size=56)
    embed_fn = _fused_embeds(np.asarray(tree["embed_tokens"]))
    jeng, teng = _engines(tiny, monkeypatch, (embed_fn, embed_fn))
    rng = np.random.default_rng(4)
    clips = [random_frames(rng, f=2, size=56) for _ in range(3)]
    first, second = ("USER: <image> <image>\nWhat? ASSISTANT:",
                     "USER: <image> <image>\nWhy? ASSISTANT:")
    waves = [[("c0a", 0, first), ("c1a", 1, first), ("c2a", 2, first)],
             [("c0b", 0, second), ("c0a2", 0, first), ("c1b", 1, second)]]
    want, got = {}, {}
    for wave in waves:
        jreqs = [jmm.build_request(r, text, clips[i], eos_ids=(),
                                   max_new_tokens=MAX_NEW)
                 for r, i, text in wave]
        treqs = [tmm.build_request(r, text, clips[i], eos_ids=(),
                                   max_new_tokens=MAX_NEW)
                 for r, i, text in wave]
        for j, t in zip(jreqs, treqs):
            assert t.input_ids == j.input_ids
        want.update(drain_engine(jeng, jreqs))
        got.update(drain_engine(teng, treqs))
    n_vis = 2 * tmm.n_visual_tokens()
    assert all(got[f"c{i}b"].n_cached > n_vis for i in range(2))
    assert got["c0a2"].n_cached == len(got["c0a"].input_ids) - 1
    _assert_same_tokens(want, got)
    assert got["c0a2"].output_ids == got["c0a"].output_ids
    _assert_cache_parity(jeng, teng, want, got)


def test_engine_radix_off_is_the_passthrough(tiny):
    """disable_radix_cache=True: no pool, nothing matched or cached, the
    repeated prompt extends from position 0 again."""
    _, _, model = tiny
    eng = tengine.ServeEngine(model, model.cfg, tengine.EngineConfig(
        max_batch=2, max_seq_len=128, prefill_buckets=(32, 64),
        kv_dtype=torch.float32, kv_chunk=64, disable_radix_cache=True))
    assert eng.radix_impl == "null" and eng.pool is None
    ids = list(range(3, 30))
    first = drain_engine(eng, [Request(rid="a", input_ids=ids,
                                       max_new_tokens=4, eos_ids=())])
    again = drain_engine(eng, [Request(rid="b", input_ids=ids,
                                       max_new_tokens=4, eos_ids=())])
    assert again["b"].n_cached == 0
    assert again["b"].output_ids == first["a"].output_ids
    assert eng.check_memory() == {"free": eng.ecfg.num_slots, "cached": 0,
                                  "in_flight": 0, "leaked": 0}


def test_python_tree_when_native_is_off(tiny, monkeypatch):
    _, _, model = tiny
    monkeypatch.setenv("AURORA_NATIVE_RADIX", "0")
    eng = tengine.ServeEngine(model, model.cfg, tengine.EngineConfig(
        max_batch=2, max_seq_len=128, prefill_buckets=(32, 64),
        kv_dtype=torch.float32, kv_chunk=64, num_slots=256))
    assert eng.radix_impl == "python" and isinstance(eng.radix, RadixCache)
    ids = list(range(3, 30))
    drain_engine(eng, [Request(rid="a", input_ids=ids, max_new_tokens=3,
                               eos_ids=())])
    again = drain_engine(eng, [Request(rid="b", input_ids=ids + [40],
                                       max_new_tokens=3, eos_ids=())])
    assert again["b"].n_cached == len(ids)
    assert eng.check_memory()["leaked"] == 0
