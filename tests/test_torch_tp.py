"""Tensor-parallel serving (aurora_tpu_torch/serve/tp.py) against the JAX
engine at the same tp, on the CPU in float32.

The JAX engine shards over conftest's 8 virtual CPU devices (its mesh
needs distinct devices); the port holds its shards on the CPU repeated
(`devices=[cpu] * tp`), with one code path for every device layout. Both
engines serve the same requests from the same weights (the JAX init
bridged into the port); every case checks the tokens and each step's
top-1 logprob:

- fp32 weights and KV: tokens equal, top-1 logprobs within LOGPROB_TOL;
- int8 KV and W8 weights: the near-tie contract of
  tests/test_torch_engine_quant.py (`assert_near_tie_parity`).

Cases: tp 2 with fp32 and int8 KV, radix prefix reuse (a second prompt
that extends the first), an oversize prompt prefilled in chunks and
decode_steps 3 (tests/test_serve.py:809, :883); the biased LayerNorm
family (:839); MoE with a gated shared expert (:1098); Gemma-2
(tests/test_serve_families.py:50); W8 + int8 KV; tp 4 on four KV heads.
Refusals, as the reference's: tp 4 on 2 KV heads, a fused tree (:1168),
W4 weights, packed int4 KV, MLA. `update_weights` at tp 2 cuts the new
weights into the live shards (their addresses kept) and serves what a tp
1 engine serves from them. The JAX engine runs are cached per
configuration for the module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models import gemma2 as jg2
from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.engine import ServeEngine as JServeEngine
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models import gemma2 as tg2
from aurora_tpu_torch.serve import tp as ttp
from aurora_tpu_torch.serve.engine import (EngineConfig, ServeEngine,
                                           fuse_serving_weights)
from aurora_tpu_torch.serve.scheduler import Request

from test_torch_engine_quant import assert_near_tie_parity
from utils import drain_engine

# fp32 on both sides: the shards' partial sums and the reference's psum
# add in orders that differ by float32 rounding (~1e-6 in a logprob)
LOGPROB_TOL = 1e-4
V = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread: the suite runs several workers at
    once, and their intra-op pools would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _llama(cfg, seed, tweak=None):
    tree = init_llama_params(jax.random.PRNGKey(seed), cfg,
                             dtype=jnp.float32)
    tree = {**tree, "layers": dict(tree["layers"])}
    if tweak is not None:
        tweak(tree)
    tree = jax.device_get(tree)
    model = bridge.llama_from_params(tree, bridge.llama_config_from(cfg),
                                     dtype=torch.float32, device="cpu")
    return tree, model


def _biased(cfg, tree):
    """A StarCoder2-shaped tree (tests/test_serve.py:839): no gate, norm,
    o / up / down biases."""
    L, D, F = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    lay = tree["layers"]
    del lay["gate"]
    keys = jax.random.split(jax.random.PRNGKey(8), 6)
    for i, (name, shape, s) in enumerate(
            (("input_norm_bias", (L, D), 0.01),
             ("post_attn_norm_bias", (L, D), 0.01),
             ("o_bias", (L, D), 0.05), ("up_bias", (L, F), 0.05),
             ("down_bias", (L, D), 0.05))):
        lay[name] = s * jax.random.normal(keys[i], shape, jnp.float32)
    tree["final_norm_bias"] = 0.01 * jax.random.normal(
        keys[5], (D,), jnp.float32)


def _shared_expert(cfg, tree):
    """Qwen2-MoE's gated shared expert (tests/test_serve.py:1098)."""
    L, D, Fs = cfg.num_hidden_layers, cfg.hidden_size, 24
    keys = jax.random.split(jax.random.PRNGKey(12), 4)
    sd = 0.2 / np.sqrt(D)
    lay = tree["layers"]
    for i, (name, shape) in enumerate((("moe_shared_gate", (L, D, Fs)),
                                       ("moe_shared_up", (L, D, Fs)),
                                       ("moe_shared_down", (L, Fs, D)),
                                       ("moe_shared_gate_w", (L, D, 1)))):
        lay[name] = sd * jax.random.normal(keys[i], shape, jnp.float32)


def _llama_case(cfg, seed, tweak=None):
    """→ a function that makes (JAX tree, JAX config, the port's model)."""
    def build():
        tree, model = _llama(cfg, seed,
                             tweak and (lambda t: tweak(cfg, t)))
        return tree, cfg, model
    return build


def _gemma2_case():
    """Gemma-2's serving mapping on both sides (tests/test_serve_families
    .py:50): alternating windows of 8, logit caps, (1 + w) norms."""
    cfg = jg2.Gemma2Config.tiny(vocab_size=V)
    tree = jax.device_get(jg2.init_gemma2_params(jax.random.PRNGKey(3), cfg,
                                                 dtype=jnp.float32))
    model = bridge.gemma2_from_params(
        tree, tg2.Gemma2Config(**dataclasses.asdict(cfg)), device="cpu",
        dtype=torch.float32)
    return (jg2.gemma2_serving_params(tree), jg2.gemma2_serving_config(cfg),
            tg2.gemma2_serving_params(model))


TINY = JLlamaConfig.tiny(vocab_size=V)
# name → (maker of the models, EngineConfig fields, prompt lengths)
CASES = {
    "fp32": (_llama_case(TINY, 7), dict(), (11, 15, 40)),
    "kv8": (_llama_case(TINY, 7), dict(kv_quant="int8"), (11, 15, 40)),
    "biased": (_llama_case(dataclasses.replace(
        TINY, norm_type="layernorm", mlp_style="mlp",
        hidden_act="gelu_tanh", qkv_bias=True), 7, _biased), dict(), (11,)),
    "moe": (_llama_case(dataclasses.replace(
        TINY, num_experts=4, num_experts_per_tok=2), 11, _shared_expert),
            dict(), (13, 9)),
    "gemma2": (_gemma2_case, dict(), (24, 30)),
    "w8kv8": (_llama_case(TINY, 7), dict(weight_quant="int8",
                                         kv_quant="int8"), (11, 40)),
    "tp4": (_llama_case(dataclasses.replace(TINY, num_key_value_heads=4), 5),
            dict(tp=4), (11, 40)),
}
_JAX_RUNS = {}


def _common(fields):
    return dict(max_batch=2, max_seq_len=64, num_slots=256,
                prefill_buckets=(16, 32), kv_chunk=16, decode_steps=3,
                **{"tp": 2, **fields})


def _requests(cls, lens, seed=9):
    """The first prompt; the second extends it (a radix hit when served
    after it); a third past the largest bucket (chunked prefill)."""
    rng = np.random.default_rng(seed)
    base = [int(x) for x in rng.integers(3, V, size=lens[0])]
    prompts = [base]
    if len(lens) > 1:
        prompts.append(base + [int(x) for x in
                               rng.integers(3, V, size=lens[1] - lens[0])]
                       if lens[1] > lens[0] else
                       [int(x) for x in rng.integers(3, V, size=lens[1])])
    for n in lens[2:]:
        prompts.append([int(x) for x in rng.integers(3, V, size=n)])
    return [[cls(rid=str(i), input_ids=list(p), max_new_tokens=6,
                 eos_ids=(), logprobs=True)] for i, p in enumerate(prompts)]


def _drain_in_turn(engine, waves):
    out = {}
    for wave in waves:
        out.update(drain_engine(engine, wave))
    return out


def _jax_run(name):
    """The JAX engine's answers to case `name` at its tp, once a module."""
    if name not in _JAX_RUNS:
        build, fields, lens = CASES[name]
        tree, cfg, model = build()
        jeng = JServeEngine(tree, cfg, JEngineConfig(
            kv_dtype=jnp.float32, **_common(fields)))
        _JAX_RUNS[name] = (model, _drain_in_turn(
            jeng, _requests(JRequest, lens)))
    return _JAX_RUNS[name]


def _port(model, fields, **kw):
    return ServeEngine(model, model.cfg, EngineConfig(
        kv_dtype=torch.float32, **_common(fields)), **kw)


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for rid, w in want.items():
        g = got[rid]
        assert g.output_ids == w.output_ids, rid
        for gt, wt in zip(g.output_top_logprobs, w.output_top_logprobs):
            assert abs(gt[0][1] - wt[0][1]) <= LOGPROB_TOL, rid


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_engine_matches_jax_engine(name):
    model, want = _jax_run(name)
    fields, lens = CASES[name][1:]
    teng = _port(model, fields)
    tp = teng.ecfg.tp
    assert isinstance(teng.runner, ttp.TPRunner)
    assert len(teng.runner.group.models) == tp
    got = _drain_in_turn(teng, _requests(Request, lens))
    if "weight_quant" in fields or "kv_quant" in fields:
        assert_near_tie_parity(got, want)
    else:
        _assert_same(got, want)
    # every shard holds its heads' rows and pool, and its MLP width
    hkv = model.cfg.num_key_value_heads // tp
    for rows, pool, shard in zip(teng.runner.group.rows, teng.pool,
                                 teng.runner.group.models):
        assert rows["k"].shape[2] == hkv and pool.planes["k"].shape[2] == hkv
        assert shard.cfg.num_key_value_heads == hkv
    if len(lens) > 1 and lens[1] > lens[0]:
        assert len(got["1"].prefix_slots) >= lens[0]     # the radix hit
    assert teng.check_memory()["leaked"] == 0


def test_tp_cut_follows_the_reference_specs():
    """Each shard's tensors are the reference's `tp_param_specs` slices:
    column-cut q/k/v/up (and their biases) on their heads / width, o and
    down on their inputs, their biases replicated; the per-head norms of
    Cohere follow the heads; the experts on the MLP width."""
    model = CASES["biased"][0]()[2]
    shards = ttp.cut_model(model, 2, ["cpu", "cpu"])
    full = model.state_dict()
    for r, shard in enumerate(shards):
        sd = shard.state_dict()
        assert sd.keys() == full.keys()
        for name, t in sd.items():
            dim = ttp.split_dim(name, t)
            want = full[name] if dim is None else full[name].chunk(
                2, dim)[r]
            assert torch.equal(t, want), name
    assert ttp.split_dim("layers.0.q_norm", torch.zeros(4, 16)) == 0
    assert ttp.split_dim("layers.0.q_norm", torch.zeros(16)) is None
    assert ttp.split_dim("layers.0.moe_gate.weight",
                         torch.zeros(4, 64, 32)) == 2
    assert ttp.split_dim("layers.0.moe_down.scale",
                         torch.zeros(4, 64)) is None
    assert ttp.split_dim("layers.0.moe_router", torch.zeros(64, 4)) is None


def test_tp_refusals_match_the_reference():
    """tp 4 on 2 KV heads, a fused tree, W4, packed int4 KV and MLA raise
    on both sides (the JAX engine before it compiles anything)."""
    from aurora_tpu.serve.engine import fuse_serving_weights as jfuse
    from aurora_tpu_torch.models.llama import LlamaModel
    tree, cfg, model = CASES["fp32"][0]()
    jcommon = dict(max_batch=2, max_seq_len=64, num_slots=64,
                   prefill_buckets=(16,), kv_dtype=jnp.float32)
    with pytest.raises(ValueError, match="must divide"):
        JServeEngine(tree, cfg, JEngineConfig(tp=4, **jcommon))
    with pytest.raises(ValueError, match="must divide"):
        _port(model, dict(tp=4))
    with pytest.raises(ValueError, match="fused"):
        JServeEngine(jfuse({**tree, "layers": dict(tree["layers"])}), cfg,
                     JEngineConfig(tp=2, **jcommon))
    fused = bridge.llama_from_params(tree, model.cfg, dtype=torch.float32,
                                     device="cpu")
    with pytest.raises(ValueError, match="fused"):
        _port(fuse_serving_weights(fused), {})
    for kw in (dict(weight_quant="int4"), dict(kv_quant="int4")):
        with pytest.raises(AssertionError, match="single-device"):
            JServeEngine(tree, cfg, JEngineConfig(tp=2, **kw, **jcommon))
        with pytest.raises(ValueError, match="single-device"):
            _port(model, kw)
    mla_cfg = dataclasses.replace(model.cfg, mla_kv_lora_rank=32)
    with pytest.raises(NotImplementedError, match="one device"):
        ServeEngine(LlamaModel(model.cfg, device="meta"), mla_cfg,
                    EngineConfig(tp=2))


def test_tp_update_weights_cuts_into_the_live_shards():
    model = CASES["fp32"][0]()[2]
    other = _llama_case(TINY, 123)()[2]
    teng = _port(model, {})
    before = {(r, k): t.data_ptr() for r, m in
              enumerate(teng.runner.group.models)
              for k, t in m.state_dict().items()}
    waves = _requests(Request, (11,))
    first = drain_engine(teng, waves[0])["0"].output_ids
    ok, msg = teng.update_weights(other)
    assert ok, msg
    assert {(r, k): t.data_ptr() for r, m in
            enumerate(teng.runner.group.models)
            for k, t in m.state_dict().items()} == before
    again = _requests(Request, (11,))[0]
    got = drain_engine(teng, again)["0"].output_ids
    want = drain_engine(_port(other, dict(tp=1)),
                        _requests(Request, (11,))[0])["0"].output_ids
    assert got == want != first
    bad = dataclasses.replace(model.cfg, intermediate_size=96)
    from aurora_tpu_torch.models.llama import LlamaModel
    ok, msg = teng.update_weights(LlamaModel(bad, device="cpu"))
    assert not ok and "live weights hold" in msg
    assert drain_engine(teng, _requests(Request, (11,))[0])[
        "0"].output_ids == want
    assert teng.check_memory()["leaked"] == 0


def test_tp_engine_drops_its_source_and_sizes_for_one_shard():
    """An engine at tp 2 holds only its shards: the model it was cut from
    (the host copy, in cli/serve.py) is no longer referenced once
    `build_engine` returns, and the engine serves what a tp 1 engine
    serves. `shard_bytes` is what each shard holds, and
    `auto_engine_config` sets it aside from the free memory."""
    import gc
    import weakref

    from aurora_tpu_torch.serve import api
    from aurora_tpu_torch.serve.engine import auto_engine_config
    model = _llama_case(TINY, 7)()[2]
    cfg, one = model.cfg, ttp.shard_bytes(model, 2)
    want = drain_engine(_port(model, dict(tp=1)), _requests(
        Request, (11,))[0])["0"].output_ids
    source = weakref.ref(model)
    engine = api.build_engine(model, cfg, EngineConfig(
        kv_dtype=torch.float32, **_common({})), devices=["cpu", "cpu"])
    del model
    gc.collect()
    assert source() is None
    assert [sum(t.numel() * t.element_size() for t in m.state_dict().values())
            for m in engine.runner.group.models] == [one, one]
    assert drain_engine(engine, _requests(Request, (11,))[0])[
        "0"].output_ids == want
    base = EngineConfig(max_batch=0, num_slots=0, tp=2)
    assert auto_engine_config(cfg, base, device="cpu", pending_bytes=one) \
        == auto_engine_config(cfg, base,
                              budget_bytes=int((4.7e9 - one) * 0.85))
