"""The rest of the engine surface: `EngineConfig(w4_prefill="a8")` (the
reference's AURORA_W4_PREFILL=a8, `_w4dot`'s int8 prefill branch) and
`EngineConfig(kv_grid_bits=4)` (its AURORA_KV_BITS=4, int8 KV rows on the
int4 grid), against the JAX package on the CPU, float32.

- The A8 branch's requantized weights equal the reference's bit for bit
  (its chain jitted here as it is written in engine.py:311-338), in the
  stripe and the flat layout, on a W4 tree quantized by the reference and
  bridged; `_w4dot`'s A8 output agrees with the JAX `_w4dot` under
  AURORA_W4_PREFILL=a8 within fp32 rounding (rtol 1e-5), and stays within
  the reference's own gate of its bf16 branch (1e-6 < rel L2 < 0.03,
  tests/test_w4_prefill_a8.py).
- Both engines, each quantizing the same fp32 weights, serve the same
  requests (a 32-token extend, then a 4 × 64-token wave that takes the
  prefill branch) under the near-tie contract of
  test_torch_engine_quant.py, with the JAX engine under the environment
  knob (monkeypatched, jax.clear_caches() around it); the grid-4 rows
  hold only values in [-7, 7].
- The port's engine against itself at the reference's quality gates
  (tests/test_quant_quality.py's matched-prefix protocol): A8 prefill vs
  bf16 prefill on one W4 tree, match >= 0.30 and |dlogprob| < 0.05
  (tests/test_w4_prefill_a8.py:84); the int4-grid KV vs the fp32 cache,
  match >= 0.20 and |dlogprob| < 0.10 (tests/test_kv_int4_quality.py:61).
- `__post_init__` refuses the knobs outside their modes; profile_serve's
  --w4kv8-a8 runs on the tiny config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.serve import engine as jeng
from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.engine import ServeEngine as JServeEngine
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models.llama import W4Linear
from aurora_tpu_torch.ops.pallas import quant_matmul as tqm
from aurora_tpu_torch.serve import engine as teng
from aurora_tpu_torch.serve.scheduler import Request

from test_quant_quality import _divergence
from test_torch_engine_quant import (BUCKETS, CONFIGS, W4KV8,
                                     assert_near_tie_parity)
from utils import drain_engine

MM_TOL = dict(rtol=1e-5, atol=1e-6)
PROJ = ("q", "k", "v", "o", "gate", "up", "down")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread: the suite runs several workers at
    once, and their intra-op pools would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@jax.jit
def _jax_a8_weights(pk, s):
    """The reference's A8 requantization (serve/engine.py:304-323), one
    flat layer [G, g/2, N] / [G, 1, N] → (int8 [K, N], cs [1, 1, N])."""
    G, gh, O = pk.shape
    four = jnp.int8(4)
    lo = jax.lax.shift_right_arithmetic(jax.lax.shift_left(pk, four), four)
    hi = jax.lax.shift_right_arithmetic(pk, four)
    q = jnp.stack([lo, hi], axis=2).reshape(G, 2 * gh, O)
    cs = jnp.max(s, axis=0, keepdims=True) * (8.0 / 127.0)
    m = (s / cs).astype(jnp.float32)
    w8 = jnp.clip(jnp.round(q.astype(jnp.float32) * m), -127,
                  127).astype(jnp.int8).reshape(G * 2 * gh, O)
    return w8, cs


@pytest.fixture(scope="module")
def w4_tree():
    cfg = CONFIGS["tiny"]
    tree = init_llama_params(jax.random.PRNGKey(5), cfg, dtype=jnp.float32)
    q = jax.device_get(jeng.quantize_weights_int4(tree))
    model = bridge.llama_from_params(q, bridge.llama_config_from(cfg),
                                     dtype=torch.float32, device="cpu")
    return q, model


@pytest.mark.parametrize("layout", ["stripes", "flat"])
def test_a8_requantized_weights_equal_the_reference(w4_tree, layout):
    q, model = w4_tree
    ecfg = teng.EngineConfig(weight_quant="int4",
                             w4_tiled=layout == "stripes")
    served = teng.w4_decode_layout(model, model.cfg, ecfg)
    for l, lp in enumerate(served.layers):
        for name in PROJ:
            w = getattr(lp, name)
            assert isinstance(w, W4Linear) and w.flat == (layout == "flat")
            want_w8, want_cs = _jax_a8_weights(
                jnp.asarray(q["layers"][name][l]),
                jnp.asarray(q["layers"][name + "_scale4"][l]))
            got_w8, got_cs = teng._w4_requantized(w)
            assert np.array_equal(got_w8.numpy().T, np.asarray(want_w8)), \
                (l, name)
            assert np.array_equal(got_cs.numpy(),
                                  np.asarray(want_cs).reshape(-1)), (l, name)


@pytest.mark.parametrize("layout", ["stripes", "flat"])
def test_w4dot_a8_matches_jax(monkeypatch, layout):
    rng = np.random.default_rng(7)
    K, N = 256, 384
    w = jnp.asarray(rng.standard_normal((1, K, N)) * 0.05, jnp.float32)
    pk, s = (np.array(x[0]) for x in jeng._w4(w, group=128))
    h = rng.standard_normal((96, K)).astype(np.float32)
    h[0, :7] *= 40.0                      # one outlier-heavy token
    lin = W4Linear(*tqm.w4_from_flat(pk, s))
    if layout == "flat":
        lin = W4Linear(torch.from_numpy(pk), torch.from_numpy(s))
    th = torch.from_numpy(h).reshape(6, 16, K)
    bf16 = teng._w4dot(th, lin).numpy().reshape(96, N)
    got = teng._w4dot(th, lin, a8_prefill=True).numpy().reshape(96, N)
    monkeypatch.setenv("AURORA_W4_PREFILL", "a8")
    jax.clear_caches()
    try:
        want = np.asarray(jeng._w4dot(jnp.asarray(h), pk, s))
    finally:
        monkeypatch.delenv("AURORA_W4_PREFILL")
        jax.clear_caches()
    np.testing.assert_allclose(got, want, **MM_TOL)
    rel = np.linalg.norm(got - bf16) / np.linalg.norm(bf16)
    assert 1e-6 < rel < 0.03, rel


def _port_engine(model, **kw):
    return teng.ServeEngine(model, model.cfg, teng.EngineConfig(
        kv_dtype=torch.float32, **kw))


@pytest.mark.parametrize("knob", ["a8", "kv4grid"])
def test_engine_matches_jax_engine_under_the_knob(monkeypatch, knob):
    """W4 + int8 KV, the knob on both sides: request 0 alone (a 32-token
    extend, the W4A8 kernels' twins), then three more in one 4 × 64-token
    wave (the prefill branch); decode_steps 4."""
    env, layout = {"a8": ("AURORA_W4_PREFILL", dict(w4_prefill="a8")),
                   "kv4grid": ("AURORA_KV_BITS", dict(kv_grid_bits=4))}[knob]
    cfg = CONFIGS["tiled256"]
    tree = jax.device_get(init_llama_params(jax.random.PRNGKey(3), cfg,
                                            dtype=jnp.float32))
    model = bridge.llama_from_params(tree, bridge.llama_config_from(cfg),
                                     dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(3, 128, size=n)]
               for n in (9, 40, 17, 33)]
    common = dict(max_seq_len=96, prefill_buckets=BUCKETS, kv_chunk=32,
                  disable_radix_cache=True, max_batch=4, decode_steps=4,
                  **W4KV8)
    monkeypatch.setenv(env, {"a8": "a8", "kv4grid": "4"}[knob])
    jax.clear_caches()
    try:
        jeng_ = JServeEngine(tree, cfg, JEngineConfig(kv_dtype=jnp.float32,
                                                      **common))
        port = _port_engine(model, **common, **layout)

        def reqs(cls):
            return [cls(rid=str(i), input_ids=list(p), max_new_tokens=5,
                        eos_ids=(), logprobs=True)
                    for i, p in enumerate(prompts)]

        jreqs, treqs = reqs(JRequest), reqs(Request)
        want = drain_engine(jeng_, jreqs[:1])
        got = drain_engine(port, treqs[:1])
        want.update(drain_engine(jeng_, jreqs[1:]))
        got.update(drain_engine(port, treqs[1:]))
    finally:
        monkeypatch.delenv(env)
        jax.clear_caches()
    assert_near_tie_parity(got, want)
    rows = port.runner.rows
    if knob == "kv4grid":
        for name in ("k", "v"):
            assert int(rows[name].abs().max()) == 7, name


def _greedy(model, seqs, **kw):
    """tests/test_quant_quality.py's `_engine_greedy` on the port."""
    eng = _port_engine(model, max_batch=4, max_seq_len=96, num_slots=512,
                       prefill_buckets=(32, 64), **kw)
    reqs = [Request(rid=f"r{i}", input_ids=[int(x) for x in s],
                    max_new_tokens=24, eos_ids=(-1,), logprobs=True)
            for i, s in enumerate(seqs)]
    done = drain_engine(eng, reqs)
    assert eng.check_memory()["leaked"] == 0
    return [done[f"r{i}"] for i in range(len(seqs))]


@pytest.mark.parametrize("knob", ["a8", "kv4grid"])
def test_engine_within_the_reference_quality_gate(knob):
    cfg = JLlamaConfig.tiny(vocab_size=256)
    tree = jax.device_get(init_llama_params(jax.random.PRNGKey(11), cfg,
                                            dtype=jnp.float32))
    model = bridge.llama_from_params(tree, bridge.llama_config_from(cfg),
                                     dtype=torch.float32, device="cpu")
    seqs = np.random.default_rng(13).integers(3, 256, size=(8, 48))
    if knob == "a8":
        ref = _greedy(model, seqs, weight_quant="int4")
        out = _greedy(model, seqs, weight_quant="int4", w4_prefill="a8")
        gate = (0.30, 0.05)
    else:
        ref = _greedy(model, seqs)
        out = _greedy(model, seqs, kv_quant="int8", kv_grid_bits=4)
        gate = (0.20, 0.10)
    m, d = _divergence(ref, out)
    assert m >= gate[0] and d < gate[1], (m, d)
    assert d > 0, "the knob changed nothing"


@pytest.mark.parametrize("kw", [
    dict(w4_prefill="a8"), dict(weight_quant="int8", w4_prefill="a8"),
    dict(weight_quant="int4", w4_prefill="int8"), dict(kv_grid_bits=4),
    dict(kv_quant="int4", kv_grid_bits=4), dict(kv_quant="int8",
                                                kv_grid_bits=2)])
def test_config_refuses_the_knobs_outside_their_modes(kw):
    with pytest.raises(ValueError):
        teng.EngineConfig(**kw)


def test_config_kv_grid():
    assert teng.EngineConfig().kv_maxq == 127.0
    assert teng.EngineConfig(kv_quant="int8").kv_maxq == 127.0
    assert teng.EngineConfig(kv_quant="int8", kv_grid_bits=4).kv_maxq == 7.0
    assert teng.EngineConfig(kv_quant="int4").kv_maxq == 7.0


def test_profile_serve_a8_runs_on_cpu(tmp_path, capsys):
    """profile_serve's --w4kv8-a8 on the tiny config at 3 rows (a 96-token
    wave: the A8 branch) and its extend split by family (no device events
    on the CPU, so every family reads 0)."""
    import json

    from aurora_tpu_torch.tools import profile_serve
    calls = tqm.w4a8_matmul_tiled_plain.calls
    assert profile_serve.main(["--tiny", "--device", "cpu", "--reps", "1",
                               "--steps", "4", "--batch", "3",
                               "--w4kv8-a8", "--out", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["mode"] == "w4kv8-a8" and res["weights"] == "int4"
    assert set(res["extend_ms_per_wave_by_family"]) == {
        "attention", "w4a8", "fused_mlp", "quantizer", "other"}
    assert res["extend_ms_per_wave_dense_matmul"] == 0.0
    assert tqm.w4a8_matmul_tiled_plain.calls > calls     # the decode ran
