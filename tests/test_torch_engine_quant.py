"""The port's quantized ServeEngine vs the JAX ServeEngine.

Both engines serve the same requests from the same fp32 weights, each
quantizing them itself, float32 activations on the CPU, prefix caching
off on both; the JAX kernels run in interpret mode. Three quantized
configurations: W4 weights + int8 KV, W8 weights + int8 KV and W4
weights + nibble-packed int4 KV. Two model configs: the 2-layer
hidden-256 config of tests/test_serve.py's tiled-layout test, where every
JAX W4 projection takes the tile-contiguous layout and the Pallas
w4a8_matmul_tiled kernel, and `tiny`, whose projections stay flat. The
prompts reach both branches of the quantized matmuls: a one-lane wave of
at most 64 tokens (the W4A8 / W8A8 kernels) and a wave of more than 64
(dequantized W4 weights / torch._int_mm); decode runs 4 lanes.

The contract (`assert_near_tie_parity`): every step's top-1 logprob
agrees within NEAR_TIE / 2, and the greedy tokens are equal up to the
first step at which they differ, which must be a near tie on the JAX
side (its top-2 logprob gap below NEAR_TIE); nothing after that step is
compared, and at least MIN_COMPARED steps of every request are. Chained
quantizers (int8/int4 KV → per-token int8 activations → the next layer's
KV) turn fp32 summation-order noise (~1e-6) into single rounding flips of
a quantized code, which move logprobs by up to a few 1e-3 and can flip a
token whose top-2 gap is smaller; a wrong scale, nibble or mask moves
them by far more than NEAR_TIE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.engine import ServeEngine as JServeEngine
from aurora_tpu.serve.engine import row_buffer_bytes as j_row_buffer_bytes
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models.llama import W4Linear, W8Linear
from aurora_tpu_torch.ops.pallas import quant_matmul as tqm
from aurora_tpu_torch.ops.pallas import ragged_attention as tra
from aurora_tpu_torch.serve.engine import (EngineConfig, ServeEngine,
                                           row_buffer_bytes)
from aurora_tpu_torch.serve.scheduler import Request

from utils import drain_engine

# set from this file's cases on the CPU (`PYTHONPATH=. python
# tests/test_torch_engine_quant.py` prints them): up to the first
# differing token the worst top-1 logprob difference was 5.3e-3 (W8 +
# int8 KV; 4.6e-3 with W4 + int8 KV); the two flips seen sat on top-2
# gaps of 4.1e-3 and 1.8e-3
NEAR_TIE = 2e-2
MIN_COMPARED = 3


def assert_near_tie_parity(got, want, min_compared=MIN_COMPARED):
    """got / want: {rid: Request} of the port and of the JAX engine, run
    greedy with logprobs=True. Returns {rid: (steps compared, worst top-1
    logprob difference, JAX's top-2 gap at the flip or None)}."""
    seen = {}
    for rid, w in want.items():
        g = got[rid]
        assert len(g.output_ids) == len(w.output_ids), rid
        n, worst, flip_gap = 0, 0.0, None
        for j, (gt, wt) in enumerate(zip(g.output_ids, w.output_ids)):
            g_top, w_top = g.output_top_logprobs[j], w.output_top_logprobs[j]
            n += 1
            worst = max(worst, abs(g_top[0][1] - w_top[0][1]))
            assert worst <= NEAR_TIE / 2, (rid, j, worst)
            if gt != wt:
                flip_gap = w_top[0][1] - w_top[1][1]
                assert flip_gap < NEAR_TIE, (rid, j, flip_gap)
                break
        assert n >= min(min_compared, len(w.output_ids)), (rid, n)
        seen[rid] = (n, worst, flip_gap)
    return seen


BUCKETS = (32, 64)
W4KV8 = dict(weight_quant="int4", kv_quant="int8")
W8KV8 = dict(weight_quant="int8", kv_quant="int8")
CONFIGS = {
    # dims divisible by 256: every JAX projection tiles
    "tiled256": JLlamaConfig(vocab_size=128, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=4,
                             max_position_embeddings=128),
    "tiny": JLlamaConfig.tiny(vocab_size=128),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def llm(request):
    cfg = CONFIGS[request.param]
    tree = jax.device_get(init_llama_params(jax.random.PRNGKey(3), cfg,
                                            dtype=jnp.float32))
    model = bridge.llama_from_params(tree, bridge.llama_config_from(cfg),
                                     dtype=torch.float32, device="cpu")
    return cfg, tree, model


def _common(quant=W4KV8, **kw):
    return dict(max_seq_len=96, prefill_buckets=BUCKETS, kv_chunk=32,
                disable_radix_cache=True, **quant, **kw)


def _port_engine(model, **kw):
    return ServeEngine(model, model.cfg,
                       EngineConfig(kv_dtype=torch.float32, **_common(**kw)))


def _engines(cfg, tree, model, **kw):
    return (JServeEngine(tree, cfg, JEngineConfig(kv_dtype=jnp.float32,
                                                  **_common(**kw))),
            _port_engine(model, **kw))


def _check_engine_parity(llm, decode_steps, quant):
    """Both engines through the same requests; returns what
    assert_near_tie_parity saw."""
    rng = np.random.default_rng(decode_steps)
    # request 0 alone first: a one-lane wave of 32 tokens (the W4A8/W8A8
    # kernel branch); then three more in one wave of 4 lanes × 64 tokens
    # (the dequantized / torch._int_mm branch); decode runs 4 rows (the
    # kernel branch)
    lens, news = [9, 40, 17, 33], [7, 5, 6, 4]
    prompts = [[int(x) for x in rng.integers(3, 128, size=n)] for n in lens]
    plain = (tqm.w4a8_matmul_tiled_plain, tqm.w8a8_matmul_plain,
             tra.ragged_attention_plain, tra.ragged_decode_attention_plain)
    before = [f.calls for f in plain]
    cfg, tree, model = llm
    jeng, teng = _engines(cfg, tree, model, quant=quant, max_batch=4,
                          decode_steps=decode_steps)

    def reqs(cls):
        return [cls(rid=str(i), input_ids=list(p), max_new_tokens=m,
                    eos_ids=(), logprobs=True)
                for i, (p, m) in enumerate(zip(prompts, news))]

    jreqs, treqs = reqs(JRequest), reqs(Request)
    want = drain_engine(jeng, jreqs[:1])
    got = drain_engine(teng, treqs[:1])
    want.update(drain_engine(jeng, jreqs[1:]))
    got.update(drain_engine(teng, treqs[1:]))
    for i, m in enumerate(news):
        assert len(got[str(i)].output_ids) == m
    seen = assert_near_tie_parity(got, want)
    # the engine quantized its own copy: quantized layers, int8 head/rows
    served = teng.runner.model
    w4 = quant["weight_quant"] == "int4"
    assert isinstance(served.lm_head, W8Linear)
    assert isinstance(served.layers[0].qkv, W4Linear if w4 else W8Linear)
    assert isinstance(model.lm_head, torch.nn.Linear)    # source untouched
    rows = teng.runner.rows
    assert rows["k"].dtype == torch.int8 and rows["ks"].dtype == torch.float32
    packed = quant["kv_quant"] == "int4"
    assert rows["k"].shape[3] * (2 if packed else 1) == rows["ks"].shape[3]
    # the CPU tensors ran every plain twin of the mode
    ran = [f.calls > n for f, n in zip(plain, before)]
    assert ran == [w4, not w4, True, True]
    return seen


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_w4_int8kv_greedy_matches_jax_engine(llm, decode_steps):
    _check_engine_parity(llm, decode_steps, W4KV8)


@pytest.mark.parametrize("decode_steps", [1, 4])
@pytest.mark.parametrize("quant", [
    W8KV8, dict(weight_quant="int4", kv_quant="int4")],
    ids=["w8kv8", "w4kv4"])
def test_quantized_engine_matches_jax_engine(llm, decode_steps, quant):
    """The W8 + int8-KV and W4 + packed-int4-KV engines, under the same
    contract as test_w4_int8kv_greedy_matches_jax_engine."""
    _check_engine_parity(llm, decode_steps, quant)


def test_engine_serves_prequantized_jax_tree(llm):
    """The reference's quantized trees bridged into the port are served as
    given and give the tokens of the port quantizing the dense weights
    itself (which test_w4_int8kv_greedy_matches_jax_engine holds to the
    JAX engine): the per-name tree in the W4 decode layout (what the JAX
    ServeEngine serves), and the fused one."""
    from aurora_tpu.serve.engine import (fuse_serving_weights,
                                         quantize_weights_int4,
                                         w4_decode_layout_params)
    cfg, tree, model = llm
    tcfg = bridge.llama_config_from(cfg)
    q = quantize_weights_int4(dict(tree))
    trees = (w4_decode_layout_params(q, cfg),
             w4_decode_layout_params(fuse_serving_weights(q), cfg))
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(3, 128, size=n)]
               for n in (12, 30)]

    def serve(m):
        eng = _port_engine(m, max_batch=2, decode_steps=4)
        assert eng.runner.model is m or m is model
        got = drain_engine(eng, [Request(rid=str(i), input_ids=p,
                                         max_new_tokens=6, eos_ids=())
                                 for i, p in enumerate(prompts)])
        return [got[str(i)].output_ids for i in range(len(prompts))]

    want = serve(model)
    for qtree in trees:
        q = bridge.llama_from_params(jax.device_get(qtree), tcfg,
                                     dtype=torch.float32, device="cpu")
        assert isinstance(q.lm_head, W8Linear)
        assert serve(q) == want


def test_engine_serves_prequantized_jax_w8_tree(llm):
    """The reference's W8 trees (quantize_weights_int8, per-name and
    fused) bridged into the port are served as given and give the tokens
    of the port quantizing the dense weights itself."""
    from aurora_tpu.serve.engine import (fuse_serving_weights,
                                         quantize_weights_int8)
    cfg, tree, model = llm
    tcfg = bridge.llama_config_from(cfg)
    q = quantize_weights_int8(dict(tree))
    rng = np.random.default_rng(6)
    prompts = [[int(x) for x in rng.integers(3, 128, size=n)]
               for n in (12, 30)]

    def serve(m):
        eng = _port_engine(m, quant=W8KV8, max_batch=2, decode_steps=4)
        assert eng.runner.model is m or m is model
        got = drain_engine(eng, [Request(rid=str(i), input_ids=p,
                                         max_new_tokens=6, eos_ids=())
                                 for i, p in enumerate(prompts)])
        return [got[str(i)].output_ids for i in range(len(prompts))]

    want = serve(model)
    for qtree in (q, fuse_serving_weights(q)):
        m = bridge.llama_from_params(jax.device_get(qtree), tcfg,
                                     dtype=torch.float32, device="cpu")
        assert isinstance(m.layers[0].o, W8Linear)
        assert serve(m) == want
    with pytest.raises(ValueError):     # a W8 model is not served as W4
        _port_engine(m)


@pytest.mark.parametrize("max_seq,chunk", [(96, 32), (1648, 256),
                                           (1700, 1024), (4096, 256)])
def test_row_buffer_bytes_and_s_row_int4_match_jax(max_seq, chunk):
    jc = JLlamaConfig.vicuna_7b_v15_16k()
    tc = bridge.llama_config_from(jc)
    kw = dict(max_batch=4, kv_chunk=chunk, max_seq_len=max_seq,
              kv_quant="int4")
    jcfg, tcfg_e = JEngineConfig(**kw), EngineConfig(**kw)
    assert tcfg_e.s_row == jcfg.s_row and tcfg_e.s_row % 256 == 0
    assert row_buffer_bytes(tc, tcfg_e) == j_row_buffer_bytes(jc, jcfg)


@pytest.mark.parametrize("max_seq", [1648, 4096])
def test_row_buffer_bytes_int8_matches_jax(max_seq):
    jc = JLlamaConfig.vicuna_7b_v15_16k()
    tc = bridge.llama_config_from(jc)
    want = j_row_buffer_bytes(jc, JEngineConfig(
        max_batch=4, kv_chunk=256, max_seq_len=max_seq, kv_quant="int8"))
    got = row_buffer_bytes(tc, EngineConfig(
        max_batch=4, kv_chunk=256, max_seq_len=max_seq, kv_quant="int8"))
    assert got == want


def main():
    """Print, for every case of the parity tests, the steps compared, the
    worst top-1 logprob difference and the top-2 gap of any flip (the
    measurement NEAR_TIE is set from), on the CPU as under pytest."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    modes = {"w4kv8": W4KV8, "w8kv8": W8KV8,
             "w4kv4": dict(weight_quant="int4", kv_quant="int4")}
    for name in sorted(CONFIGS):
        cfg = CONFIGS[name]
        tree = jax.device_get(init_llama_params(jax.random.PRNGKey(3), cfg,
                                                dtype=jnp.float32))
        model = bridge.llama_from_params(
            tree, bridge.llama_config_from(cfg), dtype=torch.float32,
            device="cpu")
        for mode, quant in modes.items():
            for steps in (1, 4):
                seen = _check_engine_parity((cfg, tree, model), steps, quant)
                for rid, (n, worst, gap) in sorted(seen.items()):
                    print(f"{name} {mode} decode_steps={steps} request {rid}:"
                          f" compared {n}, worst |Δ top-1 logprob| "
                          f"{worst:.2e}, flip gap "
                          f"{'-' if gap is None else f'{gap:.2e}'}")


if __name__ == "__main__":
    main()
