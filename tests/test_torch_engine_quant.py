"""The port's W4-weights + int8-KV ServeEngine vs the JAX ServeEngine.

Both engines serve the same requests from the same fp32 weights, each
quantizing them itself (EngineConfig(weight_quant="int4",
kv_quant="int8")), float32 activations on the CPU, prefix caching off on
both; the JAX kernels run in interpret mode. Greedy tokens must be equal
exactly. Two configs: the 2-layer hidden-256 config of
tests/test_serve.py's tiled-layout test, where every JAX projection takes
the tile-contiguous layout and the Pallas w4a8_matmul_tiled kernel, and
`tiny`, whose projections stay flat. The prompts reach both _w4dot
branches: a one-lane wave of at most 64 tokens (the W4A8 kernel) and a
wave of more than 64 (dequantized weights); decode runs 4 lanes.
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

BUCKETS = (32, 64)
QUANT = dict(weight_quant="int4", kv_quant="int8")
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
                                     dtype=torch.float32)
    return cfg, tree, model


def _common(**kw):
    return dict(max_seq_len=96, prefill_buckets=BUCKETS, kv_chunk=32,
                disable_radix_cache=True, **QUANT, **kw)


def _port_engine(model, **kw):
    return ServeEngine(model, model.cfg,
                       EngineConfig(kv_dtype=torch.float32, **_common(**kw)))


def _engines(cfg, tree, model, **kw):
    return (JServeEngine(tree, cfg, JEngineConfig(kv_dtype=jnp.float32,
                                                  **_common(**kw))),
            _port_engine(model, **kw))


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_w4_int8kv_greedy_matches_jax_engine(llm, decode_steps):
    rng = np.random.default_rng(decode_steps)
    # request 0 alone first: a one-lane wave of 32 tokens (W4A8 kernel
    # branch); then three more in one wave of 4 lanes × 64 tokens
    # (dequantized branch); decode runs 4 rows (the kernel branch)
    lens, news = [9, 40, 17, 33], [7, 5, 6, 4]
    prompts = [[int(x) for x in rng.integers(3, 128, size=n)] for n in lens]
    w4 = tqm.w4a8_matmul_tiled_plain.calls
    attn = (tra.ragged_attention_plain.calls,
            tra.ragged_decode_attention_plain.calls)
    cfg, tree, model = llm
    jeng, teng = _engines(cfg, tree, model, max_batch=4,
                          decode_steps=decode_steps)
    jreqs = [JRequest(rid=str(i), input_ids=list(p), max_new_tokens=m,
                      eos_ids=()) for i, (p, m) in enumerate(zip(prompts,
                                                                 news))]
    treqs = [Request(rid=str(i), input_ids=list(p), max_new_tokens=m,
                     eos_ids=()) for i, (p, m) in enumerate(zip(prompts,
                                                                news))]
    want = drain_engine(jeng, jreqs[:1])
    got = drain_engine(teng, treqs[:1])
    want.update(drain_engine(jeng, jreqs[1:]))
    got.update(drain_engine(teng, treqs[1:]))
    for i, m in enumerate(news):
        assert len(got[str(i)].output_ids) == m
        assert got[str(i)].output_ids == want[str(i)].output_ids, i
    # the engine quantized its own copy: W4 layers, int8 head and rows
    served = teng.runner.model
    assert isinstance(served.lm_head, W8Linear)
    assert isinstance(served.layers[0].qkv, W4Linear)
    assert isinstance(model.lm_head, torch.nn.Linear)    # source untouched
    assert teng.runner.rows["k"].dtype == torch.int8
    assert teng.runner.rows["ks"].dtype == torch.float32
    # the CPU tensors ran every plain twin
    assert tqm.w4a8_matmul_tiled_plain.calls > w4
    assert tra.ragged_attention_plain.calls > attn[0]
    assert tra.ragged_decode_attention_plain.calls > attn[1]


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
                                     dtype=torch.float32)
        assert isinstance(q.lm_head, W8Linear)
        assert serve(q) == want


@pytest.mark.parametrize("max_seq", [1648, 4096])
def test_row_buffer_bytes_int8_matches_jax(max_seq):
    jc = JLlamaConfig.vicuna_7b_v15_16k()
    tc = bridge.llama_config_from(jc)
    want = j_row_buffer_bytes(jc, JEngineConfig(
        max_batch=4, kv_chunk=256, max_seq_len=max_seq, kv_quant="int8"))
    got = row_buffer_bytes(tc, EngineConfig(
        max_batch=4, kv_chunk=256, max_seq_len=max_seq, kv_quant="int8"))
    assert got == want
