"""The port's ServeEngine vs the JAX ServeEngine on the tiny config.

Both engines serve the same requests with the same weights (the JAX init
bridged into the port), float32 weights and KV on the CPU, prefix caching
disabled on both. Greedy tokens must be equal exactly: text requests of
different lengths in one batched extend wave plus a rolling admission,
with decode_steps 1 and 4, and multimodal requests through both
AuroraCapServing front ends. Options the port has not ported must raise
NotImplementedError instead of being ignored.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.generate.sampler import SamplingParams as JSamplingParams
from aurora_tpu.models import aurora as jaurora
from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.models.projector import init_projector_params
from aurora_tpu.models.vit import init_vit_params
from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.engine import ServeEngine as JServeEngine
from aurora_tpu.serve.multimodal import AuroraCapServing as JServing
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch import bridge
from aurora_tpu_torch.generate.sampler import SamplingParams
from aurora_tpu_torch.ops.pallas import ragged_attention as tra
from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
from aurora_tpu_torch.serve.multimodal import AuroraCapServing
from aurora_tpu_torch.serve.scheduler import Request

from utils import drain_engine, make_tiny_tokenizer, random_frames

BUCKETS = (32, 64)


@pytest.fixture(scope="module")
def tiny():
    cfg = jaurora.AuroraConfig.tiny()
    cfg = dataclasses.replace(cfg, llm=JLlamaConfig.tiny(vocab_size=512))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    tree = jax.device_get(
        {"visual_encoder": init_vit_params(keys[0], cfg.vit),
         "projector": init_projector_params(keys[1], cfg.projector),
         "llm": init_llama_params(keys[2], cfg.llm)})
    model = bridge.aurora_from_params(tree, bridge.aurora_config_from(cfg),
                                      dtype=torch.float32, device="cpu")
    return cfg, tree, model


def _engines(tiny, decode_steps, embed_fns=(None, None)):
    cfg, tree, model = tiny
    jeng = JServeEngine(tree["llm"], cfg.llm, JEngineConfig(
        max_batch=4, max_seq_len=128, prefill_buckets=BUCKETS,
        kv_dtype=jnp.float32, kv_chunk=64, decode_steps=decode_steps,
        disable_radix_cache=True), embed_fn=embed_fns[0])
    teng = ServeEngine(model.llm, model.cfg.llm, EngineConfig(
        max_batch=4, max_seq_len=128, prefill_buckets=BUCKETS,
        kv_dtype=torch.float32, kv_chunk=64, decode_steps=decode_steps,
        disable_radix_cache=True), embed_fn=embed_fns[1])
    return jeng, teng


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_greedy_tokens_match_jax_engine(tiny, decode_steps):
    rng = np.random.default_rng(decode_steps)
    lens, news = [5, 17, 30, 9, 12], [8, 5, 9, 6, 7]
    prompts = [[int(x) for x in rng.integers(3, 512, size=n)] for n in lens]
    jeng, teng = _engines(tiny, decode_steps)
    want = drain_engine(jeng, [
        JRequest(rid=str(i), input_ids=list(p), max_new_tokens=m,
                 eos_ids=())
        for i, (p, m) in enumerate(zip(prompts, news))])
    launches = (tra.ragged_attention.launches,
                tra.ragged_decode_attention.launches)
    calls = tra.ragged_decode_attention_plain.calls
    got = drain_engine(teng, [
        Request(rid=str(i), input_ids=list(p), max_new_tokens=m,
                eos_ids=())
        for i, (p, m) in enumerate(zip(prompts, news))])
    for i, m in enumerate(news):
        assert len(got[str(i)].output_ids) == m
        assert got[str(i)].output_ids == want[str(i)].output_ids, i
    # CPU tensors ran the plain twins, never a CUDA launch
    assert (tra.ragged_attention.launches,
            tra.ragged_decode_attention.launches) == launches
    assert tra.ragged_decode_attention_plain.calls > calls
    assert not teng.has_work()
    assert all(r is None for r in teng.row_reqs)
    stats = teng.decode_stats()
    assert stats["running"] == stats["queued"] == 0
    assert stats["decode_s"] > 0


def test_row_buffer_bytes_matches_jax():
    from aurora_tpu.serve.engine import row_buffer_bytes as j_bytes
    from aurora_tpu_torch.serve.engine import row_buffer_bytes
    jc = JLlamaConfig.vicuna_7b_v15_16k()
    tc = bridge.llama_config_from(jc)
    for max_seq in (1648, 4096):
        want = j_bytes(jc, JEngineConfig(max_batch=4, kv_chunk=256,
                                          max_seq_len=max_seq))
        got = row_buffer_bytes(tc, EngineConfig(max_batch=4, kv_chunk=256,
                                                max_seq_len=max_seq))
        assert got == want


@pytest.mark.parametrize("samp", [
    dict(repetition_penalty=1.5, frequency_penalty=0.7,
         presence_penalty=0.3),
    dict(min_new_tokens=6),
    dict(temperature=0.8, top_k=1)])
def test_penalized_greedy_matches_jax_engine(tiny, samp):
    """Deterministic sampler settings: penalties over the on-device
    histograms, eos suppression below min_new_tokens, and top_k = 1
    sampling (the argmax whatever the draw)."""
    rng = np.random.default_rng(11)
    prompts = [[int(x) for x in rng.integers(3, 40, size=n)]
               for n in (12, 20)]
    jeng, teng = _engines(tiny, 4)
    want = drain_engine(jeng, [
        JRequest(rid=str(i), input_ids=list(p), max_new_tokens=10,
                 eos_ids=(2,), sampling=JSamplingParams(**samp))
        for i, p in enumerate(prompts)])
    got = drain_engine(teng, [
        Request(rid=str(i), input_ids=list(p), max_new_tokens=10,
                eos_ids=(2,), sampling=SamplingParams(**samp))
        for i, p in enumerate(prompts)])
    for i in range(len(prompts)):
        assert got[str(i)].output_ids == want[str(i)].output_ids, i


def test_sampled_decode_is_seeded_and_valid(tiny):
    """temperature > 0 draws from the engine's own torch.Generator: the
    same seed gives the same tokens, and every token is a vocab id."""
    _, _, model = tiny
    outs = []
    for _ in range(2):
        eng = ServeEngine(model.llm, model.cfg.llm, EngineConfig(
            max_batch=2, max_seq_len=128, prefill_buckets=BUCKETS,
            kv_dtype=torch.float32, kv_chunk=64, decode_steps=4), seed=7)
        done = drain_engine(eng, [Request(
            rid="s", input_ids=[5, 9, 14, 3], max_new_tokens=12, eos_ids=(),
            sampling=SamplingParams(temperature=1.0, top_p=0.9, min_p=0.05),
            logprobs=True)])
        outs.append(done["s"])
    assert outs[0].output_ids == outs[1].output_ids
    assert len(outs[0].output_ids) == 12
    assert all(0 <= t < model.cfg.llm.vocab_size
               for t in outs[0].output_ids)
    assert len(outs[0].output_top_logprobs) == 12
    assert all(lp <= 0.0 for lp in outs[0].output_logprobs)


def test_multimodal_greedy_matches_jax_engine(tiny, tmp_path):
    cfg, tree, model = tiny
    tok = make_tiny_tokenizer(str(tmp_path))
    jmm = JServing(tree, cfg, tok, kept_ratio=0.5, image_size=56)
    tmm = AuroraCapServing(model, tok, kept_ratio=0.5, image_size=56)
    jeng, teng = _engines(tiny, 4, (jmm.embed_fn, tmm.embed_fn))
    rng = np.random.default_rng(3)
    clips = [random_frames(rng, f=2, size=56) for _ in range(2)]
    prompts = ["<image> <image>\nWhat happens?", "<image><image> Describe."]
    jreqs, treqs = [], []
    for i, (clip, text) in enumerate(zip(clips, prompts)):
        jreqs.append(jmm.build_request(
            f"v{i}", text, clip, sampling=JSamplingParams(),
            max_new_tokens=6, eos_ids=()))
        treqs.append(tmm.build_request(f"v{i}", text, clip,
                                       max_new_tokens=6, eos_ids=()))
        assert treqs[-1].input_ids == jreqs[-1].input_ids
    want = drain_engine(jeng, jreqs)
    got = drain_engine(teng, treqs)
    for i in range(2):
        assert got[f"v{i}"].output_ids == want[f"v{i}"].output_ids
    # the fused embeds themselves agree (fp32 ViT + projector + fusion)
    np.testing.assert_allclose(tmm.embed_fn(treqs[0]).numpy(),
                               jmm.embed_fn(jreqs[0]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("field,value", [("tp", 2)])
def test_unported_engine_options_raise(field, value):
    with pytest.raises(NotImplementedError):
        EngineConfig(**{field: value})


@pytest.mark.parametrize("kind", ["stop_strs", "constraint", "chunked"])
def test_unported_request_features_raise(tiny, kind):
    _, _, model = tiny
    eng = ServeEngine(model.llm, model.cfg.llm, EngineConfig(
        max_batch=2, max_seq_len=128, prefill_buckets=BUCKETS,
        kv_dtype=torch.float32, kv_chunk=64))
    kw = {"stop_strs": dict(stop_strs=("x",)),
          "constraint": dict(constraint=object()),
          "chunked": dict(input_ids=list(range(3, 3 + 65)))}[kind]
    req = Request(**{"rid": "r", "input_ids": [5, 6, 7], **kw})
    with pytest.raises(NotImplementedError):
        eng.add_request(req)
