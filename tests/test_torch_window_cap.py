"""Mistral's sliding window and the attention logit softcap in the port,
against the JAX package on the CPU.

The bridge carries both config knobs (and still refuses the other
families' ones); `llama_apply` masks the window and caps the scores as
the JAX `llama_apply` does; `mha` computes a capped call explicitly; and
the port's ServeEngine matches the JAX ServeEngine on a tiny config with
`sliding_window=8` and prompts of 24 tokens (tests/test_serve.py's
windowed case): exact greedy tokens with fp32 KV, the near-tie contract
of tests/test_torch_engine_quant.py with int8 and packed int4 KV; and on
a tiny config with `attn_logit_softcap=30`, exact greedy tokens. Float32
weights and activations on both sides; the JAX kernels run in interpret
mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models import llama as jllama
from aurora_tpu.ops import attention as jattn
from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.engine import ServeEngine as JServeEngine
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models import llama as tllama
from aurora_tpu_torch.ops import attention as tattn
from aurora_tpu_torch.ops.pallas import ragged_attention as tra
from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
from aurora_tpu_torch.serve.scheduler import Request

from test_torch_engine_quant import assert_near_tie_parity
from utils import drain_engine

TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_torch_train.py's bound
WINDOWED = dict(sliding_window=8)
CAPPED = dict(attn_logit_softcap=30.0)
QK_GAIN = 30.0    # q, k kernel std 0.6: scores of std ~20 in the tiny model


def _cfg(**knobs):
    return dataclasses.replace(jllama.LlamaConfig.tiny(vocab_size=128),
                               **knobs)


def _llm(jcfg, seed=11):
    """The JAX init and its bridge. With a cap, the q and k kernels are
    scaled by QK_GAIN so that scores reach the cap's scale (at std 0.02
    they stay near 1e-3, where c * tanh(s / c) is s to 1e-9)."""
    tree = jax.device_get(jllama.init_llama_params(
        jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32))
    if jcfg.attn_logit_softcap > 0:
        layers = dict(tree["layers"])
        for name in ("q", "k"):
            layers[name] = layers[name] * QK_GAIN
        tree = dict(tree, layers=layers)
    model = bridge.llama_from_params(tree, bridge.llama_config_from(jcfg),
                                     dtype=torch.float32, device="cpu")
    return tree, model


def test_bridge_carries_mistral_and_the_cap():
    got = bridge.llama_config_from(jllama.LlamaConfig.mistral_7b())
    assert got == tllama.LlamaConfig.mistral_7b()
    assert (got.sliding_window, got.num_key_value_heads) == (4096, 8)
    assert got.head_dim == 128
    assert bridge.llama_config_from(_cfg(**CAPPED)).attn_logit_softcap == 30.


# the dense family knobs cross (tests/test_torch_zoo.py), and so do the
# MoE, MLA and YaRN ones (tests/test_torch_moe.py, test_torch_mla.py)
@pytest.mark.parametrize("knob,value", [
    ("num_experts", 4), ("first_k_dense", 1),
    ("moe_router_logit_softcap", 30.0), ("moe_router_mode", "softmax_topk"),
    ("mla_kv_lora_rank", 16), ("rope_inv_freq", (1.0, 0.5)),
    ("rope_attention_scaling", 1.5)])
def test_bridge_still_refuses_other_family_knobs(knob, value):
    got = bridge.llama_config_from(_cfg(**WINDOWED, **{knob: value}))
    assert getattr(got, knob) == value and got.sliding_window


@pytest.mark.parametrize("knobs", [WINDOWED, CAPPED,
                                   dict(**WINDOWED, **CAPPED)],
                         ids=["window", "cap", "window+cap"])
@pytest.mark.parametrize("masked", [False, True])
def test_llama_apply_matches_jax(knobs, masked):
    """24 tokens (3 windows), with or without a key padding mask."""
    jcfg = _cfg(**knobs)
    tree, model = _llm(jcfg)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 128, size=(2, 24))
    mask = np.ones((2, 24), bool)
    mask[1, -5:] = False
    want, _ = jllama.llama_apply(
        tree, jcfg, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask) if masked else None)
    got = tllama.llama_apply(
        model, model.cfg, input_ids=torch.from_numpy(ids),
        attention_mask=torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    plain = tllama.llama_apply(
        model, dataclasses.replace(model.cfg, sliding_window=None,
                                   attn_logit_softcap=0.0),
        input_ids=torch.from_numpy(ids))
    assert (got - plain).abs().max().item() > 1e-3   # the option acted


def test_mha_cap_matches_jax_with_bias_mask_and_gqa():
    rng = np.random.default_rng(5)
    q = 4 * rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    bias = rng.standard_normal((2, 1, 12, 20)).astype(np.float32)
    mask = rng.random((2, 1, 1, 20)) > 0.2
    kw = dict(causal=True, q_offset=8, logit_cap=5.0)
    want = jattn.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     bias=jnp.asarray(bias), mask=jnp.asarray(mask),
                     use_flash=False, **kw)
    got = tattn.mha(*(torch.from_numpy(a) for a in (q, k, v)),
                    bias=torch.from_numpy(bias),
                    mask=torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="logit cap"):
        tattn.mha(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                  logit_cap=5.0, use_flash=True)


def _serve_both(knobs, kv_quant, logprobs=False):
    """Both engines through two 24-token prompts (3× a window of 8) in one
    extend wave, then 8 greedy tokens each, decode_steps 4."""
    jcfg = _cfg(**knobs)
    tree, model = _llm(jcfg)
    common = dict(max_batch=2, max_seq_len=64, prefill_buckets=(16, 32),
                  kv_chunk=16, decode_steps=4, kv_quant=kv_quant,
                  disable_radix_cache=True)
    jeng = JServeEngine(tree, jcfg, JEngineConfig(kv_dtype=jnp.float32,
                                                  **common))
    teng = ServeEngine(model, model.cfg, EngineConfig(kv_dtype=torch.float32,
                                                      **common))
    rng = np.random.default_rng(13)
    prompts = [[int(x) for x in rng.integers(3, 128, size=24)]
               for _ in range(2)]

    def reqs(cls):
        return [cls(rid=str(i), input_ids=list(p), max_new_tokens=8,
                    eos_ids=(), logprobs=logprobs)
                for i, p in enumerate(prompts)]

    want = drain_engine(jeng, reqs(JRequest))
    before = (tra.ragged_attention.launches_window,
              tra.ragged_decode_attention.launches_window,
              tra.ragged_attention_plain.calls,
              tra.ragged_decode_attention_plain.calls)
    got = drain_engine(teng, reqs(Request))
    after = (tra.ragged_attention.launches_window,
             tra.ragged_decode_attention.launches_window,
             tra.ragged_attention_plain.calls,
             tra.ragged_decode_attention_plain.calls)
    # CPU tensors: the twins ran, no kernel launched
    assert after[:2] == before[:2]
    assert after[2] > before[2] and after[3] > before[3]
    return got, want


@pytest.mark.parametrize("knobs", [WINDOWED, CAPPED],
                         ids=["window", "cap"])
def test_engine_greedy_tokens_match_jax_engine(knobs):
    got, want = _serve_both(knobs, "none")
    for rid, w in want.items():
        assert len(got[rid].output_ids) == 8
        assert got[rid].output_ids == w.output_ids, rid


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_windowed_quantized_kv_engine_matches_jax_engine(kv_quant):
    got, want = _serve_both(WINDOWED, kv_quant, logprobs=True)
    assert_near_tie_parity(got, want)


def test_profile_serve_mistral_runs_on_cpu(tmp_path, capsys):
    """The profile's --mistral mode on the tiny config with a window of 8
    (no device events on the CPU, so every family reads 0)."""
    import json

    from aurora_tpu_torch.tools import profile_serve
    calls = tra.ragged_decode_attention_plain.calls
    assert profile_serve.main(["--tiny", "--mistral", "--device", "cpu",
                               "--reps", "1", "--steps", "4", "--batch", "2",
                               "--out", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (res["model"], res["window"], res["kv"]) == ("mistral-7b", 8,
                                                       "float32")
    assert res["decode_ms_per_step_dense_matmul"] == 0.0
    assert tra.ragged_decode_attention_plain.calls > calls
    events = [("gemvx_kernel", 0, 6.0), ("decode_kernel<bf16>", 0, 8.0),
              ("nvjet_tst_64x8", 0, 2.0), ("elementwise", 0, 4.0)]
    assert profile_serve.matmul_ms(events, 2) == 0.004


def test_profile_serve_gemma2_runs_on_cpu(tmp_path, capsys):
    """The profile's --gemma2 mode on Gemma2Config.tiny (window 8 on the
    even layers, both caps; no device events on the CPU, so the extend
    split reads 0), and every ragged extend kernel's name in the attention
    family."""
    import json

    from aurora_tpu_torch.tools import profile_serve
    calls = (tra.ragged_attention_plain.calls,
             tra.ragged_decode_attention_plain.calls)
    assert profile_serve.main(["--tiny", "--gemma2", "--device", "cpu",
                               "--reps", "1", "--steps", "4", "--batch", "2",
                               "--out", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (res["model"], res["window"], res["kv"]) == ("gemma-2-9b", 8,
                                                       "float32")
    assert res["extend_split_ms"] == {"attention": 0.0, "cublas": 0.0,
                                      "rest": 0.0}
    assert tra.ragged_attention_plain.calls > calls[0]
    assert tra.ragged_decode_attention_plain.calls > calls[1]
    events = [("void extend_kernel<128, bf16, false>", 0, 1.0),
              ("void extend_kernel<96, bf16, false>", 0, 2.0),
              ("void extend_d256_kernel<bf16, false>", 0, 4.0),
              ("nvjet_tst_64x8", 0, 8.0)]
    fam = profile_serve.family_ms(events, 1)
    assert (fam["attention"], fam["other"]) == (0.007, 0.008)
