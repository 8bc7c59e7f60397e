"""Gemma-2 in the port (models/gemma2.py) against the JAX package, on
the CPU.

The tiny preset with query_pre_attn_scalar 24 (not head_dim 16, so the
scale's source is tested), norm weights redrawn around 0 (HF's (1 + w)
convention), float32: `gemma2_apply` within 1e-4 of the JAX
`gemma2_apply` (tests/test_torch_train.py's bound), also over a KV cache
in two steps; the HF converter bit for bit against the JAX one (a
transformers Gemma2 checkpoint); `gemma2_serving_config` equal to the
bridge of the JAX one and `gemma2_serving_params` to the bridge of the
JAX serving tree; the port's engine on the serving mapping against the
port's offline greedy decode (24-token prompts past the window of 8, so
that the alternation matters) and against the JAX engine: exactly with
fp32 KV, under the near-tie contract of tests/test_torch_engine_quant.py
with int8 and packed int4 KV; and the serving CLI's loader
(`load_serving_dir`) on a saved Gemma2ForCausalLM directory. The JAX
kernels run in interpret mode.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models import gemma2 as jg2
from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.engine import ServeEngine as JServeEngine
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models import gemma2 as tg2
from aurora_tpu_torch.models.convert import load_serving_dir
from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
from aurora_tpu_torch.serve.scheduler import Request

from test_torch_engine_quant import assert_near_tie_parity
from utils import drain_engine

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(jg2.Gemma2Config.tiny(vocab_size=128),
                              query_pre_attn_scalar=24.0)
    tree = jax.device_get(jg2.init_gemma2_params(jax.random.PRNGKey(3), cfg,
                                                 dtype=jnp.float32))
    rng = np.random.default_rng(0)
    layers = dict(tree["layers"])
    for name in ("input_norm", "post_attn_norm", "pre_ffw_norm",
                 "post_ffw_norm"):
        layers[name] = 0.1 * rng.standard_normal(
            layers[name].shape).astype(np.float32)
    for name in ("q", "k"):     # scores large enough for the cap to bite
        layers[name] = layers[name] * 20
    tree = dict(tree, layers=layers,
                final_norm=0.1 * rng.standard_normal(
                    tree["final_norm"].shape).astype(np.float32))
    tcfg = tg2.Gemma2Config(**dataclasses.asdict(cfg))
    model = bridge.gemma2_from_params(tree, tcfg, device="cpu",
                                      dtype=torch.float32)
    return cfg, tree, model


def test_gemma2_apply_matches_jax(tiny):
    cfg, tree, model = tiny
    ids = np.random.default_rng(1).integers(3, 128, size=(2, 20))
    want, _ = jg2.gemma2_apply(tree, cfg, input_ids=jnp.asarray(ids))
    got = tg2.gemma2_apply(model, model.cfg, input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # over a KV cache: 12 tokens, then 8 more
    cache = {k: torch.zeros((4, 2, 32, 2, 16)) for k in "kv"}
    tg2.gemma2_apply(model, model.cfg, input_ids=torch.from_numpy(ids[:, :12]),
                     kv_cache=cache)
    step, _ = tg2.gemma2_apply(model, model.cfg,
                               input_ids=torch.from_numpy(ids[:, 12:]),
                               kv_cache=cache, cache_len=12)
    np.testing.assert_allclose(step.detach().numpy(), np.asarray(want)[:, 12:],
                               **TOL)
    # the scale follows query_pre_attn_scalar, not head_dim
    other = tg2.gemma2_apply(model, dataclasses.replace(
        model.cfg, query_pre_attn_scalar=16.0),
        input_ids=torch.from_numpy(ids))
    assert (other - got).abs().max().item() > 1e-3


def test_gemma2_converter_and_serving_mapping_match_jax(tiny, tmp_path):
    import transformers
    torch.manual_seed(0)
    hf_cfg = transformers.Gemma2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, sliding_window=8, query_pre_attn_scalar=24,
        max_position_embeddings=128, attn_implementation="eager")
    hf = transformers.Gemma2ForCausalLM(hf_cfg).eval()
    rng = np.random.default_rng(2)
    sd = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in sorted(hf.state_dict().items())}
    jcfg = jg2.gemma2_config_from_hf(hf_cfg.to_dict())
    tcfg = tg2.gemma2_config_from_hf(hf_cfg.to_dict())
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jtree = jax.device_get(jg2.gemma2_params_from_hf(sd, jcfg,
                                                     dtype=jnp.float32))
    model = tg2.gemma2_params_from_hf(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg,
        dtype=torch.float32, device="cpu")
    want = bridge.gemma2_state_dict(jtree, tcfg)
    assert model.state_dict().keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k
    # the serving mapping: config and the (1 + w) norms
    scfg = tg2.gemma2_serving_config(tcfg)
    assert scfg == bridge.llama_config_from(jg2.gemma2_serving_config(jcfg))
    served = tg2.gemma2_serving_params(model)
    swant = bridge.llama_state_dict(
        jax.device_get(jg2.gemma2_serving_params(jtree)), scfg)
    assert served.state_dict().keys() == swant.keys()
    for k, v in swant.items():
        assert torch.equal(served.state_dict()[k], v), k
    # the serving CLI's loader on a saved checkpoint
    from safetensors.torch import save_file
    save_file({k: torch.from_numpy(v) for k, v in sd.items()},
              str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    loaded, lcfg = load_serving_dir(str(tmp_path), torch.float32, "cpu")
    assert lcfg == scfg
    for k, v in served.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def _offline_greedy(model, ids, n):
    out = []
    for _ in range(n):
        logits = tg2.gemma2_apply(model, model.cfg,
                                  input_ids=torch.tensor([ids + out]))
        out.append(int(logits[0, -1].argmax()))
    return out


def _serve_both(tiny, kv_quant):
    """Both engines on the serving mapping: two 24-token prompts (3x the
    window of 8) in one wave, 6 greedy tokens each, logprobs on."""
    cfg, tree, model = tiny
    common = dict(max_batch=2, max_seq_len=64, prefill_buckets=(16, 32),
                  kv_chunk=16, decode_steps=2, kv_quant=kv_quant,
                  disable_radix_cache=True)
    jeng = JServeEngine(jg2.gemma2_serving_params(tree),
                        jg2.gemma2_serving_config(cfg),
                        JEngineConfig(kv_dtype=jnp.float32, **common))
    served = tg2.gemma2_serving_params(model)
    teng = ServeEngine(served, served.cfg,
                       EngineConfig(kv_dtype=torch.float32, **common))
    rng = np.random.default_rng(13)
    prompts = [[int(x) for x in rng.integers(3, 128, size=24)]
               for _ in range(2)]

    def reqs(cls):
        return [cls(rid=str(i), input_ids=list(p), max_new_tokens=6,
                    eos_ids=(), logprobs=True)
                for i, p in enumerate(prompts)]

    return (drain_engine(teng, reqs(Request)), drain_engine(jeng,
                                                            reqs(JRequest)),
            prompts)


def test_gemma2_served_matches_offline_and_jax_engine(tiny):
    got, want, prompts = _serve_both(tiny, "none")
    for i, p in enumerate(prompts):
        assert got[str(i)].output_ids == _offline_greedy(tiny[2], p, 6)
        assert got[str(i)].output_ids == want[str(i)].output_ids


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_gemma2_quantized_kv_engine_matches_jax_engine(tiny, kv_quant):
    got, want, _ = _serve_both(tiny, kv_quant)
    assert_near_tie_parity(got, want)
