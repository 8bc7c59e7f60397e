"""DeepSeek-V2 (multi-head latent attention, shared-expert MoE) in the port
against the JAX package, on the CPU, float32:

* `deepseek_v2_apply` against the JAX one (V2-Lite's direct q, the q LoRA
  of the larger models, group-limited greedy routing with routed scaling
  and renormalization, YaRN frequencies), logits within 1e-4; and over
  its per-head KV cache, a prefill then decode steps;
* YaRN: `deepseek_v2_config_from_hf` gives the reference's config, whose
  inverse frequencies and attention scaling come from transformers' rope
  init, exactly (V2-Lite's shipped rope_scaling among the cases);
* `deepseek_v2_params_from_hf` on a HF-named state dict: the bridge of the
  JAX tree, bit for bit;
* the serving mapping: `deepseek_serving_config` is the bridge of the
  reference's, and `deepseek_serving_params` shares the model's tensors;
* the latent pool (`KVPool` for an MLA config: one plane, no V) and
  `kv_bytes_per_token_layer` against the reference's;
* the port's ServeEngine over the latent rows against the JAX engine:
  two waves, the second hitting the first's prefixes through the radix
  cache (`_load_prefix` / `_store_prompt` at the latent width), tokens
  exact, the same cache and memory accounting; the all-dense and the
  dense-prefix + MoE layouts;
* the fp32 expert path in its two forms (`ds_moe_grouped` over the
  grouped products, `ds_moe_dense` the reference's), within 1e-6;
* `load_serving_dir` on a DeepSeek-V2 directory and the refusals of MLA
  serving (weight_quant, kv_quant).
The JAX kernels run in interpret mode.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models import deepseek_v2 as jds
from aurora_tpu.serve import engine as jeng
from aurora_tpu.serve import mla as jmla
from aurora_tpu.serve.kv_pool import KVPool as JKVPool
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models import convert as tconvert
from aurora_tpu_torch.models import deepseek_v2 as tds
from aurora_tpu_torch.serve import engine as teng
from aurora_tpu_torch.serve import mla as tmla
from aurora_tpu_torch.serve.kv_pool import KVPool
from aurora_tpu_torch.serve.scheduler import Request

from utils import drain_engine

TOL = dict(rtol=1e-4, atol=1e-4)
# the reference's forward under jit (its eager dispatch compiles every op
# of every expert on first use: ~5 s a call shape)
_japply = jax.jit(jds.deepseek_v2_apply, static_argnums=(1,))

CONFIGS = {
    "lite": {},
    "q-lora": dict(q_lora_rank=24),
    "group-limited": dict(n_routed_experts=8, num_experts_per_tok=3,
                          topk_method="group_limited_greedy", n_group=4,
                          topk_group=2, norm_topk_prob=True,
                          routed_scaling_factor=1.5),
    "yarn": dict(rope_inv_freq=tuple(float(x) for x in
                                     np.linspace(1.0, 1e-3, 4)),
                 rope_attention_scaling=1.25),
    "dense": dict(n_routed_experts=0, n_shared_experts=0),
}


@functools.lru_cache(maxsize=None)
def pair(name):
    """(JAX config, JAX per-layer tree, port config, port model)."""
    jcfg = dataclasses.replace(jds.DeepseekV2Config.tiny(vocab_size=128),
                               **CONFIGS[name])
    tree = jax.device_get(jds.init_deepseek_v2_params(
        jax.random.PRNGKey(sorted(CONFIGS).index(name) + 3), jcfg,
        dtype=jnp.float32))
    tcfg = tds.DeepseekV2Config(**dataclasses.asdict(jcfg))
    model = bridge.deepseek_v2_from_params(tree, tcfg, device="cpu",
                                           dtype=torch.float32)
    return jcfg, tree, tcfg, model


@pytest.mark.parametrize("name", ["lite", "q-lora", "group-limited", "yarn"])
def test_deepseek_v2_apply_matches_jax(name):
    jcfg, tree, tcfg, model = pair(name)
    ids = np.random.default_rng(1).integers(3, 128, size=(2, 13))
    want, _ = _japply(tree, jcfg, input_ids=jnp.asarray(ids))
    got, _ = tds.deepseek_v2_apply(model, tcfg,
                                   input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_deepseek_v2_kv_cache_decode_matches_jax():
    jcfg, tree, tcfg, model = pair("lite")
    ids = np.random.default_rng(2).integers(3, 128, size=(1, 12))
    jc = jds.init_deepseek_v2_kv_cache(jcfg, 1, 16, dtype=jnp.float32)
    tc = tds.init_deepseek_v2_kv_cache(tcfg, 1, 16, dtype=torch.float32)
    for start, end in ((0, 8), (8, 9), (9, 10), (10, 12)):
        want, jc = _japply(
            tree, jcfg, input_ids=jnp.asarray(ids[:, start:end]),
            kv_cache=jc, cache_len=start)
        got, tc = tds.deepseek_v2_apply(
            model, tcfg, input_ids=torch.from_numpy(ids[:, start:end]),
            kv_cache=tc, cache_len=start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


HF_BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               moe_intermediate_size=32, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=4,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
               kv_lora_rank=32, q_lora_rank=None, n_routed_experts=4,
               n_shared_experts=1, num_experts_per_tok=2,
               first_k_dense_replace=1, moe_layer_freq=1,
               max_position_embeddings=512, rms_norm_eps=1e-6,
               topk_method="greedy", n_group=1, topk_group=1,
               model_type="deepseek_v2",
               architectures=["DeepseekV2ForCausalLM"])
V2_LITE_ROPE = {"type": "yarn", "factor": 40, "beta_fast": 32,
                "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707,
                "original_max_position_embeddings": 4096}


@pytest.mark.parametrize("change", [
    {}, {"rope_scaling": {"type": "yarn", "factor": 4.0,
                          "original_max_position_embeddings": 128,
                          "beta_fast": 32, "beta_slow": 1}},
    {"rope_scaling": dict(V2_LITE_ROPE), "qk_rope_head_dim": 64,
     "max_position_embeddings": 163840, "rope_theta": 10000},
    {"rope_scaling": {"rope_type": "yarn", "factor": 8.0,
                      "attention_factor": 0.9}}],
    ids=["none", "yarn", "v2-lite", "attention-factor"])
def test_deepseek_v2_config_from_hf_matches_jax(change):
    hf = dict(HF_BASE, **change)
    want = jds.deepseek_v2_config_from_hf(json.loads(json.dumps(hf)))
    got = tds.deepseek_v2_config_from_hf(json.loads(json.dumps(hf)))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if change:
        assert got.rope_inv_freq is not None


def _hf_state_dict(tree):
    """A JAX DeepSeek-V2 tree under HF DeepseekV2ForCausalLM's names
    ([out, in] weights)."""
    sd = {"model.embed_tokens.weight": tree["embed_tokens"],
          "model.norm.weight": tree["final_norm"],
          "lm_head.weight": np.asarray(tree["lm_head"]).T}
    for i, lp in enumerate(tree["layers"]):
        p = f"model.layers.{i}."
        for ours, theirs in (("input_norm", "input_layernorm"),
                             ("post_attn_norm", "post_attention_layernorm"),
                             ("kv_a_norm", "self_attn.kv_a_layernorm"),
                             ("q_a_norm", "self_attn.q_a_layernorm")):
            if ours in lp:
                sd[p + theirs + ".weight"] = lp[ours]
        for ours, theirs in (("q", "q_proj"), ("q_a", "q_a_proj"),
                             ("q_b", "q_b_proj"),
                             ("kv_a", "kv_a_proj_with_mqa"),
                             ("kv_b", "kv_b_proj"), ("o", "o_proj")):
            if ours in lp:
                sd[f"{p}self_attn.{theirs}.weight"] = np.asarray(lp[ours]).T
        names = (("gate", "gate_proj"), ("up", "up_proj"),
                 ("down", "down_proj"))
        if "mlp" in lp:
            for ours, theirs in names:
                sd[f"{p}mlp.{theirs}.weight"] = np.asarray(lp["mlp"][ours]).T
            continue
        sd[p + "mlp.gate.weight"] = lp["gate_weight"]
        for ours, theirs in names:
            for e, ep in enumerate(lp["experts"]):
                sd[f"{p}mlp.experts.{e}.{theirs}.weight"] = \
                    np.asarray(ep[ours]).T
            sd[f"{p}mlp.shared_experts.{theirs}.weight"] = \
                np.asarray(lp["shared"][ours]).T
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("name", ["lite", "q-lora"])
def test_deepseek_v2_params_from_hf_match_jax(name):
    jcfg, tree, tcfg, _ = pair(name)
    sd = _hf_state_dict(tree)
    jtree = jax.device_get(jds.deepseek_v2_params_from_hf(sd, jcfg,
                                                          dtype=jnp.float32))
    got = tds.deepseek_v2_params_from_hf(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg,
        dtype=torch.float32, device="cpu").state_dict()
    want = bridge.deepseek_v2_state_dict(jtree)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("name", ["dense", "group-limited"])
def test_serving_mapping_matches_jax(name):
    jcfg, _, tcfg, model = pair(name)
    serving = tmla.deepseek_serving_params(model, tcfg)
    assert serving.cfg == bridge.llama_config_from(
        jmla.deepseek_serving_config(jcfg))
    assert serving.cfg.num_key_value_heads == 1
    assert serving.cfg.head_dim == tcfg.kv_lora_rank + tcfg.qk_rope_head_dim
    assert serving.layers is model.layers
    assert serving.embed_tokens is model.embed_tokens


def test_latent_pool_and_sizing_match_jax():
    jcfg, _, tcfg, _ = pair("lite")
    jsc = jmla.deepseek_serving_config(jcfg)
    tsc = tmla.deepseek_serving_config(tcfg)
    pool = KVPool(tsc, 96, torch.float32, device="cpu")
    jpool = JKVPool(jsc, 96, jnp.float32)
    assert {n: tuple(t.shape) for n, t in pool.planes.items()} == \
        {n: tuple(a.shape) for n, a in jpool.as_dict().items()} == \
        {"k": (3, 96, 1, 40)}
    assert pool.hbm_bytes() == jpool.hbm_bytes()
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        assert teng.kv_bytes_per_token_layer(tsc, "none", dt) == \
            jeng.kv_bytes_per_token_layer(jsc, "none", jdt)


def _engines(name, **kw):
    jcfg, tree, tcfg, model = pair(name)
    common = dict(max_batch=2, max_seq_len=48, prefill_buckets=(16,),
                  kv_chunk=16, decode_steps=2, num_slots=256, **kw)
    jeng_ = jeng.ServeEngine(jmla.deepseek_serving_params(tree, jcfg),
                             jmla.deepseek_serving_config(jcfg),
                             jeng.EngineConfig(kv_dtype=jnp.float32,
                                               **common))
    serving = tmla.deepseek_serving_params(model, tcfg)
    teng_ = teng.ServeEngine(serving, serving.cfg,
                             teng.EngineConfig(kv_dtype=torch.float32,
                                               **common))
    return teng_, jeng_


@pytest.mark.parametrize("name", ["dense", "group-limited"])
def test_mla_engine_matches_jax_engine(name):
    """Two 14-token prompts in one wave, then the same prompts plus three
    ids (a radix hit on each), 6 greedy tokens a request, on both
    engines: tokens exact, the same prefix hits and pool accounting."""
    teng_, jeng_ = _engines(name)
    rng = np.random.default_rng(13)
    prompts = [[int(x) for x in rng.integers(3, 128, size=14)]
               for _ in range(2)]
    for tag, extra in (("a", []), ("b", [5, 6, 7])):
        def reqs(cls):
            return [cls(rid=f"{tag}{i}", input_ids=p + extra,
                        max_new_tokens=6, eos_ids=(), logprobs=True)
                    for i, p in enumerate(prompts)]

        got, want = drain_engine(teng_, reqs(Request)), \
            drain_engine(jeng_, reqs(JRequest))
        for rid, w in want.items():
            assert got[rid].output_ids == w.output_ids, rid
            assert got[rid].n_cached == w.n_cached, rid
            assert (w.n_cached > 0) == (tag == "b")
    assert teng_.check_memory() == jeng_.check_memory()
    assert set(teng_.runner.rows) == {"k"}


def test_ds_moe_grouped_matches_the_dense_form():
    _, _, tcfg, model = pair("group-limited")
    cfg = tmla.deepseek_serving_config(tcfg)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 5, 64)).astype(np.float32))
    lp = model.layers[1]
    with torch.no_grad():
        got = tmla.ds_moe_grouped(cfg, lp, x)
        want = tmla.ds_moe_dense(cfg, lp, x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _write_dir(path, tree, hf_cfg):
    from safetensors.numpy import save_file
    os.makedirs(path, exist_ok=True)
    save_file(_hf_state_dict(tree), os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f)


def test_load_serving_dir_deepseek_v2(tmp_path):
    """A DeepseekV2ForCausalLM directory loads into the serving model over
    the same weights the HF state dict gives; MLA refuses weight and KV
    quantization, as the reference does."""
    jcfg, tree, tcfg, model = pair("lite")
    path = str(tmp_path / "ds")
    _write_dir(path, tree, dict(HF_BASE, max_position_embeddings=256))
    served, cfg = tconvert.load_serving_dir(path, torch.float32, "cpu")
    assert cfg == tmla.deepseek_serving_config(tcfg)
    want = model.state_dict()
    got = served.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(NotImplementedError):
        tconvert.load_serving_dir(path, torch.float32, "cpu", "int8")
    with pytest.raises(NotImplementedError):
        teng.ServeEngine(served, cfg, teng.EngineConfig(kv_quant="int8"))
