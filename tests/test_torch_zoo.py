"""The dense model zoo in the port against the JAX package, on the CPU.

Every dense family of the reference's converter: a tiny checkpoint (a
HF model built from its transformers config where transformers has the
class, else the family's own key layout written out from llama-shaped
weights: InternLM2's group-interleaved wqkv, Qwen v1's c_attn, EXAONE's
transformer.h names, ChatGLM's query_key_value, MiniCPM's scalings),
every tensor redrawn from a seeded numpy generator (biases and norm
weights included, so that each knob acts). For each family:

* `llama_config_from_hf` gives the config the bridge makes of the JAX
  one, and `llama_params_from_hf` the parameters the bridge makes of the
  JAX tree, bit for bit;
* `llama_apply` gives the JAX `llama_apply`'s logits within 1e-4
  (tests/test_torch_train.py's bound; float32 on both sides);
* the port's ServeEngine gives the JAX ServeEngine's greedy tokens
  (tests/test_torch_zoo_engine.py, over these checkpoints): exactly
  with fp32 KV, and under the near-tie contract of
  tests/test_torch_engine_quant.py (`assert_near_tie_parity`) with int8
  and packed int4 KV. The JAX kernels run in interpret mode.

The MoE and MLA families are tested in tests/test_torch_moe.py and
tests/test_torch_mla.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models import convert as jconvert
from aurora_tpu.models import llama as jllama
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models import convert as tconvert
from aurora_tpu_torch.models import llama as tllama

TOL = dict(rtol=1e-4, atol=1e-4)
V, D, I, L, H, HKV = 144, 64, 128, 2, 4, 2
COMMON = dict(vocab_size=V, hidden_size=D, intermediate_size=I,
              num_hidden_layers=L, num_attention_heads=H,
              num_key_value_heads=HKV, max_position_embeddings=256,
              attn_implementation="eager")


def _hf(cls_name, **kw):
    """A transformers model of the family, its config dict and state dict
    (numpy float32)."""
    import transformers
    torch.manual_seed(0)
    cfg = getattr(transformers, cls_name + "Config")(**kw)
    hf = getattr(transformers, cls_name + "ForCausalLM")(cfg).eval()
    sd = {k: v.detach().float().numpy() for k, v in hf.state_dict().items()}
    return cfg.to_dict(), sd


def _llama_weights(rng, hkv=HKV, hd=D // H, bias=False):
    """Llama-shaped weights of L layers in HF's [out, in] layout."""
    nq, nkv = H * hd, hkv * hd
    w = {"embed": rng.standard_normal((V, D)), "norm": np.ones(D),
         "head": rng.standard_normal((V, D))}
    for i in range(L):
        for name, shape in (("q", (nq, D)), ("k", (nkv, D)), ("v", (nkv, D)),
                            ("o", (D, nq)), ("gate", (I, D)), ("up", (I, D)),
                            ("down", (D, I)), ("n1", (D,)), ("n2", (D,))):
            w[f"{i}.{name}"] = rng.standard_normal(shape)
        if bias:
            for name, n in (("qb", nq), ("kb", nkv), ("vb", nkv)):
                w[f"{i}.{name}"] = rng.standard_normal(n)
    return w


def _internlm2():
    w, qpk, hd = _llama_weights(np.random.default_rng(1)), H // HKV, D // H
    sd = {"model.tok_embeddings.weight": w["embed"],
          "model.norm.weight": w["norm"], "output.weight": w["head"]}
    for i in range(L):
        q = w[f"{i}.q"].reshape(HKV, qpk, hd, D)
        k = w[f"{i}.k"].reshape(HKV, 1, hd, D)
        v = w[f"{i}.v"].reshape(HKV, 1, hd, D)
        pre = f"model.layers.{i}."
        sd[pre + "attention.wqkv.weight"] = np.concatenate(
            [q, k, v], axis=1).reshape(-1, D)
        for a, b in (("attention.wo", "o"), ("feed_forward.w1", "gate"),
                     ("feed_forward.w3", "up"), ("feed_forward.w2", "down"),
                     ("attention_norm", "n1"), ("ffn_norm", "n2")):
            sd[pre + a + ".weight"] = w[f"{i}.{b}"]
    cfg = dict(model_type="internlm2", vocab_size=V, hidden_size=D,
               intermediate_size=I, num_hidden_layers=L,
               num_attention_heads=H, num_key_value_heads=HKV,
               rms_norm_eps=1e-5, max_position_embeddings=256, bias=False)
    return cfg, sd


def _qwen_v1():
    w = _llama_weights(np.random.default_rng(2), hkv=H, bias=True)
    sd = {"transformer.wte.weight": w["embed"],
          "transformer.ln_f.weight": w["norm"], "lm_head.weight": w["head"]}
    for i in range(L):
        pre = f"transformer.h.{i}."
        sd[pre + "attn.c_attn.weight"] = np.concatenate(
            [w[f"{i}.q"], w[f"{i}.k"], w[f"{i}.v"]])
        sd[pre + "attn.c_attn.bias"] = np.concatenate(
            [w[f"{i}.qb"], w[f"{i}.kb"], w[f"{i}.vb"]])
        for a, b in (("attn.c_proj", "o"), ("mlp.w2", "gate"),
                     ("mlp.w1", "up"), ("mlp.c_proj", "down"),
                     ("ln_1", "n1"), ("ln_2", "n2")):
            sd[pre + a + ".weight"] = w[f"{i}.{b}"]
    cfg = dict(model_type="qwen", vocab_size=V, hidden_size=D,
               intermediate_size=2 * I, num_hidden_layers=L,
               num_attention_heads=H, layer_norm_epsilon=1e-6,
               rotary_emb_base=10000.0, seq_length=256)
    return cfg, sd


def _exaone():
    w = _llama_weights(np.random.default_rng(3))
    sd = {"transformer.wte.weight": w["embed"],
          "transformer.ln_f.weight": w["norm"], "lm_head.weight": w["head"]}
    for i in range(L):
        pre = f"transformer.h.{i}."
        for a, b in (("attn.attention.q_proj", "q"),
                     ("attn.attention.k_proj", "k"),
                     ("attn.attention.v_proj", "v"),
                     ("attn.attention.out_proj", "o"), ("mlp.c_fc_0", "gate"),
                     ("mlp.c_fc_1", "up"), ("mlp.c_proj", "down"),
                     ("ln_1", "n1"), ("ln_2", "n2")):
            sd[pre + a + ".weight"] = w[f"{i}.{b}"]
    cfg = dict(model_type="exaone", vocab_size=V, hidden_size=D,
               intermediate_size=I, num_layers=L, num_attention_heads=H,
               num_key_value_heads=HKV, layer_norm_epsilon=1e-5,
               activation_function="silu", max_position_embeddings=256)
    return cfg, sd


def _chatglm():
    w = _llama_weights(np.random.default_rng(4), bias=True)
    sd = {"transformer.embedding.word_embeddings.weight": w["embed"],
          "transformer.encoder.final_layernorm.weight": w["norm"],
          "transformer.output_layer.weight": w["head"]}
    for i in range(L):
        pre = f"transformer.encoder.layers.{i}."
        sd[pre + "self_attention.query_key_value.weight"] = np.concatenate(
            [w[f"{i}.q"], w[f"{i}.k"], w[f"{i}.v"]])
        sd[pre + "self_attention.query_key_value.bias"] = np.concatenate(
            [w[f"{i}.qb"], w[f"{i}.kb"], w[f"{i}.vb"]])
        sd[pre + "mlp.dense_h_to_4h.weight"] = np.concatenate(
            [w[f"{i}.gate"], w[f"{i}.up"]])
        for a, b in (("self_attention.dense", "o"),
                     ("mlp.dense_4h_to_h", "down"),
                     ("input_layernorm", "n1"),
                     ("post_attention_layernorm", "n2")):
            sd[pre + a + ".weight"] = w[f"{i}.{b}"]
    cfg = dict(model_type="chatglm", vocab_size=V, hidden_size=D,
               ffn_hidden_size=I, num_layers=L, num_attention_heads=H,
               multi_query_attention=True, multi_query_group_num=HKV,
               kv_channels=D // H, layernorm_epsilon=1e-5, rope_ratio=1.0,
               seq_length=256, add_qkv_bias=True)
    return cfg, sd


def _minicpm():
    w = _llama_weights(np.random.default_rng(5))
    sd = {"model.embed_tokens.weight": w["embed"],
          "model.norm.weight": w["norm"], "lm_head.weight": w["head"]}
    for i in range(L):
        pre = f"model.layers.{i}."
        for a, b in (("self_attn.q_proj", "q"), ("self_attn.k_proj", "k"),
                     ("self_attn.v_proj", "v"), ("self_attn.o_proj", "o"),
                     ("mlp.gate_proj", "gate"), ("mlp.up_proj", "up"),
                     ("mlp.down_proj", "down"), ("input_layernorm", "n1"),
                     ("post_attention_layernorm", "n2")):
            sd[pre + a + ".weight"] = w[f"{i}.{b}"]
    cfg = dict(model_type="minicpm", vocab_size=V, hidden_size=D,
               intermediate_size=I, num_hidden_layers=L,
               num_attention_heads=H, num_key_value_heads=HKV,
               rms_norm_eps=1e-5, max_position_embeddings=256,
               scale_emb=12.0, scale_depth=1.4, dim_model_base=256)
    return cfg, sd


FAMILIES = {
    "qwen2": lambda: _hf("Qwen2", **COMMON, tie_word_embeddings=False),
    "qwen3": lambda: _hf("Qwen3", **COMMON, head_dim=24,
                         tie_word_embeddings=False),
    "gemma": lambda: _hf("Gemma", **COMMON, head_dim=24, rms_norm_eps=1e-6,
                         hidden_activation="gelu_pytorch_tanh",
                         tie_word_embeddings=True),
    "phi3": lambda: _hf("Phi3", **dict(COMMON, hidden_size=96 * 2,
                                       num_attention_heads=2,
                                       num_key_value_heads=1),
                        pad_token_id=0, tie_word_embeddings=False),
    "stablelm": lambda: _hf("StableLm", **COMMON, partial_rotary_factor=0.25,
                            use_qkv_bias=True, layer_norm_eps=1e-5,
                            tie_word_embeddings=False),
    "olmo": lambda: _hf("Olmo", **COMMON, clip_qkv=0.4,
                        tie_word_embeddings=False),
    "glm": lambda: _hf("Glm", **COMMON, head_dim=16,
                       partial_rotary_factor=0.5, attention_bias=True,
                       pad_token_id=0, tie_word_embeddings=False),
    "starcoder2": lambda: _hf("Starcoder2", **COMMON, use_bias=True,
                              norm_epsilon=1e-5, sliding_window=None,
                              hidden_act="gelu_pytorch_tanh",
                              tie_word_embeddings=False),
    "cohere": lambda: _hf("Cohere", **COMMON, use_qk_norm=True,
                          logit_scale=0.5, layer_norm_eps=1e-5,
                          tie_word_embeddings=True),
    "gpt_bigcode": lambda: _hf("GPTBigCode", vocab_size=V, n_embd=D,
                               n_inner=I, n_layer=L, n_head=H,
                               n_positions=256, multi_query=True,
                               activation_function="gelu_pytorch_tanh",
                               attn_implementation="eager",
                               tie_word_embeddings=True),
    "internlm2": _internlm2, "qwen": _qwen_v1, "exaone": _exaone,
    "chatglm": _chatglm, "minicpm": _minicpm,
}


def _redraw(sd, rng):
    """Every tensor redrawn: norm weights 1 + N(0, 0.1²), biases
    N(0, 0.1²), the rest N(0, 0.05²) (tied heads stay tied)."""
    out = {}
    for k, v in sorted(sd.items()):
        name = k.lower()
        if "norm" in name or ".ln_" in name or "ln_f" in name:
            x = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif name.endswith("bias"):
            x = 0.1 * rng.standard_normal(v.shape)
        else:
            x = 0.05 * rng.standard_normal(v.shape)
        out[k] = x.astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _pair(family):
    """(HF config, JAX config, JAX tree, port model) of a family."""
    hf_cfg, sd = FAMILIES[family]()
    sd = _redraw(sd, np.random.default_rng(sorted(FAMILIES).index(family)))
    jcfg = jconvert.llama_config_from_hf(hf_cfg)
    tree = jax.device_get(jconvert.llama_params_from_hf(sd, jcfg,
                                                         dtype=jnp.float32))
    tcfg = tconvert.llama_config_from_hf(hf_cfg)
    model = tconvert.llama_params_from_hf(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg,
        dtype=torch.float32, device="cpu")
    return hf_cfg, jcfg, tree, model


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_converts_like_jax(family):
    _, jcfg, tree, model = _pair(family)
    assert model.cfg == bridge.llama_config_from(jcfg)
    want = bridge.llama_state_dict(tree, model.cfg)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_llama_apply_matches_jax(family):
    _, jcfg, tree, model = _pair(family)
    ids = np.random.default_rng(7).integers(3, V, size=(2, 20))
    want, _ = jllama.llama_apply(tree, jcfg, input_ids=jnp.asarray(ids))
    got = tllama.llama_apply(model, model.cfg, input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("family", ["qwen2", "gemma", "starcoder2",
                                    "cohere", "gpt_bigcode"])
def test_family_weight_quantizers_match_jax(family, bits):
    """quantize_weights_int8 / int4 then fuse_serving_weights over a
    family's model: the bytes and scales of the reference's over its tree
    (the bridge of its tree), the qkv biases fused into qkv_bias, biases
    and norms kept in the model's dtype and shared, and a tied head left
    the embedding (no int8 head)."""
    from aurora_tpu.serve import engine as jeng
    from aurora_tpu_torch.serve import engine as teng
    _, jcfg, tree, model = _pair(family)
    jquant = jeng.quantize_weights_int8 if bits == 8 \
        else jeng.quantize_weights_int4
    tquant = teng.quantize_weights_int8 if bits == 8 \
        else teng.quantize_weights_int4
    jf = jax.device_get(jeng.fuse_serving_weights(jquant(dict(tree))))
    tq = teng.fuse_serving_weights(tquant(model))
    want = bridge.llama_state_dict(jf, model.cfg)
    got = tq.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    assert tq.embed_tokens is model.embed_tokens
    assert hasattr(tq, "lm_head") != model.cfg.tie_word_embeddings
    for name in tllama.extras_of(tq):
        p = getattr(tq, name, None) if name in tllama.TOP_EXTRAS \
            else getattr(tq.layers[0], name)
        assert p.dtype == torch.float32, name


def test_stablelm_3b_head_dim_is_one_the_kernels_take():
    """stabilityai/stablelm-3b-4e1t's config (transformers.StableLmConfig's
    defaults) converts to head_dim 80, which the ragged kernels run on
    their 96-wide kernel; chip_smoke.py serves that config as written out
    in STABLELM_3B, which holds the same values."""
    import importlib.util
    import os

    import transformers

    from aurora_tpu_torch.ops.pallas import ragged_attention as tra
    hf = transformers.StableLmConfig().to_dict()
    cfg = tconvert.llama_config_from_hf(hf)
    hd = cfg.hidden_size // cfg.num_attention_heads
    assert (hd, cfg.head_dim) == (80, 80)
    assert tra.kernel_head_width(hd) == 96
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {k: hf[k] for k in smoke.STABLELM_3B} == smoke.STABLELM_3B
    assert tconvert.llama_config_from_hf(smoke.STABLELM_3B) == cfg


def test_phi3_mini_config_reads_alike_in_both_packages():
    """chip_smoke.py's PHI3_MINI (microsoft/Phi-3-mini-4k-instruct's
    config, which `[serve-phi3-mini-*]` serves whole) through both
    packages' llama_config_from_hf: head_dim 96 (the ragged kernels'
    width 96, unpadded), MHA, the window of 2047, and every field the
    two configs share equal. No weights, no compile."""
    import dataclasses
    import importlib.util
    import os

    from aurora_tpu_torch.ops.pallas import ragged_attention as tra
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tcfg = tconvert.llama_config_from_hf(dict(smoke.PHI3_MINI))
    jcfg = jconvert.llama_config_from_hf(dict(smoke.PHI3_MINI))
    hd = tcfg.hidden_size // tcfg.num_attention_heads
    assert (hd, tcfg.head_dim, tra.kernel_head_width(hd)) == (96, 96, 96)
    assert tcfg.num_attention_heads == tcfg.num_key_value_heads == 32
    assert tcfg.sliding_window == 2047
    assert (tcfg.hidden_size, tcfg.num_hidden_layers,
            tcfg.intermediate_size, tcfg.vocab_size) == (3072, 32, 8192,
                                                         32064)
    shared = {f.name for f in dataclasses.fields(jcfg)} & {
        f.name for f in dataclasses.fields(tcfg)}
    assert {"hidden_size", "num_attention_heads", "num_key_value_heads",
            "sliding_window", "rms_norm_eps", "rope_theta"} <= shared
    for name in shared:
        assert getattr(tcfg, name) == getattr(jcfg, name), name
