"""The sparse-MoE families in the port against the JAX package, on the CPU.

* ops/moe.py against aurora_tpu/ops/moe.py: `routing_weights` in every
  mode (Mixtral's, softmax_topk with and without renormalization, Grok's
  router softcap), the dense `moe_mlp` and the grouped
  `moe_mlp_grouped` (its `moe_grouped_mm` on the plain twin), the router
  logits, float and int8 experts, `shared_expert_mlp` with and without
  its scalar gate, `load_balancing_loss`, and a forced top-k tie
  (the lower expert index wins on both sides), within 1e-5;
* the converters, for a tiny checkpoint of every MoE family of the
  reference (Mixtral, Qwen2-MoE, Qwen3-MoE, DBRX, Grok-1, DeepSeek v1
  with its dense prefix), written out as the family's HF state dict from
  a seeded numpy generator: `llama_config_from_hf` gives the bridge of
  the JAX config, `llama_params_from_hf` the bridge of the JAX tree bit
  for bit (also layer by layer into W8, against quantizing afterwards),
  `llama_apply` the JAX logits within 1e-4 (float32 on both sides,
  tests/test_torch_train.py's bound);
* both weight quantizers and the serving fusion: the bytes and scales of
  the reference's (int8 experts with one scale per expert and channel,
  DeepSeek v1's dense prefix left float and unfused).

The engines over these checkpoints: tests/test_torch_moe_engine.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models import convert as jconvert
from aurora_tpu.models import llama as jllama
from aurora_tpu.ops import moe as jmoe
from aurora_tpu.serve import engine as jeng
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models import convert as tconvert
from aurora_tpu_torch.models import llama as tllama
from aurora_tpu_torch.ops import moe as tmoe
from aurora_tpu_torch.serve import engine as teng

OP_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
V, D, L, H, HKV, HD = 144, 64, 2, 4, 2, 16
E, K, F = 4, 2, 48


def _n(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# ops/moe.py
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _moe_params(seed=0, shared=True):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    p = {"router": w(D, E), "gate": w(E, D, F), "up": w(E, D, F),
         "down": w(E, F, D)}
    lp = {"moe_shared_gate": w(D, 40), "moe_shared_up": w(D, 40),
          "moe_shared_down": w(40, D), "moe_shared_gate_w": w(D, 1)}
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    return p, lp, x


def _tparams(p, int8=False):
    """The port's params of a JAX params dict; int8: the stacks as the
    reference's W8 expert stacks (values and per-(expert, channel)
    scales), with JAX's dequantized stacks beside them."""
    out = {"router": _t(p["router"])}
    jp = dict(p)
    for n in ("gate", "up", "down"):
        if int8:
            q, s = jax.device_get(jeng._w8(jnp.asarray(p[n])))
            out[n] = tmoe.ExpertStack(_t(q), _t(s[:, 0]))
            jp[n] = np.asarray(q, np.float32) * s
        else:
            out[n] = _t(p[n])
    return out, jp


MODES = [("mixtral", False, 0.0), ("softmax_topk", False, 0.0),
         ("softmax_topk", True, 0.0), ("softmax_topk", False, 2.0),
         ("mixtral", False, 2.0)]


@pytest.mark.parametrize("mode,norm,cap", MODES,
                         ids=["mixtral", "softmax", "softmax-norm",
                              "softmax-cap", "mixtral-cap"])
def test_routing_weights_match_jax(mode, norm, cap):
    p, _, x = _moe_params()
    logits = x @ p["router"]
    wv, wi = jmoe.routing_weights(jnp.asarray(logits), K, mode, norm, cap)
    gv, gi = tmoe.routing_weights(_t(logits), K, mode, norm, cap)
    np.testing.assert_array_equal(gi.numpy(), _n(wi))
    np.testing.assert_allclose(gv.numpy(), _n(wv), **OP_TOL)


@pytest.mark.parametrize("grouped", [False, True], ids=["dense", "grouped"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("mode,norm,cap", MODES,
                         ids=["mixtral", "softmax", "softmax-norm",
                              "softmax-cap", "mixtral-cap"])
def test_moe_mlp_matches_jax(mode, norm, cap, int8, grouped):
    p, _, x = _moe_params()
    tp, jp = _tparams(p, int8)
    jfn = jmoe.moe_mlp_grouped if grouped else jmoe.moe_mlp
    tfn = tmoe.moe_mlp_grouped if grouped else tmoe.moe_mlp
    want, wlog = jfn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), K,
                     return_router_logits=True, router_mode=mode,
                     norm_topk=norm, router_logit_softcap=cap)
    got, glog = tfn(tp, _t(x), K, return_router_logits=True,
                    router_mode=mode, norm_topk=norm,
                    router_logit_softcap=cap)
    np.testing.assert_allclose(got.detach().numpy(), _n(want), **OP_TOL)
    np.testing.assert_allclose(glog.numpy(), _n(wlog), **OP_TOL)


def test_grouped_form_runs_the_plain_twin_on_the_cpu():
    p, _, x = _moe_params()
    tp, _ = _tparams(p)
    before = tmoe.moe_grouped_mm_reference.calls
    tmoe.moe_mlp_grouped(tp, _t(x), K)
    assert tmoe.moe_grouped_mm_reference.calls == before + 3
    assert tmoe.moe_grouped_mm.launches == 0


def test_forced_top_k_tie_picks_the_lower_expert():
    """Equal logits for experts 1 and 3 (and 0 and 2): jax.lax.top_k and
    the port's top-k pick the lower index first, in both modes."""
    logits = np.array([[0.5, 2.0, 0.5, 2.0], [1.0, 1.0, 1.0, 1.0],
                       [3.0, -1.0, 3.0, 3.0]], np.float32)
    for mode in ("mixtral", "softmax_topk"):
        wv, wi = jmoe.routing_weights(jnp.asarray(logits), 2, mode)
        gv, gi = tmoe.routing_weights(_t(logits), 2, mode)
        np.testing.assert_array_equal(gi.numpy(), _n(wi))
        np.testing.assert_array_equal(gi.numpy(),
                                      [[1, 3], [0, 1], [0, 2]])
        np.testing.assert_allclose(gv.numpy(), _n(wv), **OP_TOL)


@pytest.mark.parametrize("gated", [True, False], ids=["qwen", "deepseek"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_shared_expert_matches_jax(gated, int8):
    _, lp, x = _moe_params()
    jlp = {k: v for k, v in lp.items() if gated or k != "moe_shared_gate_w"}
    tlp = {}
    for k, v in jlp.items():
        if k == "moe_shared_gate_w":
            tlp[k] = _t(v)
        elif int8:
            q, s = jax.device_get(jeng._w8(jnp.asarray(v)))
            tlp[k] = tmoe.ExpertStack(_t(q)[None], _t(s))
            jlp[k] = np.asarray(q, np.float32) * s
        else:
            tlp[k] = tmoe.ExpertStack(_t(v)[None])
    want = jmoe.shared_expert_mlp(jax.tree.map(jnp.asarray, jlp),
                                  jnp.asarray(x))
    got = tmoe.shared_expert_mlp(tlp, _t(x))
    np.testing.assert_allclose(got.detach().numpy(), _n(want), **OP_TOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_load_balancing_loss_matches_jax(k):
    p, _, x = _moe_params()
    logits = x @ p["router"]
    want = jmoe.load_balancing_loss(jnp.asarray(logits), k)
    got = tmoe.load_balancing_loss(_t(logits), k)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_grouped_mm_reference_groups():
    """The plain twin over groups with an empty expert and one expert
    that takes every row: each row times its own expert only."""
    rng = np.random.default_rng(3)
    xs = _t(rng.standard_normal((9, 32)).astype(np.float32))
    w = _t(rng.standard_normal((4, 32, 16)).astype(np.float32))
    for offs in ([0, 0, 9, 9, 9], [0, 2, 2, 7, 9]):
        out = tmoe.moe_grouped_mm(xs, w, torch.tensor(offs,
                                                      dtype=torch.int32))
        for e in range(4):
            lo, hi = offs[e], offs[e + 1]
            torch.testing.assert_close(out[lo:hi], xs[lo:hi] @ w[e])


def test_init_moe_params_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe_params(g, 8, 64, 96)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (64, 8), "gate": (8, 64, 96), "up": (8, 64, 96),
        "down": (8, 96, 64)}
    assert abs(p["gate"].std().item() - 0.02) < 2e-3


# ---------------------------------------------------------------------------
# The MoE families' checkpoints
# ---------------------------------------------------------------------------

def _attn(sd, rng, b, bias=False, qk_norm=False, hd=HD):
    for name, shape in (("q", (H * hd, D)), ("k", (HKV * hd, D)),
                        ("v", (HKV * hd, D)), ("o", (D, H * hd))):
        sd[f"{b}.self_attn.{name}_proj.weight"] = rng.standard_normal(shape)
        if bias and name != "o":
            sd[f"{b}.self_attn.{name}_proj.bias"] = rng.standard_normal(
                shape[0])
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            sd[f"{b}.self_attn.{name}.weight"] = rng.standard_normal(hd)


def _top(sd, rng):
    sd["model.embed_tokens.weight"] = rng.standard_normal((V, D))
    sd["model.norm.weight"] = rng.standard_normal(D)
    sd["lm_head.weight"] = rng.standard_normal((V, D))


def _experts(sd, rng, b, names, width=F):
    for e in range(E):
        for n, shape in zip(names, ((width, D), (width, D), (D, width))):
            sd[b.format(e) + n + ".weight"] = rng.standard_normal(shape)


COMMON = dict(vocab_size=V, hidden_size=D, num_attention_heads=H,
              num_key_value_heads=HKV, max_position_embeddings=256,
              rms_norm_eps=1e-5)


def _mixtral(rng, grok=False):
    sd = {}
    _top(sd, rng)
    for i in range(L):
        b = f"model.layers.{i}"
        _attn(sd, rng, b)
        norms = (("pre_attn_norm", "post_attn_norm", "pre_moe_norm",
                  "post_moe_norm") if grok
                 else ("input_layernorm", "post_attention_layernorm"))
        for n in norms:
            sd[f"{b}.{n}.weight"] = rng.standard_normal(D)
        sd[f"{b}.block_sparse_moe.gate.weight"] = rng.standard_normal((E, D))
        _experts(sd, rng, b + ".block_sparse_moe.experts.{}.",
                 ("w1", "w3", "w2"))
    cfg = dict(COMMON, model_type="grok-1" if grok else "mixtral",
               intermediate_size=F, num_hidden_layers=L,
               num_local_experts=E, num_experts_per_tok=K,
               rope_theta=1e6)
    if grok:
        cfg.update(head_dim=HD, embedding_multiplier_scale=3.0,
                   output_multiplier_scale=0.5)
    return cfg, sd


def _qwen_moe(rng, v3=False):
    sd = {}
    _top(sd, rng)
    for i in range(L):
        b = f"model.layers.{i}"
        _attn(sd, rng, b, bias=not v3, qk_norm=v3)
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{b}.{n}.weight"] = rng.standard_normal(D)
        sd[f"{b}.mlp.gate.weight"] = rng.standard_normal((E, D))
        _experts(sd, rng, b + ".mlp.experts.{}.",
                 ("gate_proj", "up_proj", "down_proj"))
        if not v3:
            for n, shape in (("gate_proj", (80, D)), ("up_proj", (80, D)),
                             ("down_proj", (D, 80))):
                sd[f"{b}.mlp.shared_expert.{n}.weight"] = \
                    rng.standard_normal(shape)
            sd[f"{b}.mlp.shared_expert_gate.weight"] = \
                rng.standard_normal((1, D))
    cfg = dict(COMMON, model_type="qwen3_moe" if v3 else "qwen2_moe",
               intermediate_size=128, moe_intermediate_size=F,
               num_hidden_layers=L, num_experts=E, num_experts_per_tok=K,
               norm_topk_prob=v3, decoder_sparse_step=1, mlp_only_layers=[],
               rms_norm_eps=1e-6)
    if v3:
        cfg["head_dim"] = HD
    else:
        cfg["shared_expert_intermediate_size"] = 80
    return cfg, sd


def _dbrx(rng):
    hd = D // H
    sd = {"transformer.wte.weight": rng.standard_normal((V, D)),
          "transformer.norm_f.weight": rng.standard_normal(D),
          "lm_head.weight": rng.standard_normal((V, D))}
    for i in range(L):
        b = f"transformer.blocks.{i}"
        sd[f"{b}.norm_attn_norm.attn.Wqkv.weight"] = rng.standard_normal(
            ((H + 2 * HKV) * hd, D))
        sd[f"{b}.norm_attn_norm.attn.out_proj.weight"] = \
            rng.standard_normal((D, H * hd))
        for n in ("norm_1", "norm_2"):
            sd[f"{b}.norm_attn_norm.{n}.weight"] = rng.standard_normal(D)
        sd[f"{b}.ffn.router.layer.weight"] = rng.standard_normal((E, D))
        for n in ("w1", "v1", "w2"):
            sd[f"{b}.ffn.experts.mlp.{n}"] = rng.standard_normal((E * F, D))
    cfg = {"model_type": "dbrx", "d_model": D, "n_heads": H, "n_layers": L,
           "max_seq_len": 256, "vocab_size": V,
           "attn_config": {"kv_n_heads": HKV, "clip_qkv": 6.0,
                           "rope_theta": 10000.0},
           "ffn_config": {"ffn_hidden_size": F, "moe_num_experts": E,
                          "moe_top_k": K,
                          "moe_normalize_expert_weights": 1.0}}
    return cfg, sd


def _deepseek_v1(rng):
    sd = {}
    _top(sd, rng)
    for i in range(3):
        b = f"model.layers.{i}"
        _attn(sd, rng, b)
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{b}.{n}.weight"] = rng.standard_normal(D)
        if i == 0:
            for n, shape in (("gate_proj", (128, D)), ("up_proj", (128, D)),
                             ("down_proj", (D, 128))):
                sd[f"{b}.mlp.{n}.weight"] = rng.standard_normal(shape)
            continue
        sd[f"{b}.mlp.gate.weight"] = rng.standard_normal((E, D))
        _experts(sd, rng, b + ".mlp.experts.{}.",
                 ("gate_proj", "up_proj", "down_proj"))
        for n, shape in (("gate_proj", (F, D)), ("up_proj", (F, D)),
                         ("down_proj", (D, F))):
            sd[f"{b}.mlp.shared_experts.{n}.weight"] = \
                rng.standard_normal(shape)
    cfg = dict(COMMON, model_type="deepseek", intermediate_size=128,
               moe_intermediate_size=F, num_hidden_layers=3,
               n_routed_experts=E, n_shared_experts=1,
               num_experts_per_tok=K, norm_topk_prob=True,
               first_k_dense_replace=1, moe_layer_freq=1, rms_norm_eps=1e-6)
    return cfg, sd


FAMILIES = {"mixtral": _mixtral, "qwen2_moe": _qwen_moe,
            "qwen3_moe": functools.partial(_qwen_moe, v3=True),
            "dbrx": _dbrx, "grok": functools.partial(_mixtral, grok=True),
            "deepseek": _deepseek_v1}


def _scaled(sd):
    """Norm weights (a module named *norm*) 1 + 0.1·x, the rest 0.1·x, in
    fp32."""
    out = {}
    for k, v in sd.items():
        if "norm" in k.split(".")[-2].lower():
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[k] = v.astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def pair(family):
    """(HF config, JAX config, JAX tree, HF state dict, port model)."""
    rng = np.random.default_rng(sorted(FAMILIES).index(family) + 11)
    hf_cfg, sd = FAMILIES[family](rng)
    sd = _scaled(sd)
    jcfg = jconvert.llama_config_from_hf(hf_cfg)
    tree = jax.device_get(jconvert.llama_params_from_hf(sd, jcfg,
                                                         dtype=jnp.float32))
    tcfg = tconvert.llama_config_from_hf(hf_cfg)
    model = tconvert.llama_params_from_hf(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg,
        dtype=torch.float32, device="cpu")
    return hf_cfg, jcfg, tree, sd, model


def _assert_same_state(got_model, want_sd):
    got = got_model.state_dict()
    assert got.keys() == want_sd.keys()
    for k, v in want_sd.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_moe_family_converts_like_jax(family):
    _, jcfg, tree, _, model = pair(family)
    assert model.cfg == bridge.llama_config_from(jcfg)
    assert model.cfg.num_experts == E
    _assert_same_state(model, bridge.llama_state_dict(tree, model.cfg))
    # the bridge builds the same modules from the JAX tree
    _assert_same_state(bridge.llama_from_params(tree, model.cfg,
                                                device="cpu",
                                                dtype=torch.float32),
                       bridge.llama_state_dict(tree, model.cfg))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_moe_family_llama_apply_matches_jax(family):
    _, jcfg, tree, _, model = pair(family)
    ids = np.random.default_rng(7).integers(3, V, size=(2, 20))
    want, _ = jllama.llama_apply(tree, jcfg, input_ids=jnp.asarray(ids))
    got = tllama.llama_apply(model, model.cfg,
                             input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), _n(want), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("family", ["qwen2_moe", "deepseek", "grok"])
def test_moe_weight_quantizers_match_jax(family, bits):
    """quantize_weights_int8 / int4 then fuse_serving_weights: the
    reference's bytes and scales (its int8 expert stacks with
    [E, 1, out] scales, the shared expert as one expert, the router and
    shared gate float, DeepSeek v1's dense prefix float and per-name)."""
    _, _, tree, _, model = pair(family)
    jq = jeng.quantize_weights_int8 if bits == 8 \
        else jeng.quantize_weights_int4
    tq = teng.quantize_weights_int8 if bits == 8 \
        else teng.quantize_weights_int4
    jf = jax.device_get(jeng.fuse_serving_weights(jq(dict(tree))))
    got = teng.fuse_serving_weights(tq(model))
    _assert_same_state(got, bridge.llama_state_dict(jf, model.cfg))
    last = got.layers[-1]
    assert last.moe_gate.weight.dtype == torch.int8
    assert last.moe_router.dtype == torch.float32
    assert teng.weight_quant_of(got) == ("int8" if bits == 8 else "int4")
    if family == "deepseek":
        assert isinstance(got.layers[0].gate, torch.nn.Linear)


@pytest.mark.parametrize("weight_quant", ["int8", "int4"])
def test_layer_by_layer_load_matches_quantizing_after(weight_quant):
    """llama_params_from_hf(weight_quant=) builds each layer, quantizes it
    and drops it (serve/engine.py build_quantized): the same tensors as
    loading the float model and quantizing it."""
    _, _, _, sd, model = pair("qwen2_moe")
    got = tconvert.llama_params_from_hf(
        {k: torch.from_numpy(v) for k, v in sd.items()}, model.cfg,
        dtype=torch.float32, device="cpu", weight_quant=weight_quant)
    want = teng._QUANTIZE[weight_quant](model)
    _assert_same_state(got, want.state_dict())


def test_refused_moe_configs_raise():
    """What the reference refuses (it asserts) raises NotImplementedError:
    Qwen-MoE with dense layers between sparse ones, DeepSeek v1 with
    moe_layer_freq 2, DBRX's expert-weight norm 2."""
    qwen, _ = _qwen_moe(np.random.default_rng(0))
    dbrx, _ = _dbrx(np.random.default_rng(0))
    ds, _ = _deepseek_v1(np.random.default_rng(0))
    for cfg in (dict(qwen, decoder_sparse_step=2),
                dict(qwen, mlp_only_layers=[1]),
                dict(ds, moe_layer_freq=2),
                dict(dbrx, ffn_config=dict(
                    dbrx["ffn_config"], moe_normalize_expert_weights=2.0))):
        with pytest.raises(NotImplementedError):
            tconvert.llama_config_from_hf(cfg)


def test_auto_engine_config_sets_aside_the_moe_workspace():
    """auto_engine_config takes a MoE config's extend workspace (the
    grouped form's rows at the largest wave, moe_workspace_bytes) off the
    budget before it sizes the rows and the pool; a dense config sets
    nothing aside."""
    _, _, _, _, model = pair("mixtral")
    cfg = model.cfg
    base = teng.EngineConfig(max_batch=2, num_slots=0, max_seq_len=64,
                             kv_chunk=16, prefill_buckets=(16, 32))
    ws = teng.moe_workspace_bytes(cfg, base)
    copies = 2 * 32 * K
    assert ws == copies * (2 * D + 6 * F + 12 * D)
    dense = dataclasses.replace(cfg, num_experts=0)
    assert teng.moe_workspace_bytes(dense, base) == 0
    budget = 10 ** 8
    got = teng.auto_engine_config(cfg, base, budget_bytes=budget)
    want = teng.auto_engine_config(dense, base, budget_bytes=budget - ws)
    assert got.num_slots == want.num_slots < teng.auto_engine_config(
        dense, base, budget_bytes=budget).num_slots
