"""InternVL in the port (aurora_tpu_torch/models/internvl.py and
serve/multimodal.py `InternVLServing`) against the JAX package's, float32
on the CPU, at a tiny config: InternViT 2 layers at 56 px (hidden 32, 4
heads, 16 patches → 4 visual tokens after the pixel shuffle) and a
Qwen2-like decoder of 2 layers (hidden 64, GQA 4/2, qkv biases). One
numpy state dict in InternVLForConditionalGeneration's key names feeds
both packages' converters. Two vision layouts, as tests/test_internvl.py
has: "layer_norm" (q/k/v biases, mean pooling: InternViT-300M's) and
"qk_rms" (rms_norm blocks, the full-width q/k RMSNorm, no q/k/v biases,
a final LayerNorm: InternViT-6B's).

Tolerances: exact for the converters, the bridge and the pixel shuffle
(moves only); 1e-4 for InternViT, the image features, the logits and the
fused embeddings (fp32 summation order over a few layers); the served
tokens under tests/test_torch_engine_quant.py's near-tie contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models import internvl as jivl
from aurora_tpu.models.convert import llama_config_from_hf as j_llama_cfg
from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.engine import ServeEngine as JServeEngine
from aurora_tpu.serve.multimodal import InternVLServing as JServing
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu.utils.constants import IMAGE_TOKEN_INDEX
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models import internvl as tivl
from aurora_tpu_torch.models.convert import llama_config_from_hf
from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
from aurora_tpu_torch.serve.multimodal import InternVLServing
from aurora_tpu_torch.serve.scheduler import Request

from test_torch_engine_quant import assert_near_tie_parity
from utils import drain_engine

TOL = dict(rtol=1e-4, atol=1e-4)
D_V, I_V, D, I, V = 32, 64, 64, 128, 256

TEXT = {"model_type": "qwen2", "vocab_size": V, "hidden_size": D,
        "intermediate_size": I, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 128, "rms_norm_eps": 1e-6,
        "rope_theta": 1e6, "tie_word_embeddings": False}
VISION = {"layer_norm": dict(norm_type="layer_norm", attention_bias=True,
                             use_qk_norm=False, use_mean_pooling=True),
          "qk_rms": dict(norm_type="rms_norm", attention_bias=False,
                         use_qk_norm=True, use_mean_pooling=False)}


class ByteTok:
    """ids 3 + byte % 200, BOS 1: within the tiny vocab."""
    eos_token_id = 2

    def encode(self, text, add_special_tokens=True):
        ids = [3 + b % 200 for b in text.encode()]
        return [1] + ids if add_special_tokens else ids


def _hf_state_dict(vcfg, rng):
    """InternVLForConditionalGeneration names, random fp32 values (norm
    scales and LayerScale near their trained magnitudes)."""
    p = 14
    shapes = {}
    vt, e = "model.vision_tower.", "model.vision_tower.embeddings."
    shapes[e + "patch_embeddings.projection.weight"] = (D_V, 3, p, p)
    shapes[e + "patch_embeddings.projection.bias"] = (D_V,)
    shapes[e + "cls_token"] = (1, 1, D_V)
    shapes[e + "position_embeddings"] = (1, 17, D_V)
    for i in range(2):
        b = f"{vt}encoder.layer.{i}."
        for n in ("layernorm_before", "layernorm_after"):
            shapes[b + n + ".weight"] = (D_V,)
            if vcfg["norm_type"] == "layer_norm":
                shapes[b + n + ".bias"] = (D_V,)
        for n in "qkv":
            shapes[b + f"attention.{n}_proj.weight"] = (D_V, D_V)
            if vcfg["attention_bias"]:
                shapes[b + f"attention.{n}_proj.bias"] = (D_V,)
        if vcfg["use_qk_norm"]:
            shapes[b + "attention.q_norm.weight"] = (D_V,)
            shapes[b + "attention.k_norm.weight"] = (D_V,)
        shapes[b + "attention.projection_layer.weight"] = (D_V, D_V)
        shapes[b + "attention.projection_layer.bias"] = (D_V,)
        shapes[b + "mlp.fc1.weight"] = (I_V, D_V)
        shapes[b + "mlp.fc1.bias"] = (I_V,)
        shapes[b + "mlp.fc2.weight"] = (D_V, I_V)
        shapes[b + "mlp.fc2.bias"] = (D_V,)
        shapes[b + "lambda_1"] = (D_V,)
        shapes[b + "lambda_2"] = (D_V,)
    if not vcfg["use_mean_pooling"]:
        shapes[vt + "layernorm.weight"] = (D_V,)
        shapes[vt + "layernorm.bias"] = (D_V,)
    pj = "model.multi_modal_projector."
    shapes.update({pj + "layer_norm.weight": (4 * D_V,),
                   pj + "layer_norm.bias": (4 * D_V,),
                   pj + "linear_1.weight": (D, 4 * D_V),
                   pj + "linear_1.bias": (D,),
                   pj + "linear_2.weight": (D, D), pj + "linear_2.bias": (D,)})
    lm = "model.language_model."
    shapes.update({lm + "embed_tokens.weight": (V, D), lm + "norm.weight":
                   (D,), "lm_head.weight": (V, D)})
    for i in range(2):
        b = f"{lm}layers.{i}."
        shapes.update({b + "input_layernorm.weight": (D,),
                       b + "post_attention_layernorm.weight": (D,),
                       b + "self_attn.o_proj.weight": (D, D),
                       b + "mlp.gate_proj.weight": (I, D),
                       b + "mlp.up_proj.weight": (I, D),
                       b + "mlp.down_proj.weight": (D, I)})
        for n, out in (("q", D), ("k", D // 2), ("v", D // 2)):
            shapes[b + f"self_attn.{n}_proj.weight"] = (out, D)
            shapes[b + f"self_attn.{n}_proj.bias"] = (out,)
    sd = {}
    for k, s in shapes.items():
        x = rng.standard_normal(s)
        if "norm" in k and k.endswith("weight"):
            x = 1.0 + 0.1 * x
        elif "lambda" in k:
            x = 0.1 + 0.05 * x
        else:
            x = (0.1 if k.endswith("bias") else 0.05) * x
        sd[k] = x.astype(np.float32)
    return sd


@pytest.fixture(scope="module", params=sorted(VISION))
def pair(request):
    vcfg = {"hidden_size": D_V, "intermediate_size": I_V,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "image_size": [56, 56], "patch_size": [14, 14],
            "layer_norm_eps": 1e-6, "layer_scale_init_value": 0.1,
            **VISION[request.param]}
    sd = _hf_state_dict(vcfg, np.random.default_rng(
        sorted(VISION).index(request.param)))
    jcfg = jivl.InternVLConfig(vision=jivl.internvit_config_from_hf(vcfg),
                               text=j_llama_cfg(TEXT), downsample_ratio=0.5)
    tcfg = tivl.InternVLConfig(vision=tivl.internvit_config_from_hf(vcfg),
                               text=llama_config_from_hf(TEXT),
                               downsample_ratio=0.5)
    jtree = jivl.internvl_params_from_hf(sd, jcfg, dtype=jnp.float32)
    model = tivl.internvl_params_from_hf(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg,
        dtype=torch.float32, device="cpu")
    return jcfg, jtree, model, sd


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _pixels(seed, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, 56, 56)).astype(np.float32)


def test_configs_match_jax(pair):
    jcfg, _, model, _ = pair
    assert model.cfg == bridge.internvl_config_from(jcfg)
    assert model.cfg.n_visual_tokens == jcfg.n_visual_tokens == 4


def test_converters_agree_bit_for_bit(pair):
    """The port's internvl_params_from_hf and the bridge of the JAX
    converter's tree, from one numpy state dict: the same tensors."""
    jcfg, jtree, model, _ = pair
    want = bridge.internvl_from_params(
        jax.device_get(jtree), bridge.internvl_config_from(jcfg),
        device="cpu", dtype=torch.float32).state_dict()
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_internvit_encode(pair):
    jcfg, jtree, model, sd = pair
    px = _pixels(1)
    want = jivl.internvit_encode(jtree["vision"], jnp.asarray(px),
                                 jcfg.vision)
    # the vision tower alone through its own converter
    vit = tivl.internvit_params_from_hf(
        {k[len("model.vision_tower."):]: torch.from_numpy(v)
         for k, v in sd.items() if k.startswith("model.vision_tower.")},
        model.cfg.vision, device="cpu")
    for m in (model.vision, vit):
        got = tivl.internvit_encode(m, torch.from_numpy(px))
        assert tuple(got.shape) == (2, 17, D_V)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_pixel_shuffle():
    x = np.random.default_rng(2).standard_normal((2, 6, 6, 8)).astype(
        np.float32)
    want = jivl.pixel_shuffle(jnp.asarray(x), 0.5)
    got = tivl.pixel_shuffle(torch.from_numpy(x), 0.5)
    assert tuple(got.shape) == want.shape == (2, 3, 3, 32)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_image_features(pair):
    jcfg, jtree, model, _ = pair
    px = _pixels(3)
    want = jivl.internvl_image_features(jtree, jcfg, jnp.asarray(px))
    got = tivl.internvl_image_features(model, torch.from_numpy(px))
    assert tuple(got.shape) == (2, 4, D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_composite_logits(pair):
    """One image's marker in a batch of one, expanded to 4 positions."""
    jcfg, jtree, model, _ = pair
    px = _pixels(4, 1)
    ids = np.random.default_rng(4).integers(3, 240, size=10)
    ids = np.concatenate([ids[:4], [IMAGE_TOKEN_INDEX], ids[4:]])[None]
    want = jivl.internvl_forward(jtree, jcfg, jnp.asarray(ids),
                                 pixel_values=jnp.asarray(px))
    got = tivl.internvl_forward(model, torch.from_numpy(ids),
                                pixel_values=torch.from_numpy(px))
    assert tuple(got.shape) == (1, 14, V)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_text_only_logits(pair):
    jcfg, jtree, model, _ = pair
    ids = np.random.default_rng(5).integers(3, 240, size=(2, 12))
    want = jivl.internvl_forward(jtree, jcfg, jnp.asarray(ids))
    got = tivl.internvl_forward(model, torch.from_numpy(ids))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _requests(mm, cls, tiles, **kw):
    prompts = ("<image> Describe the picture.",
               "<image><image> Compare the two images, please.")
    return [mm.build_request(f"i{n}", text, px, max_new_tokens=6,
                             eos_ids=(), logprobs=True, **kw)
            for n, (text, px) in enumerate(zip(prompts, tiles))]


def test_serving_embed_fn(pair):
    """The same requests from both front ends (one marker a tile,
    expanded to the same hash ids) and the same fused embeddings; a
    repeated image is served from the feature cache."""
    jcfg, jtree, model, _ = pair
    tok = ByteTok()
    jmm, tmm = JServing(jtree, jcfg, tok), InternVLServing(model, tok)
    assert tmm.llm_params is model.text and tmm.llm_cfg == model.cfg.text
    tiles = [_pixels(6, 1), _pixels(7, 2)]
    jreqs = _requests(jmm, JRequest, tiles)
    treqs = _requests(tmm, Request, tiles)
    for j, t in zip(jreqs, treqs):
        assert t.input_ids == j.input_ids
        np.testing.assert_allclose(_np(tmm.embed_fn(t)), jmm.embed_fn(j),
                                   **TOL)
    tmm.prewarm(treqs[0])
    assert len(tmm._cache) == 2
    with pytest.raises(ValueError, match="one <image> marker"):
        tmm.build_request("bad", "<image> x", _pixels(8, 2))


def test_engine_matches_jax_engine(pair):
    """Both engines serve the two requests (1 and 2 tiles, 6 greedy
    tokens, fp32 KV) through their InternVLServing front ends."""
    jcfg, jtree, model, _ = pair
    tok = ByteTok()
    jmm, tmm = JServing(jtree, jcfg, tok), InternVLServing(model, tok)
    common = dict(max_batch=2, max_seq_len=96, prefill_buckets=(64,),
                  kv_chunk=32, decode_steps=2, disable_radix_cache=True)
    jeng = JServeEngine(jtree["text"], jcfg.text,
                        JEngineConfig(kv_dtype=jnp.float32, **common),
                        embed_fn=jmm.embed_fn)
    teng = ServeEngine(tmm.llm_params, tmm.llm_cfg,
                       EngineConfig(kv_dtype=torch.float32, **common),
                       embed_fn=tmm.embed_fn)
    tiles = [_pixels(9, 1), _pixels(10, 2)]
    want = drain_engine(jeng, _requests(jmm, JRequest, tiles))
    got = drain_engine(teng, _requests(tmm, Request, tiles))
    assert sorted(got) == sorted(want) == ["i0", "i1"]
    seen = assert_near_tie_parity(got, want)
    assert all(n == 6 for n, _, _ in seen.values()), seen
