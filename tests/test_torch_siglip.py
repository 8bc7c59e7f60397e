"""The SigLIP tower of the port (aurora_tpu_torch/models/vit.py) against
the JAX package's, float32 on the CPU: 3 layers at 56 px (hidden 32, 4
heads, gelu_pytorch_tanh, a patch bias, no class embedding and no
pre-LayerNorm). The same numpy weights (the JAX init, perturbed so the
patch bias, the biases and the norm scales act) cross through
`aurora_tpu_torch.bridge`; an xtuner directory with a SigLIP
`visual_encoder/` is written from numpy in the HF key names and read by
both packages' `load_auroracap_dir`. Tolerances: exact for the bridge,
the converters and the config, 1e-5 for the position-embedding resample
(one op deep), 1e-4 for the encode (fp32 summation order over 3
layers)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from aurora_tpu.models import aurora as jaurora
from aurora_tpu.models import convert as jconvert
from aurora_tpu.models import vit as jvit
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models import aurora as taurora
from aurora_tpu_torch.models import convert as tconvert
from aurora_tpu_torch.models import vit as tvit

TOL_OP = dict(rtol=1e-5, atol=1e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)

HF_SIGLIP = {"model_type": "siglip_vision_model", "hidden_size": 32,
             "intermediate_size": 64, "num_hidden_layers": 3,
             "num_attention_heads": 4, "image_size": 56, "patch_size": 14,
             "layer_norm_eps": 1e-6, "hidden_act": "gelu_pytorch_tanh"}


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


@pytest.fixture(scope="module")
def siglip():
    cfg = jconvert.vit_config_from_hf(HF_SIGLIP)
    tree = jax.device_get(jvit.init_vit_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(x.dtype),
        tree)
    tcfg = tconvert.vit_config_from_hf(HF_SIGLIP)
    vit = bridge.vit_from_params(tree, tcfg, dtype=torch.float32,
                                 device="cpu")
    return cfg, tcfg, tree, vit


@pytest.mark.parametrize("nested", [False, True])
def test_siglip_config_matches_jax(nested):
    hf = ({"model_type": "siglip", "vision_config": HF_SIGLIP} if nested
          else HF_SIGLIP)
    got = tconvert.vit_config_from_hf(hf)
    assert got == bridge._config_from(jconvert.vit_config_from_hf(hf),
                                      tvit.ViTConfig)
    assert got.model_type == "siglip" and not got.class_token
    assert got.num_positions == 16


def test_siglip_bridge_layout(siglip):
    """The JAX SigLIP tree crosses bit for bit: the patch bias, and no
    class embedding or pre-LayerNorm."""
    _, _, tree, vit = siglip
    sd = vit.state_dict()
    assert "class_embedding" not in sd and not any(
        k.startswith("pre_layernorm") for k in sd)
    emb = tree["embeddings"]
    np.testing.assert_array_equal(_np(sd["patch_embed.bias"]),
                                  emb["patch_bias"])
    np.testing.assert_array_equal(_np(sd["position_embedding"]),
                                  emb["position_embedding"])
    np.testing.assert_array_equal(_np(sd["layers.2.fc1.weight"]),
                                  tree["layers"][2]["mlp"]["fc1"]["kernel"].T)


@pytest.mark.parametrize("kept_ratio", [1.0, 0.25])
def test_siglip_vit_encode(siglip, kept_ratio):
    cfg, _, tree, vit = siglip
    px = np.random.default_rng(2).standard_normal(
        (3, 3, 56, 56)).astype(np.float32)
    want = jvit.vit_encode(tree, jnp.asarray(px), cfg,
                           kept_ratio=kept_ratio, select_layer=-2)
    got = tvit.vit_encode(vit, torch.from_numpy(px), kept_ratio=kept_ratio,
                          select_layer=-2)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL_MODEL)


def test_siglip_num_visual_tokens(siglip):
    """No CLS: the count follows the patches less the dropped token 0,
    and equals the encoded length, at the tiny and at so400m's widths."""
    cfg, tcfg, tree, vit = siglip
    px = torch.zeros((1, 3, 56, 56))
    for ratio in (1.0, 0.5, 0.25):
        jc = jaurora.AuroraConfig.tiny()
        jc = dataclasses.replace(jc, vit=cfg)
        tc = dataclasses.replace(taurora.AuroraConfig.tiny(), vit=tcfg)
        n = taurora.num_visual_tokens(tc, ratio)
        assert n == jaurora.num_visual_tokens(jc, ratio)
        assert n == tvit.vit_encode(vit, px, kept_ratio=ratio).shape[1]
    so400m = {**HF_SIGLIP, "hidden_size": 1152, "intermediate_size": 4304,
              "num_hidden_layers": 27, "num_attention_heads": 16,
              "image_size": 384}
    tc = dataclasses.replace(taurora.AuroraConfig.auroracap_7b(),
                             vit=tconvert.vit_config_from_hf(so400m))
    jc = dataclasses.replace(jaurora.AuroraConfig.auroracap_7b(),
                             vit=jconvert.vit_config_from_hf(so400m))
    for ratio in (1.0, 0.2):
        assert taurora.num_visual_tokens(tc, ratio) == \
            jaurora.num_visual_tokens(jc, ratio)
    assert taurora.num_visual_tokens(tc, 1.0) == 27 * 27 - 1


def test_siglip_interpolate_pos_embedding(siglip):
    cfg, tcfg, tree, _ = siglip
    pos = tree["embeddings"]["position_embedding"]
    want = jvit.interpolate_pos_embedding(jnp.asarray(pos), cfg, 70, 84)
    got = tvit.interpolate_pos_embedding(torch.from_numpy(pos), tcfg, 70, 84)
    assert tuple(got.shape) == want.shape == (30, 32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL_OP)


def _hf_siglip(rng):
    D, I, p = 32, 64, 14
    e = "vision_model.embeddings."
    sd = {e + "patch_embedding.weight": (D, 3, p, p),
          e + "patch_embedding.bias": (D,),
          e + "position_embedding.weight": (16, D),
          "vision_model.post_layernorm.weight": (D,),
          "vision_model.post_layernorm.bias": (D,),
          "vision_model.head.probe": (1, 1, D)}
    for i in range(3):
        b = f"vision_model.encoder.layers.{i}."
        for name, shape in (("layer_norm1", None), ("layer_norm2", None),
                            ("self_attn.q_proj", (D, D)),
                            ("self_attn.k_proj", (D, D)),
                            ("self_attn.v_proj", (D, D)),
                            ("self_attn.out_proj", (D, D)),
                            ("mlp.fc1", (I, D)), ("mlp.fc2", (D, I))):
            sd[b + name + ".weight"] = shape or (D,)
            sd[b + name + ".bias"] = ((shape or (D,))[0],)
    return {k: (0.05 * rng.standard_normal(s)).astype(np.float32)
            for k, s in sd.items()}


def _hf_llama(rng, D=64, I=128, V=256, L=2):
    sd = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D,),
          "lm_head.weight": (V, D)}
    for i in range(L):
        b = f"model.layers.{i}."
        sd.update({b + "input_layernorm.weight": (D,),
                   b + "post_attention_layernorm.weight": (D,),
                   b + "self_attn.q_proj.weight": (D, D),
                   b + "self_attn.k_proj.weight": (D // 2, D),
                   b + "self_attn.v_proj.weight": (D // 2, D),
                   b + "self_attn.o_proj.weight": (D, D),
                   b + "mlp.gate_proj.weight": (I, D),
                   b + "mlp.up_proj.weight": (I, D),
                   b + "mlp.down_proj.weight": (D, I)})
    return {k: (0.05 * rng.standard_normal(s)).astype(np.float32)
            for k, s in sd.items()}


def test_siglip_auroracap_dir_matches_jax_loader(tmp_path):
    """An xtuner directory whose visual_encoder/ is a SiglipVisionModel
    (with its pooling head, which neither package reads): both loaders
    give the same parameters, bit for bit, fp32."""
    rng = np.random.default_rng(7)
    root = str(tmp_path)
    for sub in ("visual_encoder", "projector"):
        os.makedirs(os.path.join(root, sub))
    save_file(_hf_llama(rng), os.path.join(root, "model.safetensors"))
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": 256,
                   "hidden_size": 64, "intermediate_size": 128,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
                   "tie_word_embeddings": False}, f)
    save_file(_hf_siglip(rng), os.path.join(root, "visual_encoder",
                                            "model.safetensors"))
    with open(os.path.join(root, "visual_encoder", "config.json"), "w") as f:
        json.dump(HF_SIGLIP, f)
    pj = {"model.0.weight": (64, 32), "model.0.bias": (64,),
          "model.2.weight": (64, 64), "model.2.bias": (64,)}
    save_file({k: rng.standard_normal(s).astype(np.float32)
               for k, s in pj.items()},
              os.path.join(root, "projector", "model.safetensors"))
    with open(os.path.join(root, "projector", "config.json"), "w") as f:
        json.dump({"visual_hidden_size": 32, "llm_hidden_size": 64,
                   "depth": 2}, f)
    got = tconvert.load_auroracap_dir(root, llm_dtype=torch.float32,
                                      vit_dtype=torch.float32, device="cpu")
    llm, llm_cfg, vit, vit_cfg, pj, pj_cfg = jax.device_get(
        jconvert.load_auroracap_dir(root, llm_dtype=jnp.float32,
                                    vit_dtype=jnp.float32))
    tvit_cfg = bridge._config_from(vit_cfg, tvit.ViTConfig)
    assert got[3] == tvit_cfg and got[3].model_type == "siglip"
    want = (bridge.llama_from_params(llm, bridge.llama_config_from(llm_cfg),
                                     device="cpu", dtype=torch.float32),
            bridge.vit_from_params(vit, tvit_cfg, device="cpu",
                                   dtype=torch.float32),
            bridge.projector_from_params(
                pj, bridge._config_from(pj_cfg, tconvert.ProjectorConfig),
                device="cpu", dtype=torch.float32))
    for g, w in zip((got[0], got[2], got[4]), want):
        gs, ws = g.state_dict(), w.state_dict()
        assert sorted(gs) == sorted(ws)
        for k in ws:
            assert torch.equal(gs[k], ws[k]), k
    assert "patch_embed.bias" in got[2].state_dict()
