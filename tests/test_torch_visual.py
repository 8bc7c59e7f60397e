"""Port visual path and weight bridge vs the JAX package, float32 on the
CPU at the tiny AuroraCap config (ViT 3 layers at 56 px). The same numpy
weights (the JAX init, perturbed so biases and norm scales are not
trivial) cross through `aurora_tpu_torch.bridge`. Tolerances: 1e-5 for
the bridge, projector and normalize (one op deep), 1e-4 for the ViT and
the encode/fuse path (fp32 summation order over a few layers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.data.preprocess import clip_normalize_device as j_norm
from aurora_tpu.models import aurora as jaurora
from aurora_tpu.models import vit as jvit
from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.models.projector import (apply_projector,
                                         init_projector_params)
from aurora_tpu_torch import bridge
from aurora_tpu_torch.data.preprocess import clip_normalize_device
from aurora_tpu_torch.models import aurora as taurora
from aurora_tpu_torch.models import vit as tvit

TOL_OP = dict(rtol=1e-5, atol=1e-5)
TOL_MODEL = dict(rtol=1e-4, atol=1e-4)


def _perturb(tree, rng):
    return jax.tree.map(
        lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(x.dtype),
        tree)


@pytest.fixture(scope="module")
def tiny():
    cfg = jaurora.AuroraConfig.tiny()
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    tree = {"visual_encoder": jvit.init_vit_params(keys[0], cfg.vit),
            "projector": init_projector_params(keys[1], cfg.projector),
            "llm": init_llama_params(keys[2], cfg.llm)}
    tree = _perturb(jax.device_get(tree), np.random.default_rng(0))
    model = bridge.aurora_from_params(tree, bridge.aurora_config_from(cfg),
                                      dtype=torch.float32, device="cpu")
    return cfg, tree, model


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def test_bridge_layouts(tiny):
    cfg, tree, model = tiny
    lp = tree["llm"]["layers"]
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        np.testing.assert_array_equal(
            _np(getattr(model.llm.layers[1], name).weight), lp[name][1].T)
    np.testing.assert_array_equal(_np(model.llm.lm_head.weight),
                                  tree["llm"]["lm_head"].T)
    vp = tree["visual_encoder"]["layers"][2]
    np.testing.assert_array_equal(
        _np(model.visual_encoder.layers[2].fc1.bias), vp["mlp"]["fc1"]["bias"])
    # the conv patch embedding equals the reference's unfold + matmul
    px = np.random.default_rng(1).standard_normal(
        (2, 3, 56, 56)).astype(np.float32)
    want = jvit._patch_embed(tree["visual_encoder"], jnp.asarray(px),
                             cfg.vit)
    got = model.visual_encoder.embed(torch.from_numpy(px))
    np.testing.assert_allclose(_np(got), _np(want), **TOL_OP)


def test_bridge_rejects_other_families():
    # Mistral's window, Qwen2's biases and Gemma2's alternating windows
    # cross since the dense zoo was ported, the MoE and MLA knobs since
    # those families were
    assert bridge.llama_config_from(
        JLlamaConfig.mistral_7b()).sliding_window == 4096
    assert bridge.llama_config_from(JLlamaConfig.qwen2_7b()).qkv_bias
    assert bridge.llama_config_from(dataclasses.replace(
        JLlamaConfig.mistral_7b(), swa_every_other=True)).swa_every_other
    assert bridge.llama_config_from(dataclasses.replace(
        JLlamaConfig.mistral_7b(), num_experts=8)).num_experts == 8
    assert bridge.llama_config_from(dataclasses.replace(
        JLlamaConfig.mistral_7b(), mla_kv_lora_rank=512)
        ).mla_kv_lora_rank == 512
    assert bridge.llama_config_from(
        JLlamaConfig.vicuna_7b_v15_16k()).rope_linear_scaling == 4.0


@pytest.mark.parametrize("kept_ratio", [0.5, 1.0])
def test_vit_encode(tiny, kept_ratio):
    cfg, tree, model = tiny
    px = np.random.default_rng(2).standard_normal(
        (3, 3, 56, 56)).astype(np.float32)
    want = jvit.vit_encode(tree["visual_encoder"], jnp.asarray(px), cfg.vit,
                           kept_ratio=kept_ratio, select_layer=-2)
    got = tvit.vit_encode(model.visual_encoder, torch.from_numpy(px),
                          kept_ratio=kept_ratio, select_layer=-2)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL_MODEL)


def test_interpolate_pos_embedding(tiny):
    cfg, tree, model = tiny
    pos = tree["visual_encoder"]["embeddings"]["position_embedding"]
    want = jvit.interpolate_pos_embedding(jnp.asarray(pos), cfg.vit, 70, 84)
    got = tvit.interpolate_pos_embedding(torch.from_numpy(pos),
                                         model.cfg.vit, 70, 84)
    assert tuple(got.shape) == want.shape == (31, 32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL_OP)


def test_projector(tiny):
    cfg, tree, model = tiny
    x = np.random.default_rng(3).standard_normal((2, 5, 32)).astype(
        np.float32)
    want = apply_projector(tree["projector"], jnp.asarray(x), cfg.projector)
    got = model.projector(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL_OP)


def test_clip_normalize_device():
    frames = np.random.default_rng(4).integers(
        0, 256, size=(2, 8, 8, 3)).astype(np.uint8)
    want = j_norm(jnp.asarray(frames))
    got = clip_normalize_device(torch.from_numpy(frames))
    assert tuple(got.shape) == (2, 3, 8, 8)
    np.testing.assert_allclose(_np(got), _np(want), **TOL_OP)


def test_num_visual_tokens():
    for jc, tc in ((jaurora.AuroraConfig.tiny(), taurora.AuroraConfig.tiny()),
                   (jaurora.AuroraConfig.auroracap_7b(),
                    taurora.AuroraConfig.auroracap_7b())):
        for ratio in (0.2, 0.5, 0.8, 1.0):
            assert taurora.num_visual_tokens(tc, ratio) == \
                jaurora.num_visual_tokens(jc, ratio)
    assert taurora.num_visual_tokens(taurora.AuroraConfig.auroracap_7b(),
                                     0.2) == 171


def test_encode_visual_and_fuse(tiny):
    cfg, tree, model = tiny
    rng = np.random.default_rng(5)
    px = rng.standard_normal((2, 2, 3, 56, 56)).astype(np.float32)
    jg = jaurora.encode_visual(tree, jnp.asarray(px), cfg, 0.5)
    tg = taurora.encode_visual(model, torch.from_numpy(px), 0.5)
    np.testing.assert_allclose(_np(tg), _np(jg), **TOL_MODEL)

    M = -200
    ids = np.array([[1, 5, M, 7, M, 9, 3, 4],
                    [1, M, 6, M, 8, 0, 0, 0]], np.int64)
    mask = np.array([[1] * 8, [1] * 5 + [0] * 3], bool)
    labels = rng.integers(0, 100, size=ids.shape).astype(np.int64)
    want = jaurora.fuse_multimodal(tree["llm"]["embed_tokens"],
                                   jnp.asarray(ids), [jg],
                                   attention_mask=jnp.asarray(mask),
                                   labels=jnp.asarray(labels))
    got = taurora.fuse_multimodal(model.llm.embed_tokens,
                                  torch.from_numpy(ids), [tg],
                                  attention_mask=torch.from_numpy(mask),
                                  labels=torch.from_numpy(labels))
    np.testing.assert_allclose(_np(got["inputs_embeds"]),
                               _np(want["inputs_embeds"]), **TOL_MODEL)
    for key in ("attention_mask", "position_ids", "labels"):
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))
