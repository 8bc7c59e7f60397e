"""Checkpoint export (aurora_tpu_torch/models/export.py) and the `convert`
mode against aurora_tpu.models.export, on the CPU.

- The same weights (the JAX init, bridged into the port) exported by both
  packages in each layout (xtuner, huggingface with a padded vocabulary,
  official) and in a sharded write give the same files: the same names,
  and in each the same keys, shapes, dtypes and values bit for bit, the
  same config.json and index (tests/test_checkpoint_export.py:67, :118,
  :140). Every file is read through the installed
  `safetensors.numpy.load_file`.
- The port's writer writes each dtype the reader takes, and what it writes
  comes back bit for bit through both readers.
- Exported directories load back into the port bit for bit
  (`load_auroracap_dir`, `load_llava_hf_dir`; the padded vocabulary rows
  apart).
- `python -m aurora_tpu_torch convert` round-trips an xtuner directory in
  every format, and a training checkpoint of the port's trainer (sized by
  --ref_model) exports the checkpoint's weights.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from aurora_tpu.models import export as jexport
from aurora_tpu.models.aurora import AuroraConfig as JAuroraConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.models.projector import init_projector_params
from aurora_tpu.models.vit import init_vit_params
from aurora_tpu_torch import bridge
from aurora_tpu_torch import __main__ as entry
from aurora_tpu_torch.models import export as texport
from aurora_tpu_torch.models.convert import (load_auroracap_dir,
                                             load_llava_hf_dir,
                                             read_safetensors)

from utils import make_tiny_xtuner_dir


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread: the suite runs several workers at
    once, and their intra-op pools would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(vocab=256, seed=5):
    """(JAX config, JAX params, the port's AuroraModel) of one init; a
    vocabulary off a multiple of 64 makes the huggingface layout pad."""
    cfg = JAuroraConfig.tiny()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, vocab_size=vocab))
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = jax.device_get({
        "visual_encoder": init_vit_params(keys[0], cfg.vit, jnp.float32),
        "projector": init_projector_params(keys[1], cfg.projector,
                                           jnp.float32),
        "llm": init_llama_params(keys[2], cfg.llm, jnp.float32)})
    model = bridge.aurora_from_params(params, bridge.aurora_config_from(cfg),
                                      device="cpu", dtype=torch.float32)
    return cfg, params, model


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_dirs(got, want):
    assert _files(got) == _files(want)
    for rel in _files(want):
        a, b = os.path.join(got, rel), os.path.join(want, rel)
        if rel.endswith(".safetensors"):
            ga, wb = load_file(a), load_file(b)
            assert ga.keys() == wb.keys(), rel
            for k in wb:
                assert ga[k].dtype == wb[k].dtype and \
                    ga[k].shape == wb[k].shape, (rel, k)
                np.testing.assert_array_equal(ga[k], wb[k], err_msg=k)
        else:       # config.json, model.safetensors.index.json
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), rel


@pytest.mark.parametrize("layout", ["xtuner", "huggingface", "official"])
def test_export_matches_the_reference(tmp_path, layout):
    cfg, params, model = _pair(vocab=250 if layout == "huggingface"
                               else 256)
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    if layout == "xtuner":
        jexport.export_xtuner_dir(params, cfg.llm, cfg.vit, cfg.projector,
                                  want)
    elif layout == "huggingface":
        jexport.export_hf_llava(params, cfg.llm, cfg.vit, cfg.projector,
                                want)
    else:
        jexport.export_official_llava(params, cfg.llm, cfg.vit,
                                      cfg.projector, want)
    texport.EXPORTERS[layout](model, got)
    _assert_same_dirs(got, want)
    if layout == "huggingface":     # 250 → 256: six sampled rows
        sd = load_file(os.path.join(got, "model.safetensors"))
        assert sd["language_model.model.embed_tokens.weight"].shape[0] == 256


def test_sharded_export_matches_the_reference(tmp_path, monkeypatch):
    """Above the shard threshold both packages write the same shards and
    index, and the port reads them back bit for bit."""
    import functools
    cfg, params, model = _pair(seed=8)
    monkeypatch.setattr(jexport, "_write", functools.partial(
        jexport._write, max_shard_bytes=64 * 1024))
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    jexport.export_xtuner_dir(params, cfg.llm, cfg.vit, cfg.projector, want)
    texport.export_xtuner_dir(model, got, max_shard_bytes=64 * 1024)
    assert os.path.exists(os.path.join(got, "model.safetensors.index.json"))
    _assert_same_dirs(got, want)
    llm = load_auroracap_dir(got, llm_dtype=torch.float32,
                             vit_dtype=torch.float32, device="cpu")[0]
    for k, t in model.llm.state_dict().items():
        assert torch.equal(llm.state_dict()[k], t), k


def test_safetensors_writer_round_trips(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g),
               "f16": torch.randn(7, generator=g).half(),
               "bf16": torch.randn(2, 3, generator=g).bfloat16(),
               "i8": torch.randint(-128, 127, (9,), generator=g,
                                   dtype=torch.int8),
               "i64": torch.arange(5), "u8": torch.arange(3).byte(),
               "b": torch.tensor([True, False]),
               "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "t.safetensors")
    n = texport.write_safetensors(path, tensors)
    assert n == os.path.getsize(path)
    with open(path, "rb") as f:
        assert (8 + int.from_bytes(f.read(8), "little")) % 8 == 0
    back = read_safetensors(path)
    assert back.keys() == tensors.keys()
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    lib = load_file(path)       # numpy has no bfloat16
    for k, t in tensors.items():
        if k != "bf16":
            np.testing.assert_array_equal(lib[k], t.numpy(), err_msg=k)


@pytest.mark.parametrize("layout", ["xtuner", "huggingface"])
def test_export_loads_back_bit_for_bit(tmp_path, layout):
    _, _, model = _pair(vocab=250)
    out = str(tmp_path / layout)
    texport.EXPORTERS[layout](model, out, dtype=torch.bfloat16)
    load = load_auroracap_dir if layout == "xtuner" else load_llava_hf_dir
    llm, llm_cfg, vit, vit_cfg, pj, _ = load(
        out, llm_dtype=torch.bfloat16, vit_dtype=torch.bfloat16,
        device="cpu")
    assert vit_cfg == model.cfg.vit
    for got, want in ((llm, model.llm), (vit, model.visual_encoder),
                      (pj, model.projector)):
        sd = got.state_dict()
        for k, t in want.state_dict().items():
            t = t.bfloat16()
            if layout == "huggingface" and k in ("embed_tokens",
                                                 "lm_head.weight"):
                assert sd[k].shape[0] == 256
                sd[k] = sd[k][:250]
            assert torch.equal(sd[k], t), k


def _convert(*argv):
    return entry.main(["convert", *argv, "--device", "cpu"])


@pytest.fixture(scope="module")
def xtuner_dir(tmp_path_factory):
    return make_tiny_xtuner_dir(tmp_path_factory.mktemp("src"))[0]


@pytest.mark.parametrize("fmt", ["xtuner", "huggingface", "official"])
def test_convert_mode_round_trips_a_directory(xtuner_dir, tmp_path, capsys,
                                              fmt):
    from aurora_tpu_torch.cli.convert import load_aurora
    src, _ = load_aurora(xtuner_dir, "cpu")
    dst = str(tmp_path / fmt)
    assert _convert("--src", xtuner_dir, "--dst", dst, "--format", fmt) == 0
    assert f"wrote {fmt}" in capsys.readouterr().out
    if fmt == "official":
        sd = load_file(os.path.join(dst, "model.safetensors"))
        assert "model.mm_projector.2.bias" in sd
        np.testing.assert_array_equal(
            sd["model.embed_tokens.weight"],
            src.llm.embed_tokens.detach().numpy())
        return
    back, _ = load_aurora(dst, "cpu")
    for k, t in src.state_dict().items():
        got = back.state_dict()[k]
        if fmt == "huggingface" and k in ("llm.embed_tokens",
                                          "llm.lm_head.weight"):
            got = got[:t.shape[0]]      # 512 is a multiple of 64 already
        assert torch.equal(got, t), k
    if fmt == "xtuner":
        assert os.path.exists(os.path.join(dst, "tokenizer.json"))


def test_convert_mode_exports_a_training_checkpoint(xtuner_dir, tmp_path):
    from aurora_tpu_torch.cli.convert import load_aurora
    from aurora_tpu_torch.train.checkpoint import save_checkpoint
    model, _ = load_aurora(xtuner_dir, "cpu")
    trained = {k: t + 0.5 for k, t in model.state_dict().items()}
    ckpt = str(tmp_path / "checkpoints")
    save_checkpoint(ckpt, {"params": trained, "opt_state": {}, "step": 3}, 3)
    dst = str(tmp_path / "out")
    assert _convert("--src", ckpt, "--dst", dst) == 2     # no --ref_model
    assert _convert("--src", ckpt, "--ref_model", xtuner_dir, "--dst",
                    dst) == 0
    back, _ = load_aurora(dst, "cpu")
    for k, t in trained.items():
        assert torch.equal(back.state_dict()[k], t), k
    save_checkpoint(ckpt, {"adapters": {}, "opt_state": {}}, 4)
    assert _convert("--src", ckpt, "--ref_model", xtuner_dir, "--dst",
                    str(tmp_path / "lora")) == 2
