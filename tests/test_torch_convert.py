"""The port's checkpoint loader (aurora_tpu_torch/models/convert.py) against
the safetensors package and the JAX loader.

The stdlib safetensors reader must give the safetensors package's tensors
for every dtype (bf16 through safetensors.torch, numpy has none), with a
zero-element tensor and a tensor at an offset that is not a multiple of
its item size, one file or shards named by an index that names a file
twice; `.bin` files load through torch.load, one or sharded. The port's
`load_auroracap_dir` and `load_llava_hf_dir` must give, on tiny random HF
checkpoints, exactly the parameters that the JAX loaders give after the
bridge (fp32, bit for bit), and a bf16 checkpoint loads as bf16 without a
widening copy; a SigLIP vision config and Yi-VL's projector LayerNorms
read as the reference reads them. The MoE families convert
(tests/test_torch_moe.py) and DeepSeek-V2 loads through
models/deepseek_v2.py (tests/test_torch_mla.py); what the reference
refuses of them raises NotImplementedError.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file

from aurora_tpu.models import convert as jconvert
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models import convert as tconvert

from utils import make_tiny_xtuner_dir


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "odd_bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        # after 15 bf16 items: an fp32 tensor at an offset of 2 mod 4
        "f32": torch.randn(2, 3, generator=g),
        "f16": torch.randn(7, generator=g).to(torch.float16),
        "i64": torch.arange(-4, 4, dtype=torch.int64),
        "empty": torch.zeros((0, 4)),
        "u8": torch.arange(5, dtype=torch.uint8),
    }


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_safetensors_reader_matches_the_package(tmp_path):
    path = str(tmp_path / "model.safetensors")
    save_file(_tensors(), path, metadata={"format": "pt"})
    got = tconvert.read_safetensors(path)
    _assert_same(got, torch_load_file(path))
    # every dtype numpy has, against safetensors.numpy
    np_path = str(tmp_path / "np.safetensors")
    save_file({k: v for k, v in _tensors().items() if k != "odd_bf16"},
              np_path)
    got = tconvert.read_safetensors(np_path)
    for k, arr in np_load_file(np_path).items():
        assert got[k].numpy().dtype == arr.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), arr)


def test_sharded_safetensors_index(tmp_path):
    ts = _tensors()
    names = sorted(ts)
    shards = {"model-00001-of-00002.safetensors": names[:3],
              "model-00002-of-00002.safetensors": names[3:]}
    weight_map = {}
    for fn, keys in shards.items():
        save_file({k: ts[k] for k in keys}, str(tmp_path / fn))
        weight_map.update({k: fn for k in keys})   # a file per key
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    _assert_same(tconvert.load_torch_state_dict(str(tmp_path)), ts)


@pytest.mark.parametrize("sharded", [False, True])
def test_bin_files(tmp_path, sharded):
    ts = _tensors()
    if sharded:
        names = sorted(ts)
        weight_map = {}
        for i, keys in enumerate((names[:2], names[2:])):
            fn = f"pytorch_model-0000{i + 1}-of-00002.bin"
            torch.save({k: ts[k] for k in keys}, str(tmp_path / fn))
            weight_map.update({k: fn for k in keys})
        with open(tmp_path / "pytorch_model.bin.index.json", "w") as f:
            json.dump({"weight_map": weight_map}, f)
    else:
        torch.save(ts, str(tmp_path / "pytorch_model.bin"))
    _assert_same(tconvert.load_torch_state_dict(str(tmp_path)), ts)


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        tconvert.load_torch_state_dict(str(tmp_path))


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    return make_tiny_xtuner_dir(tmp_path_factory.mktemp("xtuner"))


def _jax_modules(loaded, device="cpu"):
    """The JAX loader's tuple through the bridge, as port modules."""
    llm, llm_cfg, vit, vit_cfg, pj, pj_cfg = jax.device_get(loaded)
    tllm_cfg = bridge.llama_config_from(llm_cfg)
    tvit_cfg = bridge._config_from(vit_cfg, tconvert.ViTConfig)
    tpj_cfg = bridge._config_from(pj_cfg, tconvert.ProjectorConfig)
    return (bridge.llama_from_params(llm, tllm_cfg, device=device,
                                     dtype=torch.float32), tllm_cfg,
            bridge.vit_from_params(vit, tvit_cfg, device=device,
                                   dtype=torch.float32), tvit_cfg,
            bridge.projector_from_params(pj, tpj_cfg, device=device,
                                         dtype=torch.float32), tpj_cfg)


def _assert_modules_equal(got, want):
    for g, w in zip(got, want):
        if isinstance(w, torch.nn.Module):
            _assert_same(g.state_dict(), w.state_dict())
        else:
            assert g == w


def test_auroracap_dir_matches_jax_loader(tiny_dir):
    root = tiny_dir[0]
    got = tconvert.load_auroracap_dir(root, llm_dtype=torch.float32,
                                      vit_dtype=torch.float32, device="cpu")
    want = _jax_modules(jconvert.load_auroracap_dir(
        root, llm_dtype=jnp.float32, vit_dtype=jnp.float32))
    _assert_modules_equal(got, want)
    assert got[0].embed_tokens.device.type == "cpu"


def test_bf16_checkpoint_loads_as_bf16(tmp_path, tiny_dir):
    """A bf16 safetensors LLM: the reader keeps bf16, and the loaded bf16
    model holds the file's values bit for bit."""
    root = str(tmp_path / "bf16")
    shutil.copytree(tiny_dir[0], root)
    os.remove(os.path.join(root, "model.safetensors"))
    hf = tiny_dir[1]
    sd = {k: v.to(torch.bfloat16).contiguous()
          for k, v in hf.state_dict().items()}
    save_file(sd, os.path.join(root, "model.safetensors"))
    raw = tconvert.load_torch_state_dict(root)
    assert {t.dtype for t in raw.values()} == {torch.bfloat16}
    llm = tconvert.load_auroracap_dir(root, llm_dtype=torch.bfloat16,
                                      device="cpu")[0]
    assert llm.embed_tokens.dtype == torch.bfloat16
    assert torch.equal(llm.layers[1].gate.weight,
                       sd["model.layers.1.mlp.gate_proj.weight"])
    assert torch.equal(llm.lm_head.weight, sd["lm_head.weight"])


def _tiny_llava(root, seed=0):
    from transformers import (CLIPVisionConfig, LlamaConfig, LlavaConfig,
                              LlavaForConditionalGeneration)
    torch.manual_seed(seed)
    cfg = LlavaConfig(
        vision_config=CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=4, image_size=56, patch_size=14).to_dict(),
        text_config=LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, tie_word_embeddings=False).to_dict(),
        vision_feature_layer=-2, image_token_index=255)
    LlavaForConditionalGeneration(cfg).eval().save_pretrained(root)
    return root


def test_llava_hf_dir_matches_jax_loader(tmp_path):
    root = _tiny_llava(str(tmp_path / "llava"))
    got = tconvert.load_llava_hf_dir(root, llm_dtype=torch.float32,
                                     vit_dtype=torch.float32, device="cpu")
    want = _jax_modules(jconvert.load_llava_hf_dir(
        root, llm_dtype=jnp.float32, vit_dtype=jnp.float32))
    _assert_modules_equal(got, want)


def _base_llama():
    return {"model_type": "llama", "vocab_size": 64, "hidden_size": 32,
            "intermediate_size": 64, "num_hidden_layers": 1,
            "num_attention_heads": 4}


# the dense and MoE families are ported (tests/test_torch_zoo.py,
# tests/test_torch_moe.py); what the reference refuses of the MoE ones
# (it asserts) raises, as do DeepSeek-V2 on the llama path (MLA loads
# through models/deepseek_v2.py) and rope scalings other than linear
_DBRX = {"model_type": "dbrx", "d_model": 32, "n_heads": 4, "n_layers": 1,
         "max_seq_len": 64, "vocab_size": 64,
         "attn_config": {"kv_n_heads": 2, "clip_qkv": 8.0},
         "ffn_config": {"ffn_hidden_size": 64, "moe_num_experts": 4,
                        "moe_top_k": 2, "moe_normalize_expert_weights": 2}}


@pytest.mark.parametrize("change", [
    {"model_type": "qwen2_moe", "num_experts": 4, "decoder_sparse_step": 2},
    {"model_type": "qwen3_moe", "num_experts": 4, "mlp_only_layers": [0]},
    _DBRX,
    {"model_type": "deepseek", "n_routed_experts": 4, "moe_layer_freq": 2},
    {"model_type": "deepseek_v2"},
    {"rope_scaling": {"type": "dynamic", "factor": 2.0}}],
    ids=["qwen2_moe", "qwen3_moe", "dbrx", "deepseek", "deepseek_v2",
         "rope"])
def test_unported_llm_configs_raise(change):
    match = {"deepseek_v2": "deepseek_v2", None: "rope"}.get(
        change.get("model_type"), "reference")
    with pytest.raises(NotImplementedError, match=match):
        tconvert.llama_config_from_hf({**_base_llama(), **change})


def test_ported_llm_configs_match_jax():
    """Configs whose rope_scaling spells its kind `type` read as the
    reference reads them. `rope_type` comes first, as transformers reads
    it (the reference reads `type` only): a config that spells only
    `rope_type` equals the reference's reading of the same config spelled
    `type`, and where the two keys differ the port follows `rope_type`."""
    linear = {"type": "linear", "factor": 4.0}
    for cfg in (_base_llama(),
                {**_base_llama(), "rope_scaling": linear},
                {**_base_llama(), "model_type": "mistral",
                 "num_key_value_heads": 2, "sliding_window": 8}):
        got = tconvert.llama_config_from_hf(cfg)
        assert got == bridge.llama_config_from(
            jconvert.llama_config_from_hf(cfg))
    want = bridge.llama_config_from(jconvert.llama_config_from_hf(
        {**_base_llama(), "rope_scaling": linear}))
    assert want.rope_linear_scaling == 4.0
    for scaling in ({"rope_type": "linear", "factor": 4.0},
                    {"rope_type": "linear", "type": "dynamic",
                     "factor": 4.0}):
        assert tconvert.llama_config_from_hf(
            {**_base_llama(), "rope_scaling": scaling}) == want
    with pytest.raises(NotImplementedError, match="dynamic"):
        tconvert.llama_config_from_hf({**_base_llama(), "rope_scaling": {
            "rope_type": "dynamic", "type": "linear", "factor": 4.0}})


def test_siglip_tower_config_matches_jax():
    """A SigLIP vision config reads as the reference reads it (no class
    token; its own GELU where the config names none)."""
    hf = {"model_type": "siglip_vision_model", "hidden_size": 32,
          "intermediate_size": 64, "num_hidden_layers": 1,
          "num_attention_heads": 4}
    got = tconvert.vit_config_from_hf(hf)
    assert got == bridge._config_from(jconvert.vit_config_from_hf(hf),
                                      tconvert.ViTConfig)
    assert got.model_type == "siglip" and not got.class_token
    assert got.hidden_act == "gelu_pytorch_tanh"


def test_yi_vl_projector_layernorms_match_jax(tmp_path):
    """The tiny llava directory with Yi-VL's projector LayerNorms (ln_1,
    ln_2) added: both packages' load_llava_hf_dir give the same
    parameters, and the projectors' outputs agree within 1e-5."""
    src = _tiny_llava(str(tmp_path / "llava"))
    root = str(tmp_path / "yivl")
    os.makedirs(root)
    shutil.copy(os.path.join(src, "config.json"), root)
    sd = tconvert.load_torch_state_dict(src)
    g = torch.Generator().manual_seed(1)
    for i in (1, 2):
        w = next(k for k in sd if f"multi_modal_projector.linear_{i}.weight"
                 in k)
        sd[w.replace(f"linear_{i}", f"ln_{i}")] = 1 + 0.1 * torch.randn(
            64, generator=g)
        sd[w.replace(f"linear_{i}.weight", f"ln_{i}.bias")] = \
            0.1 * torch.randn(64, generator=g)
    save_file({k: v.contiguous() for k, v in sd.items()},
              os.path.join(root, "model.safetensors"))
    got = tconvert.load_llava_hf_dir(root, llm_dtype=torch.float32,
                                     vit_dtype=torch.float32, device="cpu")
    jloaded = jconvert.load_llava_hf_dir(root, llm_dtype=jnp.float32,
                                         vit_dtype=jnp.float32)
    want = _jax_modules(jloaded)
    _assert_modules_equal(got, want)
    assert sorted(got[4].norms) == ["ln0", "ln1"]
    from aurora_tpu.models.projector import apply_projector
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(
        np.float32)
    np.testing.assert_allclose(
        got[4](torch.from_numpy(x)).detach().numpy(),
        np.asarray(apply_projector(jloaded[4], jnp.asarray(x), jloaded[5])),
        rtol=1e-5, atol=1e-5)
