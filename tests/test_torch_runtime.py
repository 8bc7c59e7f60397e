"""The port's in-process Runtime (aurora_tpu_torch/serve/runtime.py) and its
stop strings against the JAX package's, on one tiny model, fp32 on the CPU.

Both runtimes get the same 3 prompts at max_batch 2 (a rolling admission)
with the radix cache on (both on their Python trees): texts, output_ids and
finish_reason must be equal, without stop strings and with one taken from
inside a first run's text (the same trim, the same early finish), at
decode_steps 1 and 4 (a stop inside a decode block cuts the output
there). `max_steps` exhaustion raises RuntimeError; `Runtime(model_path=)`
on a tiny HF llama directory gives the JAX runtime's tokens; `regex=`
raises NotImplementedError.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.runtime import Runtime as JRuntime
from aurora_tpu_torch import bridge
from aurora_tpu_torch.serve.engine import EngineConfig
from aurora_tpu_torch.serve.runtime import Runtime

from utils import make_tiny_tokenizer, make_tiny_xtuner_dir

PROMPTS = ["ab cd", "xy z w", "hello there"]
ENGINE = dict(max_batch=2, max_seq_len=96, num_slots=256,
              prefill_buckets=(16, 32))


@pytest.fixture(autouse=True)
def python_radix_trees(monkeypatch):
    monkeypatch.setenv("AURORA_NATIVE_RADIX", "0")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tok = make_tiny_tokenizer(str(tmp_path_factory.mktemp("tok")))
    cfg = JLlamaConfig.tiny(vocab_size=512)
    tree = jax.device_get(init_llama_params(jax.random.PRNGKey(7), cfg,
                                            dtype=jnp.float32))
    tcfg = bridge.llama_config_from(cfg)
    model = bridge.llama_from_params(tree, tcfg, device="cpu",
                                     dtype=torch.float32)
    return tok, cfg, tree, tcfg, model


def _runtimes(tiny, decode_steps=1):
    tok, cfg, tree, tcfg, model = tiny
    jrt = JRuntime(tree, cfg, tok, engine_config=JEngineConfig(
        kv_dtype=jnp.float32, decode_steps=decode_steps, **ENGINE))
    trt = Runtime(model, tcfg, tok, engine_config=EngineConfig(
        kv_dtype=torch.float32, decode_steps=decode_steps, **ENGINE))
    return jrt, trt


def _stop_of(text):
    """Two characters from inside `text` (not at its start)."""
    assert len(text) >= 6, text
    return text[3:5]


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_runtime_matches_jax_with_and_without_stop(tiny, decode_steps):
    jrt, trt = _runtimes(tiny, decode_steps)
    want = jrt.generate(PROMPTS, max_new_tokens=12)
    got = trt.generate(PROMPTS, max_new_tokens=12)
    assert got == want
    assert all(o["finish_reason"] in ("stop", "length") for o in got)
    stop = _stop_of(got[0]["text"])
    want_s = jrt.generate(PROMPTS, max_new_tokens=12, stop=[stop])
    got_s = trt.generate(PROMPTS, max_new_tokens=12, stop=[stop])
    assert got_s == want_s
    first = got_s[0]
    assert first["finish_reason"] == "stop"
    assert first["text"] == got[0]["text"][:got[0]["text"].find(stop)]
    n = len(first["output_ids"])
    assert n < len(got[0]["output_ids"])
    assert first["output_ids"] == got[0]["output_ids"][:n]
    assert trt.flush_cache() == jrt.flush_cache() == 0


def test_single_prompt_returns_one_dict(tiny):
    jrt, trt = _runtimes(tiny)
    got = trt.generate("ab cd", max_new_tokens=4)
    assert got == jrt.generate("ab cd", max_new_tokens=4)
    assert isinstance(got, dict)


def test_max_steps_exhaustion_raises(tiny):
    _, trt = _runtimes(tiny)
    with pytest.raises(RuntimeError, match="max_steps"):
        trt.generate(PROMPTS, max_new_tokens=20, max_steps=2)


def test_regex_raises(tiny):
    _, trt = _runtimes(tiny)
    with pytest.raises(NotImplementedError):
        trt.generate(PROMPTS, regex="[ab]+")


def test_runtime_from_model_path_matches_jax(tmp_path):
    root = make_tiny_xtuner_dir(tmp_path)[0]
    jrt = JRuntime(model_path=root, dtype=jnp.float32,
                   engine_config=JEngineConfig(kv_dtype=jnp.float32,
                                               **ENGINE))
    trt = Runtime(model_path=root, dtype=torch.float32, device="cpu",
                  engine_config=EngineConfig(kv_dtype=torch.float32,
                                             **ENGINE))
    assert trt.engine.runner.model.embed_tokens.dtype == torch.float32
    got = trt.generate(PROMPTS, max_new_tokens=6)
    assert got == jrt.generate(PROMPTS, max_new_tokens=6)
    assert all(len(o["output_ids"]) >= 1 for o in got)


def test_stop_strings_need_a_tokenizer(tiny):
    from aurora_tpu_torch.serve.engine import ServeEngine
    from aurora_tpu_torch.serve.scheduler import Request
    _, _, _, tcfg, model = tiny
    eng = ServeEngine(model, tcfg, EngineConfig(kv_dtype=torch.float32,
                                                **ENGINE))
    with pytest.raises(ValueError, match="tokenizer"):
        eng.add_request(Request(rid="r", input_ids=[5, 6, 7],
                                stop_strs=("x",)))
