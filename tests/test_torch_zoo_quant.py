"""The dense model zoo's checkpoints (tests/test_torch_zoo.py) served by
both engines (tests/test_torch_zoo_engine.py's harness) with int8 and
packed int4 KV, under the near-tie contract of
tests/test_torch_engine_quant.py (`assert_near_tie_parity`): the
families whose engine sites differ, qkv biases (Qwen2), a 96-wide head
(Phi-3), the non-gated biased MLP and LayerNorms (StarCoder2), the
parallel block with per-head norms and interleaved rotary (Cohere),
learned positions and MQA (GPT-BigCode), the embedding, residual and
logit scales (MiniCPM) and Gemma's GeGLU, (1 + w) norms and decoupled
head. Float32 weights; the JAX kernels run in interpret mode.
"""

import pytest

import test_torch_zoo_engine as zoo_engine
from test_torch_engine_quant import assert_near_tie_parity

QUANT_FAMILIES = ("qwen2", "phi3", "starcoder2", "cohere", "gpt_bigcode",
                  "minicpm", "gemma")


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
@pytest.mark.parametrize("family", QUANT_FAMILIES)
def test_family_quantized_kv_engine_matches_jax_engine(family, kv_quant):
    got, want = zoo_engine._serve_both(family, kv_quant)
    assert_near_tie_parity(got, want)
