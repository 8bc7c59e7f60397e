"""The MoE families' checkpoints (tests/test_torch_moe.py) served by both
engines (tests/test_torch_moe_engine.py's harness) with W8 and W4
weights, whose experts are int8 with one scale per expert and output
channel (the reference's `_deq` rounding in the grouped form's plain
twin and in the dense decode), and int8 or packed int4 KV, under the
near-tie contract of tests/test_torch_engine_quant.py
(`assert_near_tie_parity`); each engine quantizes its own float weights.
Mixtral in three rungs; Qwen2-MoE (its gated shared expert int8 too) and
DeepSeek v1 (its dense prefix left float) in one each. The JAX kernels
run in interpret mode.
"""

import pytest

import test_torch_moe_engine as moe_engine
from test_torch_engine_quant import assert_near_tie_parity


@pytest.mark.parametrize("family,weight_quant,kv_quant", [
    ("mixtral", "int8", "int8"), ("mixtral", "int4", "int8"),
    ("mixtral", "int4", "int4"), ("qwen2_moe", "int8", "int4"),
    ("deepseek", "int4", "int8")])
def test_moe_quantized_engine_matches_jax_engine(family, weight_quant,
                                                 kv_quant):
    teng, jeng = moe_engine._engines(family, weight_quant=weight_quant,
                                     kv_quant=kv_quant)
    got, want = moe_engine._serve(teng, jeng, moe_engine._prompts())
    assert_near_tie_parity(got, want)
