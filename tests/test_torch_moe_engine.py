"""The MoE families' checkpoints (tests/test_torch_moe.py) served by the
port's ServeEngine against the JAX ServeEngine, on the CPU: two
14-token prompts in one extend wave (the grouped form: the port's
`moe_grouped_mm` on its plain twin, the reference's ragged_dot), then 6
greedy tokens each (decode_steps 2, the dense all-expert form on both
sides), float32 weights:

* fp32 KV: every family's tokens exactly (DeepSeek v1's dense prefix
  keeps its absolute layer indexes into the rows);
* the radix cache on: a second wave that extends the first's prompts hits
  their prefixes on both sides, and the tokens stay exact.

The quantized engines: tests/test_torch_moe_quant.py. The JAX kernels
run in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.engine import ServeEngine as JServeEngine
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
from aurora_tpu_torch.serve.scheduler import Request

import test_torch_moe as moe
from utils import drain_engine


def _engines(family, radix=False, **quant):
    _, jcfg, tree, _, model = moe.pair(family)
    common = dict(max_batch=2, max_seq_len=48, prefill_buckets=(16,),
                  kv_chunk=16, decode_steps=2, num_slots=256,
                  disable_radix_cache=not radix, **quant)
    jeng = JServeEngine(tree, jcfg, JEngineConfig(kv_dtype=jnp.float32,
                                                  **common))
    teng = ServeEngine(model, model.cfg, EngineConfig(kv_dtype=torch.float32,
                                                      **common))
    return teng, jeng


def _prompts(n=2, extra=()):
    rng = np.random.default_rng(13)
    return [[int(x) for x in rng.integers(3, moe.V, size=14)] + list(extra)
            for _ in range(n)]


def _serve(teng, jeng, prompts, tag=""):
    def reqs(cls):
        return [cls(rid=f"{tag}{i}", input_ids=list(p), max_new_tokens=6,
                    eos_ids=(), logprobs=True)
                for i, p in enumerate(prompts)]

    return drain_engine(teng, reqs(Request)), drain_engine(jeng,
                                                           reqs(JRequest))


@pytest.mark.parametrize("family", sorted(moe.FAMILIES))
def test_moe_family_engine_matches_jax_engine(family):
    got, want = _serve(*_engines(family), _prompts())
    for rid, w in want.items():
        assert len(got[rid].output_ids) == 6
        assert got[rid].output_ids == w.output_ids, rid


@pytest.mark.parametrize("family", ["mixtral", "deepseek"])
def test_moe_engine_prefix_hits_match_jax_engine(family):
    teng, jeng = _engines(family, radix=True)
    first = _prompts()
    _serve(teng, jeng, first, "a")
    got, want = _serve(teng, jeng, _prompts(extra=(5, 6, 7)), "b")
    for rid, w in want.items():
        assert got[rid].output_ids == w.output_ids, rid
        assert got[rid].n_cached == w.n_cached > 0, rid
    assert teng.check_memory() == jeng.check_memory()
