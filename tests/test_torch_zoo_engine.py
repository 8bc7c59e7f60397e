"""The dense model zoo's checkpoints (tests/test_torch_zoo.py) served by
the port's ServeEngine against the JAX ServeEngine, on the CPU: two
14-token prompts in one extend wave, then 6 greedy tokens each
(decode_steps 2), fp32 KV: every family's tokens exactly (int8 and
packed int4 KV: tests/test_torch_zoo_quant.py). Float32 weights; the JAX
kernels run in interpret mode.
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

import test_torch_zoo as zoo
from utils import drain_engine


def _serve_both(family, kv_quant):
    """Both engines: two 14-token prompts in one extend wave, then 6
    greedy tokens each (decode_steps 2), logprobs on."""
    _, jcfg, tree, model = zoo._pair(family)
    common = dict(max_batch=2, max_seq_len=48, prefill_buckets=(16,),
                  kv_chunk=16, decode_steps=2, kv_quant=kv_quant,
                  disable_radix_cache=True)
    jeng = JServeEngine(tree, jcfg, JEngineConfig(kv_dtype=jnp.float32,
                                                  **common))
    teng = ServeEngine(model, model.cfg, EngineConfig(kv_dtype=torch.float32,
                                                      **common))
    rng = np.random.default_rng(13)
    prompts = [[int(x) for x in rng.integers(3, zoo.V, size=14)]
               for _ in range(2)]

    def reqs(cls):
        return [cls(rid=str(i), input_ids=list(p), max_new_tokens=6,
                    eos_ids=(), logprobs=True)
                for i, p in enumerate(prompts)]

    return drain_engine(teng, reqs(Request)), drain_engine(jeng,
                                                           reqs(JRequest))


@pytest.mark.parametrize("family", sorted(zoo.FAMILIES))
def test_family_engine_matches_jax_engine(family):
    got, want = _serve_both(family, "none")
    for rid, w in want.items():
        assert len(got[rid].output_ids) == 6
        assert got[rid].output_ids == w.output_ids, rid
