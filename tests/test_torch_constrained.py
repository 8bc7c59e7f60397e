"""Constrained decoding with jump-forward: the port's ServeEngine against
the JAX ServeEngine on the CPU.

Both engines serve the same requests from the same float32 weights (the
JAX ones bridged into the port) with the same constraint objects' copies
(serve/fsm.py RegexConstraint and serve/constrained.py ChoiceConstraint
of each package), the JAX kernels in interpret mode. Greedy tokens must
be equal, and so must `engine._steps` (decode steps: jump-forward writes
the forced stretches through extend calls instead):

* tests/test_fsm.py's two regex cases, beside an unconstrained lane whose
  tokens equal its own run alone (no mask leaks across lanes);
* token healing with tests/test_serve.py's FakeTok: forced [5, 6]
  ("ab" + "cd") re-tokenized to the canonical [7] ("abcd"), the row
  rewound to the first divergence;
* the same heal with packed int4 KV after a prompt of 139 tokens
  (prefilled in chunks), so that the re-extend writes the high nibble of
  a byte whose low nibble holds prompt token 11 (a packed segment keeps
  positions p and p + 128 in one byte): the rows' codes agree with the
  JAX engine's;
* a choice constraint, and a regex under min_new_tokens.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.generate.sampler import SamplingParams as JSamplingParams
from aurora_tpu.models.llama import LlamaConfig as JLlamaConfig
from aurora_tpu.models.llama import init_llama_params
from aurora_tpu.serve import constrained as jconstrained
from aurora_tpu.serve import fsm as jfsm
from aurora_tpu.serve.engine import EngineConfig as JEngineConfig
from aurora_tpu.serve.engine import ServeEngine as JServeEngine
from aurora_tpu.serve.scheduler import Request as JRequest
from aurora_tpu_torch import bridge
from aurora_tpu_torch.generate.sampler import SamplingParams
from aurora_tpu_torch.ops.pallas.ragged_attention import unpack_int4_rows
from aurora_tpu_torch.serve import constrained as tconstrained
from aurora_tpu_torch.serve import fsm as tfsm
from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
from aurora_tpu_torch.serve.scheduler import Request

from utils import drain_engine, make_tiny_tokenizer

ENGINE = dict(max_batch=2, max_seq_len=128, num_slots=512,
              prefill_buckets=(16, 64))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg = JLlamaConfig.tiny(vocab_size=512)
    tree = jax.device_get(init_llama_params(jax.random.PRNGKey(11), cfg,
                                            dtype=jnp.float32))
    model = bridge.llama_from_params(tree, bridge.llama_config_from(cfg),
                                     dtype=torch.float32, device="cpu")
    tok = make_tiny_tokenizer(str(tmp_path_factory.mktemp("tok")))
    return cfg, tree, model, tok


def _engines(tiny, tokenizer=None, **kw):
    cfg, tree, model, tok = tiny
    tokenizer = tok if tokenizer is None else tokenizer
    common = {**ENGINE, **kw}
    return (JServeEngine(tree, cfg, JEngineConfig(kv_dtype=jnp.float32,
                                                  **common),
                         tokenizer=tokenizer),
            ServeEngine(model, model.cfg,
                        EngineConfig(kv_dtype=torch.float32, **common),
                        tokenizer=tokenizer))


def _surface_text(tok, ids):
    """The tiny WordLevel tokenizer joins tokens with spaces on a batch
    decode: the text is the tokens' surfaces joined."""
    return "".join(tok.decode([t], skip_special_tokens=True) for t in ids)


@pytest.mark.parametrize("pattern", [
    r'\{"age": [0-9]{1,3}\}',
    r'\{"result": "(yes|no)", "confidence": [0-9]\}'])
def test_regex_matches_jax_with_a_free_lane(tiny, pattern):
    """The regex lane: the JAX engine's tokens and decode steps, a text
    that full-matches; the unconstrained lane beside it: the JAX engine's
    tokens, which are also those of its run alone."""
    cfg, _, _, tok = tiny
    rng = np.random.default_rng(0)
    ids = [int(x) for x in rng.integers(3, 500, size=8)]
    free = [int(x) for x in rng.integers(3, 500, size=11)]
    out = {}
    jeng, teng = _engines(tiny)
    for side, eng, cls, fsm in (("jax", jeng, JRequest, jfsm),
                                ("port", teng, Request, tfsm)):
        c = fsm.RegexConstraint(pattern, tok, cfg.vocab_size, eos_ids=(2,))
        done = drain_engine(eng, [
            cls(rid="re", input_ids=ids, max_new_tokens=80, eos_ids=(2,),
                constraint=c),
            cls(rid="free", input_ids=free, max_new_tokens=12,
                eos_ids=())])
        steps = eng._steps
        alone = drain_engine(eng, [cls(rid="alone", input_ids=free,
                                       max_new_tokens=12, eos_ids=())])
        out[side] = (done, steps, alone)
        assert eng.check_memory()["leaked"] == 0
    (jdone, jsteps, jalone), (tdone, tsteps, talone) = out["jax"], out["port"]
    assert tdone["re"].output_ids == jdone["re"].output_ids
    assert tsteps == jsteps
    text = _surface_text(tok, tdone["re"].output_ids)
    assert re.fullmatch(pattern, text), text
    assert tdone["re"].finished.value == "stop"
    assert tdone["free"].output_ids == jdone["free"].output_ids \
        == talone["alone"].output_ids == jalone["alone"].output_ids


def test_choices_match_jax(tiny):
    rng = np.random.default_rng(1)
    ids = [int(x) for x in rng.integers(3, 500, size=9)]
    choices = [[7, 8, 9], [7, 20], [50]]
    jeng, teng = _engines(tiny)
    want = drain_engine(jeng, [JRequest(
        rid="c", input_ids=ids, max_new_tokens=8, eos_ids=(-1,),
        constraint=jconstrained.ChoiceConstraint(choices))])
    got = drain_engine(teng, [Request(
        rid="c", input_ids=ids, max_new_tokens=8, eos_ids=(-1,),
        constraint=tconstrained.ChoiceConstraint(choices))])
    assert got["c"].output_ids == want["c"].output_ids
    assert got["c"].output_ids in choices
    assert got["c"].finished.value == "stop"
    assert teng._steps == jeng._steps
    assert teng.check_memory()["leaked"] == 0


def test_regex_under_min_new_tokens_matches_jax(tiny):
    """A digits regex that accepts after one token, with min_new_tokens 4:
    eos stays masked until the fourth token, in both engines."""
    cfg, _, _, tok = tiny
    rng = np.random.default_rng(2)
    ids = [int(x) for x in rng.integers(3, 500, size=10)]
    out = {}
    jeng, teng = _engines(tiny)
    for side, eng, cls, fsm, samp in (
            ("jax", jeng, JRequest, jfsm, JSamplingParams),
            ("port", teng, Request, tfsm, SamplingParams)):
        out[side] = drain_engine(eng, [cls(
            rid="m", input_ids=ids, max_new_tokens=12, eos_ids=(2,),
            sampling=samp(min_new_tokens=4),
            constraint=fsm.RegexConstraint(r"[0-9]{1,10}", tok,
                                           cfg.vocab_size, eos_ids=(2,)))])
    got, want = out["port"]["m"], out["jax"]["m"]
    assert got.output_ids == want.output_ids
    digits = [t for t in got.output_ids if t != 2]
    assert len(digits) >= 4
    assert re.fullmatch(r"[0-9]{1,10}", _surface_text(tok, digits))


SURFACES = {5: "ab", 6: "cd", 7: "abcd"}


class FakeTok:
    """tests/test_serve.py's healing tokenizer: "ab" + "cd" re-encodes as
    the one token "abcd"; other ids as <id>."""

    def decode(self, ids, **kw):
        return "".join(SURFACES.get(int(t), f"<{int(t)}>") for t in ids)

    def encode(self, text, **kw):
        out, i = [], 0
        toks = sorted(SURFACES.items(), key=lambda kv: -len(kv[1]))
        while i < len(text):
            if text[i] == "<":
                j = text.index(">", i)
                out.append(int(text[i + 1:j]))
                i = j + 1
                continue
            for tid, s in toks:
                if text.startswith(s, i):
                    out.append(tid)
                    i += len(s)
                    break
            else:
                raise ValueError(text[i:])
        return out


class ForceOnce:
    """Forces "ab", "cd" once, then nothing is constrained."""

    def __init__(self):
        self.fired = False
        self.finished = False

    def mask(self, v):
        return np.ones((v,), bool)

    def advance(self, tok):
        pass

    def forced_run(self, budget):
        if self.fired:
            return []
        self.fired = True
        return [5, 6]


@pytest.mark.parametrize("kv_quant", ["none", "int4"])
def test_healing_rewind_matches_jax(tiny, kv_quant):
    """The forced [5, 6] after the first token t0 heals to [t0, 7]: the
    row is rewound to position P = 139 (the prompt's length, prefilled in
    chunks of 64; with packed int4 KV the re-extend writes the high
    nibble of the byte whose low nibble holds prompt token 11) and the
    rest decodes from there. Tokens equal to the JAX engine's; with int4
    KV every written code within one step of the JAX rows' and the scales
    close, the mate nibbles included."""
    ids = [int(x) for x in np.random.default_rng(3).integers(8, 500,
                                                             size=139)]
    jeng, teng = _engines(tiny, FakeTok(), kv_quant=kv_quant,
                          max_seq_len=256)
    out = {}
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        out[eng is teng] = drain_engine(eng, [cls(
            rid="h", input_ids=list(ids), max_new_tokens=6, eos_ids=(-1,),
            constraint=ForceOnce())])["h"]
    want, got = out[False], out[True]
    assert got.output_ids == want.output_ids
    assert got.output_ids[1] == 7 and 5 not in got.output_ids[:2]
    assert teng._steps == jeng._steps
    if kv_quant == "int4":
        n = len(ids) + len(got.output_ids) - 1      # positions written
        for name in ("k", "v"):
            t = unpack_int4_rows(teng.runner.rows[name][:, 0])[:, :, :n]
            j = unpack_int4_rows(torch.as_tensor(np.array(
                jeng.rows[name][:, 0])))[:, :, :n]
            assert (t.int() - j.int()).abs().max() <= 1, name
            ts = teng.runner.rows[name + "s"][:, 0, :, :n]
            js = torch.as_tensor(np.array(jeng.rows[name + "s"][:, 0]))
            torch.testing.assert_close(ts, js[:, :, :n], rtol=1e-4,
                                       atol=1e-6)
