"""Data-parallel serving (aurora_tpu_torch/serve/controller.py) and the
serving entry points over it, on the CPU in float32.

`MultiReplicaController` with two replicas on the CPU repeated (which
share one set of weights, as two replicas on one card do) under both
dispatch policies, and two replicas of tp 2 over four devices: every
replica gets work, every request's tokens equal a single engine's
(tests/test_serve.py:416; the single engine is held to the JAX engine by
tests/test_torch_engine.py), no slot leaks and flush_cache leaves 0
cached tokens. `update_weights` is atomic across the replicas: a refusal
by one leaves every replica on the old weights ("rolled back"), busy
replicas refuse, and an accepted update serves what a single engine
serves from the new weights. `launch_server(dp=2)` builds the controller
behind the HTTP app, and `cli/serve.py --tp 2 --dp 2` reaches it with
two replicas of two shards.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from aurora_tpu_torch.models.init import build
from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
from aurora_tpu_torch.serve import api
from aurora_tpu_torch.serve.controller import (MultiReplicaController,
                                               model_on)
from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
from aurora_tpu_torch.serve.scheduler import Request
from aurora_tpu_torch.serve.tp import visible_devices

from utils import drain_engine

CFG = LlamaConfig.tiny(vocab_size=128)
TOKENIZER = types.SimpleNamespace(eos_token_id=2)
ECFG = EngineConfig(max_batch=4, max_seq_len=64, num_slots=512,
                    prefill_buckets=(16, 32), kv_dtype=torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread: the suite runs several workers at
    once, and their intra-op pools would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed=0):
    return build(LlamaModel, CFG, device="cpu", dtype=torch.float32,
                 generator=torch.Generator().manual_seed(seed))


def _requests(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=str(i), input_ids=[int(x) for x in rng.integers(
        3, 128, size=5 + i)], max_new_tokens=4, eos_ids=(2,))
        for i in range(n)]


def _drain(ctl):
    done = {}
    for _ in range(200):
        for r in ctl.step():
            done[r.rid] = r
        if not ctl.has_work():
            break
    return done


def _single(model, reqs, **kw):
    eng = ServeEngine(model, CFG, ECFG, **kw)
    return {rid: r.output_ids for rid, r in drain_engine(eng, reqs).items()}


@pytest.fixture(scope="module")
def model_and_want():
    model = _model()
    return model, _single(model, _requests())


@pytest.mark.parametrize("dispatch,tp", [("shortest_queue", 1),
                                         ("round_robin", 1),
                                         ("shortest_queue", 2)])
def test_multi_replica_controller(model_and_want, dispatch, tp):
    model, want = model_and_want
    ecfg = dataclasses.replace(ECFG, tp=tp)
    ctl = MultiReplicaController(model, CFG, ecfg,
                                 devices=["cpu"] * (2 * tp),
                                 dispatch=dispatch)
    assert len(ctl.engines) == 2 and ctl.ecfg.tp == tp
    if tp == 1:     # replicas on one device share the weights
        assert all(e.runner.model is model for e in ctl.engines)
    reqs = _requests()
    for r in reqs:
        ctl.add_request(r)
    assert all(e.has_work() for e in ctl.engines)
    if dispatch == "round_robin":
        assert [len(e.sched.waiting) for e in ctl.engines] == [3, 3]
    assert len(ctl.sched.running) == 0
    done = _drain(ctl)
    assert {rid: r.output_ids for rid, r in done.items()} == want
    assert ctl.check_memory()["leaked"] == 0
    assert ctl.flush_cache() == 0
    stats = ctl.decode_stats()
    assert stats["running"] == stats["queued"] == 0


def test_controller_abort_and_fail_running(model_and_want):
    model, _ = model_and_want
    ctl = MultiReplicaController(model, CFG, ECFG, devices=["cpu", "cpu"],
                                 dispatch="round_robin")
    reqs = _requests(4)
    for r in reqs:
        ctl.add_request(r)
    assert ctl.abort("0") and not ctl.abort("nope")
    ctl.step()                          # admits the rest
    assert len(ctl.sched.running) == 3
    failed = ctl.fail_running()
    assert sorted(r.rid for r in failed) == ["1", "2", "3"]
    _drain(ctl)
    assert ctl.check_memory()["leaked"] == 0


def test_controller_update_weights_is_atomic(model_and_want, monkeypatch):
    model, want = model_and_want
    other = _model(seed=5)
    ctl = MultiReplicaController(model_on(model, "cpu"), CFG, ECFG,
                                 devices=["cpu", "cpu"])
    live = [e.runner.model.state_dict()["layers.0.q.weight"].clone()
            for e in ctl.engines]
    # one replica refuses: nothing changes anywhere
    real = ctl.engines[1].stage_weights
    monkeypatch.setattr(ctl.engines[1], "stage_weights",
                        lambda m: (False, "no room", []))
    ok, msg = ctl.update_weights(other)
    assert not ok and "replica 1" in msg and "rolled back" in msg
    for e, before in zip(ctl.engines, live):
        assert torch.equal(e.runner.model.state_dict()["layers.0.q.weight"],
                           before)
    monkeypatch.setattr(ctl.engines[1], "stage_weights", real)
    # busy replicas refuse
    r = _requests(1)[0]
    ctl.add_request(r)
    ctl.step()
    ok, msg = ctl.update_weights(other)
    assert not ok and "in flight" in msg
    _drain(ctl)
    # accepted: every replica serves the new weights
    ok, msg = ctl.update_weights(other)
    assert ok, msg
    reqs = _requests()
    for r in reqs:
        ctl.add_request(r)
    got = {rid: r.output_ids for rid, r in _drain(ctl).items()}
    assert got == _single(_model(seed=5), _requests()) != want


def test_launch_server_dp2_runs_a_controller(model_and_want, monkeypatch):
    """launch_server(dp=2) is no longer refused: its app's loop steps a
    MultiReplicaController of two replicas over visible_devices."""
    model, _ = model_and_want
    seen = {}

    async def fake_serve(app, host, port, started=None, stop=None):
        seen["engine"] = app.loop_.engine

    monkeypatch.setattr(api, "serve", fake_serve)
    api.launch_server(model, CFG, TOKENIZER, engine_cfg=ECFG, dp=2,
                      dispatch="round_robin")
    ctl = seen["engine"]
    assert isinstance(ctl, MultiReplicaController)
    assert len(ctl.engines) == 2 and ctl.dispatch == "round_robin"
    assert visible_devices("cpu", 3) == [torch.device("cpu")] * 3


def test_serve_cli_takes_tp_and_dp(tmp_path, monkeypatch):
    """`serve --tp 2 --dp 2` on a HF llama directory: two replicas of two
    shards each (the CPU repeated), and their tokens are a single
    engine's."""
    from aurora_tpu_torch.cli import serve as tserve
    from aurora_tpu_torch.data import text
    from aurora_tpu_torch.models import export
    model = _model()
    export._write(export.llama_state_dict(model, CFG),
                  export.llama_config_dict(CFG), str(tmp_path))
    seen = {}

    async def fake_serve(app, host, port, started=None, stop=None):
        seen["engine"] = app.loop_.engine

    monkeypatch.setattr(api, "serve", fake_serve)
    monkeypatch.setattr(text, "auto_tokenizer", lambda path: TOKENIZER)
    assert tserve.main(["--model_path", str(tmp_path), "--device", "cpu",
                        "--dtype", "float32", "--max-batch", "4",
                        "--num-slots", "256", "--tp", "2", "--dp", "2",
                        "--disable-radix-cache"]) == 0
    ctl = seen["engine"]
    assert len(ctl.engines) == 2 and ctl.ecfg.tp == 2
    assert all(len(e.runner.group.models) == 2 for e in ctl.engines)
    reqs = _requests(4)
    for r in reqs:
        ctl.add_request(r)
    got = {rid: r.output_ids for rid, r in _drain(ctl).items()}
    assert got == _single(model, _requests(4))


def test_model_on_copies_only_across_devices(model_and_want):
    """A replica on the weights' own device shares them; on another it
    gets its own copy there, the source as it was (the meta device stands
    in for a second card)."""
    model, _ = model_and_want
    assert model_on(model, "cpu") is model
    copy = model_on(model, "meta")
    assert copy is not model and copy.cfg == model.cfg
    assert all(t.device.type == "meta" for t in copy.state_dict().values())
    assert all(t.device.type == "cpu" for t in model.state_dict().values())
    assert copy.state_dict().keys() == model.state_dict().keys()
