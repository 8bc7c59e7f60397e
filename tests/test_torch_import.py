"""The port stands alone: importing every module of aurora_tpu_torch (the
entry points of cli.infer, serve.runtime, apis and __main__, the loader
models.convert, generate.engine / generate.beam and the HTTP server
serve.api with its CLIs named among them),
serving a tiny multimodal request, generating greedy and beam captions,
starting the HTTP server (serve/api.py) and having /health and /generate
answer 200, running the Runtime with a stop string, a regex and a prompt
past the largest bucket (chunked prefill), running a lang.py program over
the server (a regex gen and a select), taking one
multimodal train step, running the eval adapter's simple_evaluate
on the built-in VDC task (its hooks named by dotted strings that resolve
at run time) and two steps of the training CLI from PNG images on the
CPU loads neither JAX nor the JAX package,
nor aiohttp, which the script blocks (the GPU host has none). Runs in a
fresh interpreter (this test process has JAX)."""

import json
import os
import subprocess
import sys

import numpy as np

from utils import make_tiny_xtuner_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import http.client, importlib, json, pkgutil, sys
sys.modules["aiohttp"] = None       # the GPU host has none: block it
import numpy as np
import torch
import aurora_tpu_torch
for m in pkgutil.walk_packages(aurora_tpu_torch.__path__, "aurora_tpu_torch."):
    importlib.import_module(m.name)
for name in ("cli.infer", "serve.runtime", "apis", "__main__",
             "models.convert", "generate.engine", "generate.beam",
             "serve.api", "cli.serve", "cli.chat", "cli.bench_latency",
             "cli.bench_serving", "utils.http", "lang", "serve.fsm",
             "serve.constrained"):
    importlib.import_module("aurora_tpu_torch." + name)

from aurora_tpu_torch.models.aurora import AuroraConfig, init_aurora
from aurora_tpu_torch.serve.engine import EngineConfig, ServeEngine
from aurora_tpu_torch.serve.multimodal import AuroraCapServing


class Tok:
    eos_token_id = 2

    def encode(self, text, add_special_tokens=True):
        ids = [3 + b % 200 for b in text.encode()]
        return [1] + ids if add_special_tokens else ids

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(0x4E00 + i) for i in ids if i > 2)


cfg = AuroraConfig.tiny()
model = init_aurora(cfg, device="cpu", dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0))
mm = AuroraCapServing(model, Tok(), kept_ratio=0.5, image_size=56)
eng = ServeEngine(model.llm, cfg.llm, EngineConfig(
    max_batch=2, max_seq_len=96, prefill_buckets=(64,),
    kv_dtype=torch.float32, kv_chunk=32, decode_steps=4),
    embed_fn=mm.embed_fn)
rng = np.random.default_rng(0)
for i in range(2):
    frames = rng.integers(0, 256, size=(2, 56, 56, 3), dtype=np.uint8)
    eng.add_request(mm.build_request(f"r{i}", "<image> <image> Describe.",
                                     frames, max_new_tokens=5, eos_ids=()))
done = []
while eng.has_work():
    done += eng.step()
assert sorted(r.rid for r in done) == ["r0", "r1"]
assert all(len(r.output_ids) == 5 for r in done)
from aurora_tpu_torch.cli.infer import caption, preprocess_frames
from aurora_tpu_torch.serve.runtime import Runtime
px = preprocess_frames(frames, 56, "cpu")
for beams in (1, 2):
    assert isinstance(caption(model, cfg, Tok(), pixel_values=px,
                              prompt="Describe.", token_kept_ratio=0.5,
                              max_new_tokens=4, num_beams=beams), str)
from aurora_tpu_torch.serve.api import ServerThread, ServingLoop
engine = ServeEngine(model.llm, cfg.llm, EngineConfig(
    max_batch=2, max_seq_len=96, prefill_buckets=(64,),
    kv_dtype=torch.float32, kv_chunk=32), tokenizer=Tok())
with ServerThread(ServingLoop(engine, Tok())) as srv:
    for method, path, body in (("GET", "/health", None),
                               ("POST", "/generate", {"text": "hi",
                                                      "max_new_tokens": 3})):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request(method, path, body and json.dumps(body))
        r = conn.getresponse()
        assert r.status == 200, (path, r.status, r.read())
        r.read()
        conn.close()
    from aurora_tpu_torch import lang

    @lang.function
    def judge(s):
        s += lang.user("ok?")
        s += lang.assistant(lang.gen("a", max_tokens=4,
                                     regex="[\u4e05-\u4e08]{2,3}"))
        s += lang.assistant(lang.select("b", ["yes", "no"]))

    st = judge.run(lang.RuntimeEndpoint(srv.url))
    # Tok's decode is not its encode's inverse: compare the choices' ids
    assert 2 <= len(st["a"]) <= 3 and st["b"] in (
        Tok().decode(Tok().encode(c, False)) for c in ("yes", "no")), \
        st.captured
rt = Runtime(model.llm, cfg.llm, Tok(), engine_config=EngineConfig(
    max_batch=2, max_seq_len=96, prefill_buckets=(64,),
    kv_dtype=torch.float32, kv_chunk=32))
out = rt.generate(["ab", "cd"], max_new_tokens=6)
stop = out[0]["text"][1:3]
assert rt.generate(["ab", "cd"], max_new_tokens=6,
                   stop=[stop])[0]["finish_reason"] == "stop"
out = rt.generate(["ab"], max_new_tokens=6, regex="[\u4e05-\u4e08]{2,3}")
assert 2 <= len(out[0]["text"]) <= 3, out
assert len(rt.generate(input_ids=[[5] * 80],
                       max_new_tokens=6)[0]["output_ids"]) == 6
from aurora_tpu_torch.train.trainer import (TrainConfig, init_train_state,
                                            make_train_step)
tcfg = TrainConfig(lr=1e-3, max_steps=10, kept_ratio=0.5)
state = init_train_state(model, tcfg)
ids = torch.tensor([[5, -200, 7, 8, 9, 10, 11, 12]] * 2)
state, m = make_train_step(cfg, tcfg)(state, {
    "input_ids": ids, "labels": ids,
    "pixel_values": torch.rand((2, 1, 3, 56, 56))})
assert torch.isfinite(m["loss"]) and state.step == 1
import dataclasses, os
from aurora_tpu_torch.eval import api as eval_api
from aurora_tpu_torch.eval.evaluator import simple_evaluate
from aurora_tpu_torch.eval.models import AuroraCapEval
# the built-in VDC task as registered (its dotted hook strings resolve
# at run time), on AURORA_VDC_DIR's two videos, 4 tokens
eval_api.register_task(dataclasses.replace(
    eval_api._REGISTRY["vdc_short_test"],
    generation_kwargs={"max_new_tokens": 4, "temperature": 0.0}))
ev = AuroraCapEval(os.environ["AURORA_TEST_XTUNER_DIR"], num_frames=2,
                   image_size=56, device="cpu", dtype=torch.float32)
res = simple_evaluate(ev, ["vdc_short_test"], log_samples=True)
assert res["results"]["vdc_short_test"]["_n"] == 2, res
assert all(isinstance(s["pred"], str)
           for s in res["samples"]["vdc_short_test"])
# the training CLI: 2 pretrain steps from a PNG dataset, a checkpoint
from aurora_tpu_torch.cli import train as train_cli
run = train_cli.run(train_cli.parse_args([
    "--model_path", os.environ["AURORA_TEST_XTUNER_DIR"],
    "--data", os.environ["AURORA_TEST_TRAIN_DATA"], "--work_dir",
    os.environ["AURORA_TEST_TRAIN_DIR"], "--max_steps", "2",
    "--batch_size", "2", "--image_size", "56", "--max_length", "64",
    "--float32", "--device", "cpu"]))
assert len(run.history) == 2 and run.saves[-1]["step"] == 2
assert "jax" not in sys.modules, "jax was imported"
assert not any(m == "aurora_tpu" or m.startswith("aurora_tpu.")
               for m in sys.modules), "aurora_tpu was imported"
assert not any(m.startswith("aiohttp.") or m == "aiohttp" and
               sys.modules[m] is not None for m in sys.modules), \
    "aiohttp was imported"
print("OK")
'''


def test_port_imports_and_serves_without_jax(tmp_path):
    root, *_ = make_tiny_xtuner_dir(tmp_path / "model")
    vdc = tmp_path / "vdc"
    vdc.mkdir()
    rng = np.random.default_rng(0)
    with open(vdc / "short.jsonl", "w") as f:
        for i in range(2):
            np.save(vdc / f"v{i}.npy",
                    rng.integers(0, 256, (2, 56, 56, 3)).astype(np.uint8))
            f.write(json.dumps({"video_name": f"v{i}", "caption": "c",
                                "qa_list": []}) + "\n")
    from PIL import Image
    recs = []
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)
                        ).save(vdc / f"i{i}.png")
        recs.append({"image": str(vdc / f"i{i}.png"), "conversations": [
            {"from": "human", "value": "<image> what?"},
            {"from": "gpt", "value": f"image {i}"}]})
    with open(tmp_path / "train.json", "w") as f:
        json.dump(recs, f)
    env = dict(os.environ, PYTHONPATH=REPO, AURORA_VDC_DIR=str(vdc),
               AURORA_TEST_XTUNER_DIR=root,
               AURORA_TEST_TRAIN_DATA=str(tmp_path / "train.json"),
               AURORA_TEST_TRAIN_DIR=str(tmp_path / "run"))
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")
