"""The port stands alone: importing every module of aurora_tpu_torch (the
entry points of cli.infer, serve.runtime, apis and __main__, the loader
models.convert and generate.engine / generate.beam named among them),
serving a tiny multimodal request, generating greedy and beam captions
and running the Runtime with a stop string, and taking one multimodal
train step on the CPU loads neither JAX nor the JAX package. Runs in a
fresh interpreter (this test process has JAX)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import importlib, pkgutil, sys
import numpy as np
import torch
import aurora_tpu_torch
for m in pkgutil.walk_packages(aurora_tpu_torch.__path__, "aurora_tpu_torch."):
    importlib.import_module(m.name)
for name in ("cli.infer", "serve.runtime", "apis", "__main__",
             "models.convert", "generate.engine", "generate.beam"):
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
rt = Runtime(model.llm, cfg.llm, Tok(), engine_config=EngineConfig(
    max_batch=2, max_seq_len=96, prefill_buckets=(64,),
    kv_dtype=torch.float32, kv_chunk=32))
out = rt.generate(["ab", "cd"], max_new_tokens=6)
stop = out[0]["text"][1:3]
assert rt.generate(["ab", "cd"], max_new_tokens=6,
                   stop=[stop])[0]["finish_reason"] == "stop"
from aurora_tpu_torch.train.trainer import (TrainConfig, init_train_state,
                                            make_train_step)
tcfg = TrainConfig(lr=1e-3, max_steps=10, kept_ratio=0.5)
state = init_train_state(model, tcfg)
ids = torch.tensor([[5, -200, 7, 8, 9, 10, 11, 12]] * 2)
state, m = make_train_step(cfg, tcfg)(state, {
    "input_ids": ids, "labels": ids,
    "pixel_values": torch.rand((2, 1, 3, 56, 56))})
assert torch.isfinite(m["loss"]) and state.step == 1
assert "jax" not in sys.modules, "jax was imported"
assert not any(m == "aurora_tpu" or m.startswith("aurora_tpu.")
               for m in sys.modules), "aurora_tpu was imported"
print("OK")
'''


def test_port_imports_and_serves_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("OK")
