"""The port's multi-process start-up and its data-parallel steps on the
CPU, mirroring tests/test_distributed.py (the reference's 2-process
jax.distributed smoke):

  * `parallel.distributed.init_distributed`: a single process is a no-op
    (False); a multi-process environment that cannot form a group raises
    rather than run as one process; a CUDA rank (the default, also for
    `parallel.mesh.create_mesh`) on a host without a card raises;
  * 2 ranks started under a torchrun environment (tests/torch_mp_worker.py,
    suite "dp") join through `init_distributed` and take one step on dp 2
    with other rows each: their losses and the checksums of their
    updated parameters are equal bit for bit, and the step is the
    one-process step on the whole batch; the same on fsdp 2, whose ranks
    hold half the trainable bytes each;
  * `python -m aurora_tpu_torch train --mesh sp=2` on 2 ranks under a
    torchrun environment on tiny data: rank 0 alone logs and checkpoints,
    its losses are the one-process run's, and its checkpoint resumes a
    one-process TrainState.
Tolerances as tests/test_torch_train_sp.py: loss and grad norm 1e-5
relative; parameters after one AdamW step within 0.02·lr where the
one-process gradient exceeds 1e-6 (the first step is about lr·sign(g)).
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_mp_worker as W
from aurora_tpu_torch.cli import infer as tinfer
from aurora_tpu_torch.cli import train as tcli
from aurora_tpu_torch.parallel import distributed
from aurora_tpu_torch.train import checkpoint as tckpt
from aurora_tpu_torch.train import trainer as ttrainer
from aurora_tpu_torch.train.configs import STAGES

from utils import make_tiny_xtuner_dir  # noqa: E402

STEP_ATOL = 0.02 * W.LR
_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
        "LOCAL_WORLD_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_init_distributed_is_a_no_op_for_one_process(clean_env):
    assert distributed.init_distributed(device_type="cpu") is False
    clean_env.setenv("WORLD_SIZE", "1")
    assert distributed.init_distributed(device_type="cpu") is False
    assert distributed.world_size() == 1 and distributed.rank() == 0


def test_init_distributed_refuses_to_fall_back(clean_env):
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="single process"):
        distributed.init_distributed(device_type="cpu")
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    clean_env.setenv("MASTER_PORT", "1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            distributed.init_distributed(device_type="cuda")
    assert not torch.distributed.is_initialized()


def test_mesh_defaults_to_the_card_and_refuses_without_one(clean_env):
    """With no device_type, init_distributed and create_mesh take the
    card; where none is visible they raise, in one process or under a
    multi-process environment, rather than carry on on the CPU."""
    from aurora_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    clean_env.setattr(torch.cuda, "device_count", lambda: 0)
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card is visible"):
        distributed.init_distributed()
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match="no card is visible"):
        distributed.init_distributed()
    with pytest.raises(RuntimeError, match="no card is visible"):
        create_mesh(MeshConfig(sp=2))
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("dp")
    W.launch("dp", 2, str(outdir))
    return [np.load(outdir / f"dp_rank{r}.npz") for r in range(2)]


def _one_process_step():
    model = W.dp_model()
    tcfg = ttrainer.TrainConfig(lr=W.LR, max_steps=10, warmup_ratio=0.0,
                                remat=True)
    state = ttrainer.init_train_state(model, tcfg)
    batch = W.dp_batch()
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    with ttrainer.repeatable_step():
        loss, _ = ttrainer.aurora_forward(
            model, batch["input_ids"], batch["pixel_values"],
            attention_mask=batch["attention_mask"], labels=batch["labels"],
            remat=True)
        got = torch.autograd.grad(loss, list(named.values()),
                                  allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), got)}
    _, m = ttrainer.make_train_step(model.cfg, tcfg)(state, batch)
    return m, named, grads, model


def test_two_ranks_join_through_the_torchrun_environment(dp_ranks):
    assert [int(r["world"]) for r in dp_ranks] == [2, 2]
    assert [int(r["rank"]) for r in dp_ranks] == [0, 1]


@pytest.mark.parametrize("case", list(W.DP_CASES))
def test_data_parallel_ranks_agree_bit_for_bit(dp_ranks, case):
    a, b = dp_ranks
    assert not np.array_equal(a[f"{case}/rows"], b[f"{case}/rows"])
    for key in ("loss", "grad_norm", "ntokens", "checksum"):
        assert a[f"{case}/{key}"] == b[f"{case}/{key}"], key
    assert float(a[f"{case}/loss"]) > 0


@pytest.mark.parametrize("case", list(W.DP_CASES))
def test_data_parallel_step_is_the_one_process_step(dp_ranks, case):
    m, named, grads, model = _one_process_step()
    got = dp_ranks[0]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[f"{case}/{key}"]),
                                   float(m[key]), rtol=1e-5, err_msg=key)
    for name, p in named.items():
        sure = np.abs(grads[name].numpy()) > 1e-6
        np.testing.assert_allclose(got[f"{case}/param/{name}"][sure],
                                   p.detach().numpy()[sure], rtol=0,
                                   atol=STEP_ATOL, err_msg=name)
    full = sum(p.numel() * p.element_size() for p in model.parameters())
    if case == "fsdp2":
        for r in dp_ranks:
            assert full / 2 <= int(r["fsdp2/shard_bytes"]) <= full / 2 + 64
    else:
        assert int(got["dp2/shard_bytes"]) == full


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    from PIL import Image
    rng = np.random.default_rng(0)
    base = tmp_path_factory.mktemp("train_cli_mesh")
    root, *_ = make_tiny_xtuner_dir(base / "model")
    os.makedirs(base / "imgs")
    records = []
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)
                        ).save(base / "imgs" / f"{i}.png")
        records.append({"image": f"{i}.png", "conversations": [
            {"from": "human", "value": "<image> describe"},
            {"from": "gpt", "value": f"caption {i}" + " and more" * i}]})
    with open(base / "data.json", "w") as f:
        json.dump(records, f)
    return base, root


def _cli_argv(base, root, work, *extra):
    return ["--stage", "language", "--model_path", str(root), "--data",
            str(base / "data.json"), "--image_folder", str(base / "imgs"),
            "--work_dir", str(base / work), "--max_steps", "2",
            "--batch_size", "2", "--image_size", "56", "--max_length", "128",
            "--log_interval", "1", "--float32", "--device", "cpu",
            "--num_workers", "1", *extra]


def test_train_cli_on_two_ranks_with_sp2(cli_data, clean_env):
    base, root = cli_data
    outs = W.launch("cli", 2, str(base), module="aurora_tpu_torch",
                    args=["train", *_cli_argv(base, root, "mesh",
                                              "--mesh", "sp=2")])
    logged = [json.loads(ln) for ln in outs[0].splitlines()
              if ln.startswith("{")]
    assert [r["step"] for r in logged] == [1, 2]
    assert not any(ln.startswith("{") for ln in outs[1].splitlines())
    with open(base / "mesh" / "train_log.jsonl") as f:
        assert [json.loads(ln)["loss"] for ln in f] == [r["loss"]
                                                       for r in logged]
    one = tcli.run(tcli.parse_args(_cli_argv(base, root, "one")))
    np.testing.assert_allclose([r["loss"] for r in logged],
                               [round(h["loss"], 4) for h in one.history],
                               rtol=0, atol=1.5e-4)
    # the checkpoint is the one-process layout: a one-process TrainState
    # of the same model resumes from it, with rank 0's weights: within
    # what two AdamW steps can move a weight apart (3·lr), and at the
    # median within the first step's bound (0.02·lr)
    assert tckpt.latest_step(str(base / "mesh" / "checkpoints")) == 2
    fresh, _, _ = tinfer.load_model(str(root), torch.float32, "cpu")
    tcfg = STAGES["language"]().train
    state = tckpt.restore_checkpoint(str(base / "mesh" / "checkpoints"),
                                     ttrainer.init_train_state(fresh, tcfg))
    assert state.step == 2
    lr = tcfg.lr
    diffs = []
    for (name, p), q in zip(fresh.named_parameters(),
                            one.model.parameters()):
        d = (p - q).abs().detach()
        assert float(d.max()) <= 3 * lr, name
        diffs.append(d.reshape(-1))
    assert float(torch.cat(diffs).median()) <= 0.02 * lr
