"""The port's training CLI and what it reaches, against the JAX package in
one process, on the CPU at tiny sizes (`make_tiny_xtuner_dir`, 56 px PNG
images, fp32):

  * `cli.train` (the pretrain stage) gives per-step losses and grad
    norms within 1e-5 relative of the JAX `make_train_step` run on the
    batches the reference's CLI builds (its dataset, sampler, index
    stream and collation, in-process); the images are at the tower's
    size, so neither side resamples and the frames are equal; with
    --pack_max_length it trains on the reference's packs (the packed
    loss is held to JAX's in tests/test_torch_data.py);
  * a run resumed from a checkpoint repeats the uninterrupted run's
    losses, grad norms and final weights bit for bit, and `max_keep`
    keeps the newest two steps;
  * LoRA and QLoRA (int8, int4): the quantized base's codes and scales
    equal the reference's `quantize_base` bit for bit, and one step's
    loss, grad norm and adapter update match the JAX step from the same
    (bridged) adapters;
  * `--quant` without `--lora_r` is rejected, as in the reference;
  * list-cfg, copy-cfg and check-custom-dataset print what the
    reference's print;
  * the vision stage from a copy-cfg JSON (grad_accum 2, slowfast), the
    (Q)LoRA CLI and the apis builders run.

Tolerances: losses and grad norms 1e-5 relative (fp32, the same batches;
both sides sum in other orders). An adapter after one AdamW step: the
step moves each element by about lr·sign(g), so an element whose
gradient is within its fp32 error of 0 may move anywhere in ±lr; the
bound is set on the step, |Δ| <= 0.02·lr (as tests/test_torch_train.py).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.cli import cfg_tools as jcfg_tools
from aurora_tpu.cli import infer as jinfer
from aurora_tpu.data import collate as jcollate
from aurora_tpu.data import dataset as jdataset
from aurora_tpu.data.prefetch import index_stream as jindex_stream
from aurora_tpu.data.sampler import LengthGroupedSampler as JSampler
from aurora_tpu.models import aurora as jaurora
from aurora_tpu.train import configs as jconfigs
from aurora_tpu.train import lora as jlora
from aurora_tpu.train import quant as jquant
from aurora_tpu.train import trainer as jtrainer
from aurora_tpu.utils.templates import PROMPT_TEMPLATE
from aurora_tpu_torch import apis, bridge
from aurora_tpu_torch.cli import cfg_tools as tcfg_tools
from aurora_tpu_torch.cli import infer as tinfer
from aurora_tpu_torch.cli import train as tcli
from aurora_tpu_torch.data import dataset as tdataset
from aurora_tpu_torch.train import checkpoint as tckpt
from aurora_tpu_torch.train import lora as tlora
from aurora_tpu_torch.train import quant as tquant
from aurora_tpu_torch.train import trainer as ttrainer

from utils import make_tiny_xtuner_dir  # noqa: E402

RTOL = 1e-5
STAGES = {"pretrain": jconfigs.pretrain_stage,
          "language": jconfigs.language_stage}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from PIL import Image
    rng = np.random.default_rng(0)
    base = tmp_path_factory.mktemp("train_cli")
    root, *_ = make_tiny_xtuner_dir(base / "model")
    img_dir = base / "imgs"
    os.makedirs(img_dir)
    records = []
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)
                        ).save(img_dir / f"{i}.png")
        records.append({"image": f"{i}.png", "conversations": [
            {"from": "human", "value": "<image> describe"},
            {"from": "gpt", "value": f"caption {i}" + " and more" * i}]})
    # two multi-frame samples for the vision stage's slowfast path
    for i in range(2):
        records.append({"image": [f"{j}.png" for j in range(i, i + 3)],
                        "conversations": [
                            {"from": "human",
                             "value": "<image> <image> <image> video"},
                            {"from": "gpt", "value": f"clip {i}"}]})
    data = base / "data.json"
    with open(data, "w") as f:
        json.dump(records[:8], f)
    video = base / "video.json"
    with open(video, "w") as f:
        json.dump(records[8:], f)
    return {"base": base, "root": root, "data": str(data),
            "video": str(video), "imgs": str(img_dir)}


def _argv(w, work, *extra, stage="pretrain", steps=3):
    return ["--stage", stage, "--model_path", w["root"], "--data",
            w["data"], "--image_folder", w["imgs"], "--work_dir",
            str(w["base"] / work), "--max_steps", str(steps),
            "--batch_size", "2", "--image_size", "56", "--max_length",
            "128", "--log_interval", "1", "--float32", "--device", "cpu",
            *extra]


def _jax_cli_steps(w, stage_name, steps, batch_size=2, max_length=128,
                   image_size=56, seed=0):
    """The reference CLI's loop in-process: its dataset, sampler, index
    stream, bucketed collation, and the jitted make_train_step."""
    params, acfg, tok = jinfer.load_model(w["root"], dtype=jnp.float32)
    stage = STAGES[stage_name](max_steps=steps)
    acfg = dataclasses.replace(acfg, slowfast=stage.slowfast)
    ds = jdataset.AuroraDataset(w["data"], tok, image_folder=w["imgs"],
                                map_fn=jdataset.aurora_map_fn,
                                template=PROMPT_TEMPLATE.vicuna,
                                max_length=max_length,
                                image_size=image_size)
    sampler = JSampler(ds.modality_length(), batch_size, seed=seed)
    tcfg = stage.train
    state = jtrainer.init_train_state(params, tcfg)
    step = jax.jit(jtrainer.make_train_step(
        acfg, tcfg, jtrainer.make_optimizer(params, tcfg)))
    it = jindex_stream(sampler, batch_size)
    out = []
    for _ in range(steps):
        samples = [ds[i] for i in next(it)]
        longest = max(len(s["input_ids"]) for s in samples)
        bucket = min(max_length, ((longest + 63) // 64) * 64)
        batch = jcollate.default_collate_fn(samples, max_length=bucket)
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append({k: float(v) for k, v in m.items()})
    return out


def _assert_steps_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["ntokens"] == w["ntokens"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=RTOL)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)


def test_cli_pretrain_matches_jax_steps(workdir, capsys):
    res = tcli.run(tcli.parse_args(_argv(workdir, "pre")))
    _assert_steps_match(res.history, _jax_cli_steps(workdir, "pretrain", 3))
    out = capsys.readouterr().out
    recs = [json.loads(ln) for ln in out.splitlines()
            if ln.startswith("{")]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert set(recs[0]) == {"step", "loss", "grad_norm", "lr", "tgs",
                            "tflops", "eta_s"}
    assert "exposed data wait" in out
    with open(workdir["base"] / "pre" / "train_log.jsonl") as f:
        assert [json.loads(ln) for ln in f] == recs
    # frozen stage: the LLM and the ViT did not move
    fresh, _, _ = tinfer.load_model(workdir["root"], torch.float32, "cpu")
    for name in ("llm", "visual_encoder"):
        for (n, a), b in zip(getattr(res.model, name).state_dict().items(),
                             getattr(fresh, name).state_dict().values()):
            assert torch.equal(a, b), n
    assert not torch.equal(res.model.projector.layers[0].weight,
                           fresh.projector.layers[0].weight)


def test_cli_language_stage_packed(workdir, monkeypatch):
    """The packed path of the CLI: the batches it trains on are the
    reference's packs (ids, labels, segments, frames equal), with at least
    two documents in a pack; tests/test_torch_data.py holds the packed
    loss to JAX's."""
    seen = []
    orig = tcli._batch_to_device

    def spy(batch, device, dtype):
        seen.append(batch)
        return orig(batch, device, dtype)

    monkeypatch.setattr(tcli, "_batch_to_device", spy)
    res = tcli.run(tcli.parse_args(_argv(
        workdir, "packed", "--pack_max_length", "160", "--num_workers", "1",
        "--prefetch", "1", stage="language", steps=2)))
    assert len(res.history) == 2
    assert all(np.isfinite(h["loss"]) for h in res.history)
    # the reference's packs of the same data, in the sampler's order
    params_unused, acfg, tok = jinfer.load_model(workdir["root"],
                                                 dtype=jnp.float32)
    ds = jdataset.AuroraDataset(workdir["data"], tok,
                                image_folder=workdir["imgs"],
                                map_fn=jdataset.aurora_map_fn,
                                template=PROMPT_TEMPLATE.vicuna,
                                max_length=128, image_size=56)
    n_vis = jaurora.num_visual_tokens(acfg, 0.1, 56, 56)
    packer = jcollate.SoftPackerMM(ds.text_data, 160, n_visual_tokens=n_vis,
                                   dataset=ds)
    lens = [sum(len(ds.text_data[i]["input_ids"]) for i in p)
            for p in packer.packs]
    it = jindex_stream(JSampler(lens, 2), 2)
    for got in seen[:2]:
        want = jcollate.packed_collate_mm([packer[i] for i in next(it)])
        assert set(got) == set(want)
        for k, v in want.items():
            g = got[k]
            np.testing.assert_array_equal(
                g.numpy() if isinstance(g, torch.Tensor) else g, v,
                err_msg=k)
    assert max(int(b["segment_ids"].max()) for b in seen[:2]) >= 1


def test_cli_resume_is_bitwise_and_keeps_two(workdir, capsys):
    straight = tcli.run(tcli.parse_args(_argv(
        workdir, "straight", "--checkpoint_interval", "1", steps=4)))
    ckpt = workdir["base"] / "straight" / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["3", "4"]        # max_keep=2
    tcli.run(tcli.parse_args(_argv(
        workdir, "resumed", "--checkpoint_interval", "2", steps=2)))
    capsys.readouterr()
    resumed = tcli.run(tcli.parse_args(_argv(
        workdir, "resumed", "--checkpoint_interval", "10", "--resume",
        steps=4)))
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.start == 2
    assert [h["step"] for h in resumed.history] == [3, 4]
    for g, w in zip(resumed.history, straight.history[2:]):
        assert (g["loss"], g["grad_norm"], g["lr"]) == (
            w["loss"], w["grad_norm"], w["lr"])
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert tckpt.latest_step(workdir["base"] / "resumed" /
                             "checkpoints") == 4


def test_checkpoint_restores_in_place_and_skips_saved_steps(tmp_path):
    state = {"adapters": {"x": {"a": torch.arange(6.).reshape(2, 3)}},
             "opt_state": {"count": 3, "mu": [torch.ones(2)]}}
    assert tckpt.save_checkpoint(tmp_path, state, 5)
    assert not tckpt.save_checkpoint(tmp_path, state, 5)   # as orbax
    assert not tckpt.save_checkpoint(tmp_path, state, 4)
    target = {"adapters": {"x": {"a": torch.zeros(2, 3)}},
              "opt_state": {"count": 0, "mu": [torch.zeros(2)]}}
    a = target["adapters"]["x"]["a"]
    out = tckpt.restore_checkpoint(tmp_path, target)
    assert out["adapters"]["x"]["a"] is a and torch.equal(
        a, torch.arange(6.).reshape(2, 3))
    assert out["opt_state"]["count"] == 3
    bad = {"adapters": {"x": {"a": torch.zeros(3, 2)}},
           "opt_state": {"count": 0, "mu": [torch.zeros(2)]}}
    with pytest.raises(ValueError):
        tckpt.restore_checkpoint(tmp_path, bad)
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


# --------------------------------------------------------------------------
# LoRA and QLoRA
# --------------------------------------------------------------------------

QUANTS = ("none", "int8", "int4")


@pytest.fixture(scope="module")
def lora_setup(workdir):
    """The JAX side: the xtuner dir's params, adapters (numpy, B ≠ 0 so
    that A has a gradient), a text batch, and one (Q)LoRA step for each
    base, the three in one jit."""
    import optax
    params, acfg, _ = jinfer.load_model(workdir["root"], dtype=jnp.float32)
    lcfg = jlora.LoraConfig(r=4, alpha=8)
    rng = np.random.default_rng(7)
    layers = params["llm"]["layers"]
    adapters = {f"llm/layers/{n}": {
        "a": (0.02 * rng.standard_normal(
            (w.shape[0], w.shape[1], 4))).astype(np.float32),
        "b": (0.05 * rng.standard_normal(
            (w.shape[0], 4, w.shape[2]))).astype(np.float32)}
        for n, w in layers.items() if n in ("q", "k", "v", "o", "gate",
                                            "up", "down")}
    assert sorted(adapters) == sorted(jlora.lora_target_paths(params, lcfg))
    ids = rng.integers(3, 300, size=(2, 20))
    mask = np.ones((2, 20), bool)
    mask[1, 15:] = False
    labels = np.where(mask, ids, -100)
    labels[:, :4] = -100
    batch = {"input_ids": ids, "labels": labels, "attention_mask": mask}
    tcfg = dataclasses.replace(jconfigs.language_stage(max_steps=10).train,
                               lr=1e-3)
    bases = {q: params if q == "none" else jquant.quantize_base(
        params, bits=8 if q == "int8" else 4) for q in QUANTS}
    opt = optax.chain(optax.clip_by_global_norm(tcfg.grad_clip),
                      optax.adamw(jtrainer.lr_schedule(tcfg)))
    steps = {q: (jlora.make_lora_train_step if q == "none"
                 else jquant.make_qlora_train_step)(
        acfg, tcfg, bases[q], lcfg, opt).with_base for q in QUANTS}
    out = jax.jit(lambda ad, st, b, bs: {q: steps[q](ad, st, b, bs[q])
                                         for q in QUANTS})(
        adapters, opt.init(adapters),
        {k: jnp.asarray(v) for k, v in batch.items()}, bases)
    return (params, lcfg, adapters, batch, tcfg, bases,
            jax.device_get(out))


@pytest.mark.parametrize("quant", QUANTS)
def test_lora_step_matches_jax(workdir, lora_setup, quant):
    params, lcfg, adapters, batch, tcfg, bases, jout = lora_setup
    j_ad, _, jm = jout[quant]
    model, _, _ = tinfer.load_model(workdir["root"], torch.float32, "cpu")
    ttcfg = ttrainer.TrainConfig(**{
        f.name: getattr(tcfg, f.name)
        for f in dataclasses.fields(ttrainer.TrainConfig)})
    tl = tlora.LoraConfig(r=4, alpha=8)
    if quant != "none":
        tquant.quantize_base(model, bits=8 if quant == "int8" else 4)
        # the codes and scales are the reference's, bit for bit
        layers = bases[quant]["llm"]["layers"]
        kind = "q8" if quant == "int8" else "q4"
        for l, layer in enumerate(model.llm.layers):
            for name in ("q", "k", "v", "o", "gate", "up", "down"):
                ql = getattr(layer, name)
                assert isinstance(ql, tquant.QuantLinear)
                np.testing.assert_array_equal(
                    ql.q.numpy(), np.asarray(layers[name][kind][l]))
                np.testing.assert_array_equal(
                    ql.s.numpy(), np.asarray(layers[name]["s"][l]))
    t_ad = bridge.lora_adapters_from(adapters, device="cpu")
    start = {p: {k: v.detach().clone() for k, v in ab.items()}
             for p, ab in t_ad.items()}
    assert set(t_ad) == set(tlora.lora_target_paths(model, tl))
    opt_t = ttrainer.lora_optimizer(ttcfg)
    make_t = (tlora.make_lora_train_step if quant == "none"
              else tquant.make_qlora_train_step)
    t_step = make_t(model.cfg, ttcfg, model, tl, opt_t)
    state = opt_t.init(tlora.adapter_tensors(t_ad))
    t_ad, state, tm = t_step(t_ad, state, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(tm["ntokens"]) == int(jm["ntokens"])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=RTOL)
    assert "lr" not in tm and state["count"] == 1
    want = bridge.lora_adapters_from(j_ad, device="cpu")
    for path, ab in want.items():
        for k in ("a", "b"):
            got = t_ad[path][k].detach()
            assert not torch.equal(got, start[path][k]), (path, k)
            np.testing.assert_allclose(
                got.numpy(), ab[k].detach().numpy(), rtol=0,
                atol=0.02 * tcfg.lr, err_msg=f"{path}.{k}")


def test_merge_lora_matches_jax(workdir, lora_setup):
    params, lcfg, adapters = lora_setup[:3]
    want = jlora.merge_lora(params, jax.tree.map(jnp.asarray, adapters),
                            lcfg)
    model, cfg, _ = tinfer.load_model(workdir["root"], torch.float32, "cpu")
    tlora.merge_lora(model, bridge.lora_adapters_from(adapters,
                                                      device="cpu"),
                     tlora.LoraConfig(r=4, alpha=8))
    sd = bridge.llama_state_dict(jax.device_get(want["llm"]), cfg.llm)
    for name, w in sd.items():
        np.testing.assert_allclose(
            model.llm.state_dict()[name].numpy(), w.numpy(), rtol=0,
            atol=1e-7, err_msg=name)


def test_cli_qlora_trains_only_the_adapters(workdir, capsys):
    res = tcli.run(tcli.parse_args(_argv(
        workdir, "qlora", "--lora_r", "4", "--lora_alpha", "8", "--quant",
        "int4", stage="language", steps=2)))
    out = capsys.readouterr().out
    assert "quantized base:" in out and "(int4)" in out
    assert res.base_bytes["quantized"] < res.base_bytes["float"]
    with open(workdir["base"] / "qlora" / "lora.json") as f:
        assert json.load(f) == {"r": 4, "alpha": 8, "quant": "int4"}
    assert all(r["lr"] is None for r in map(
        json.loads, (ln for ln in out.splitlines() if ln.startswith("{"))))
    fresh, _, _ = tinfer.load_model(workdir["root"], torch.float32, "cpu")
    tquant.quantize_base(fresh, bits=4)
    a, b = res.model.state_dict(), fresh.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert any(bool(ab["b"].abs().max() > 0)
               for ab in res.state["adapters"].values())


def test_quant_without_lora_is_rejected(workdir, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(_argv(workdir, "bad", "--quant", "int8"))
    assert e.value.code == 2 and "--lora_r" in capsys.readouterr().err
    # a mesh of more than one rank needs the ranks torchrun starts
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(_argv(workdir, "bad", "--mesh", "dp=2"))
    assert e.value.code == 2 and "torchrun" in capsys.readouterr().err


# --------------------------------------------------------------------------
# the stage configs, cfg tools, the vision stage and apis
# --------------------------------------------------------------------------

def _port_text(text):
    return text.replace("aurora_tpu.", "aurora_tpu_torch.")


def test_list_cfg_matches_reference(capsys, monkeypatch):
    # the task registries are process-wide and other test files register
    # tasks in one side's only (tests/test_torch_eval.py holds the
    # registrations equal): both list the same tasks here
    from aurora_tpu.eval import api as jeval_api
    from aurora_tpu.eval import tasks as jtasks
    from aurora_tpu_torch.eval import api as teval_api
    from aurora_tpu_torch.eval import tasks as ttasks
    names = ["vdc_detailed_test", "vdc_short_test"]
    catalog = [("vdc", "AURORA_VDC_DIR", "data/vdc", False)]
    for mod in (jeval_api, teval_api):
        monkeypatch.setattr(mod, "list_tasks", lambda: names)
    for mod in (jtasks, ttasks):
        monkeypatch.setattr(mod, "catalog_status", lambda: catalog)
    for argv in ([], ["-p", "stage"], ["-p", "vdc"]):
        assert jcfg_tools.list_cfg(argv) == 0
        want = capsys.readouterr().out
        assert tcfg_tools.list_cfg(argv) == 0
        got = capsys.readouterr().out
        assert got == _port_text(want)


@pytest.mark.parametrize("stage", ["pretrain", "vision", "language"])
def test_copy_cfg_matches_reference_and_loads_back(tmp_path, capsys, stage):
    assert jcfg_tools.copy_cfg([stage, str(tmp_path / "j")]) == 0
    assert tcfg_tools.copy_cfg([stage, str(tmp_path / "t")]) == 0
    out = capsys.readouterr().out
    assert out.count(f"copied {stage} ->") == 2
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    with open(tmp_path / "t.json") as f:
        got = json.load(f)
    assert got == want
    got["train"]["grad_accum"] = 3
    got["batch_size"] = 5
    with open(tmp_path / "t.json", "w") as f:
        json.dump(got, f)
    from aurora_tpu_torch.train.configs import STAGES as TSTAGES
    cfg = tcfg_tools.load_cfg_overrides(str(tmp_path / "t.json"),
                                        TSTAGES[stage]())
    assert cfg.train.grad_accum == 3 and cfg.batch_size == 5
    assert tcfg_tools.copy_cfg(["nope", str(tmp_path / "x")]) == 1


def test_check_custom_dataset_matches_reference(tmp_path, capsys):
    recs = [
        {"image": "a.png", "conversations": [
            {"from": "human", "value": "<image> hi"},
            {"from": "gpt", "value": "ok"}]},
        {"image": "b.png", "conversations": [
            {"from": "human", "value": "no marker"},
            {"from": "gpt", "value": "x"}]},
        {"conversations": [{"from": "gpt", "value": "<video> wrong"}]},
        {"video": "v.mp4", "conversations": [
            {"from": "human", "value": "q"},
            {"from": "gpt", "value": 3}]},
        {"conversations": []},
    ]
    path = tmp_path / "d.jsonl"
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    for data in (str(path), str(tmp_path / "clean.json")):
        if data.endswith("clean.json"):
            with open(data, "w") as f:
                json.dump(recs[:1], f)
        rc_j = jcfg_tools.check_custom_dataset(["--data", data])
        want = capsys.readouterr().out
        rc_t = tcfg_tools.check_custom_dataset(["--data", data])
        assert (rc_t, capsys.readouterr().out) == (rc_j, want)
    assert tcfg_tools.check_records(recs) == jcfg_tools.check_records(recs)


def test_log_dataset_matches_reference(workdir, capsys):
    argv = ["--data", workdir["data"], "--model_path", workdir["root"],
            "--image_folder", workdir["imgs"], "-n", "3"]
    assert jcfg_tools.log_dataset(argv) == 0
    want = capsys.readouterr().out
    assert tcfg_tools.log_dataset(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want


def test_preprocess_matches_reference(workdir, tmp_path, monkeypatch,
                                      capsys):
    import datasets
    from aurora_tpu.cli import preprocess as jpre
    from aurora_tpu_torch.cli import preprocess as tpre
    common = ["--data", workdir["data"], "--tokenizer", workdir["root"],
              "--max_length", "128"]
    for extra in ([], ["--image_only", "--shard_size", "3"]):
        monkeypatch.setattr("sys.argv", ["preprocess", *common, "--out",
                                         str(tmp_path / "j"), *extra])
        jpre.main()
        assert tpre.main([*common, "--out", str(tmp_path / "t"),
                          *extra]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0].replace(str(tmp_path / "j"), "X") == \
            out[1].replace(str(tmp_path / "t"), "X")
        names = (["j", "t"] if not extra else
                 [f"{n}_shard{i}" for n in "jt" for i in range(3)])
        half = len(names) // 2
        for a, b in zip(names[:half], names[half:]):
            assert (list(datasets.load_from_disk(str(tmp_path / a)))
                    == list(datasets.load_from_disk(str(tmp_path / b))))
    # the dataset reads a pre-tokenized directory as the reference does
    ref = jdataset.AuroraDataset(str(tmp_path / "j"))
    got = tdataset.AuroraDataset(str(tmp_path / "t"), device="cpu")
    assert got.text_data == ref.text_data and len(got.text_data) == 8
    # without the datasets package: exit 1, naming it
    monkeypatch.setitem(__import__("sys").modules, "datasets", None)
    assert tpre.main([*common, "--out", str(tmp_path / "n")]) == 1
    assert "datasets" in capsys.readouterr().err


def test_hooks(workdir):
    from aurora_tpu.train import hooks as jhooks
    from aurora_tpu_torch.train import hooks as thooks
    _, _, tok = jinfer.load_model(workdir["root"], dtype=jnp.float32)
    jds = jdataset.AuroraDataset(workdir["data"], tok,
                                 image_folder=workdir["imgs"],
                                 template=PROMPT_TEMPLATE.vicuna,
                                 image_size=56)
    tds = apis.build_dataset(workdir["data"], tok,
                             image_folder=workdir["imgs"], image_size=56,
                             device="cpu")
    logged = []
    assert thooks.dataset_info(tds, tok, n=3, log=logged.append) == \
        jhooks.dataset_info(jds, tok, n=3, log=lambda m: None) == logged
    model, cfg, _ = tinfer.load_model(workdir["root"], torch.float32, "cpu")
    px = tds[0]["pixel_values"]
    for pixel_values in (None, px):
        hook = thooks.EvaluateChatHook(
            tok, cfg, prompts=["Describe."], pixel_values=pixel_values,
            max_new_tokens=4, every_n_steps=2, image_size=56,
            log=logged.append)
        assert hook.maybe_run(1, model) is None
        out = hook.maybe_run(2, model)
        assert len(out) == 1 and isinstance(out[0], str)
    assert logged[-1].startswith("[eval-chat step=2]")


def test_vision_stage_from_copied_config(workdir, tmp_path):
    cfg_path = tmp_path / "vision.json"
    assert tcfg_tools.copy_cfg(["vision", str(cfg_path)]) == 0
    with open(cfg_path) as f:
        raw = json.load(f)
    raw["train"]["grad_accum"] = 2
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    argv = _argv(workdir, "vision", "--config", str(cfg_path),
                 stage="vision", steps=4)
    argv[argv.index("--data") + 1] = workdir["video"]
    argv[argv.index("--batch_size") + 1] = "1"
    res = tcli.run(tcli.parse_args(argv))
    assert res.model.cfg.slowfast
    assert len(res.history) == 4
    # two updates: the schedule advances once per window of 2
    assert [h["lr"] for h in res.history][::2] == [h["lr"] for h in
                                                   res.history][1::2]
    assert res.state.opt_state["count"] == 2
    fresh, _, _ = tinfer.load_model(workdir["root"], torch.float32, "cpu")
    a, b = res.model.state_dict(), fresh.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a if k.startswith("llm."))
    assert not all(torch.equal(a[k], b[k]) for k in a
                   if k.startswith("visual_encoder."))


def test_apis_training_builders(workdir):
    model, cfg, tok = apis.build_model(workdir["root"], torch.float32,
                                       device="cpu")
    ds = apis.build_dataset(workdir["data"], tok,
                            image_folder=workdir["imgs"], image_size=56,
                            device="cpu")
    assert len(ds) == 8 and ds[0]["pixel_values"].shape == (1, 3, 56, 56)
    step, state, stage = apis.build_trainer(model, cfg, stage="pretrain",
                                            max_steps=5)
    assert stage.train.max_steps == 5 and state.step == 0
    from aurora_tpu_torch.data.collate import default_collate_fn
    batch = default_collate_fn([ds[0], ds[1]])
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    batch["input_ids"] = batch["input_ids"].long()
    batch["labels"] = batch["labels"].long()
    state, m = step(state, batch)
    assert state.step == 1 and torch.isfinite(m["loss"])
    base, adapters, cfg, lcfg, _ = apis.build_lora_model(
        workdir["root"], r=4, alpha=8, quant="int8", dtype=torch.float32,
        device="cpu")
    assert isinstance(base.llm.layers[0].q, tquant.QuantLinear)
    assert len(adapters) == 7 * cfg.llm.num_hidden_layers
    assert all(float(ab["b"].detach().abs().max()) == 0
               for ab in adapters.values())
    with pytest.raises(ValueError):
        apis.build_lora_model(workdir["root"], quant="int3", device="cpu")
