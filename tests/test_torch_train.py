"""The port's training slice against the JAX package, float32 on the CPU
at the tiny AuroraCap config: `llama_apply`, `llama_lm_loss`,
`aurora_forward`, one `make_train_step` step, gradient accumulation, the
learning-rate schedule, frozen stages and remat. The same numpy weights
(the JAX init, perturbed) cross through `aurora_tpu_torch.bridge`.

Tolerances: 1e-4 for logits and losses (fp32 summation order over a few
layers, as tests/test_torch_visual.py); 1e-4 relative for the grad norm;
1e-6 relative for the learning rate (fp32 arithmetic on both sides).
Updated parameters after one AdamW step: the first step moves each
weight by about lr·sign(g), so a gradient within its fp32 error of 0 can
move its weight anywhere in ±lr on either side; the bound is therefore
set on the step, |Δ| <= 0.02·lr, and must hold for every element.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aurora_tpu.models import aurora as jaurora
from aurora_tpu.models import llama as jllama
from aurora_tpu.models.projector import init_projector_params
from aurora_tpu.models.vit import init_vit_params
from aurora_tpu.train import trainer as jtrainer
from aurora_tpu.utils.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models import aurora as taurora
from aurora_tpu_torch.models import llama as tllama
from aurora_tpu_torch.train import trainer as ttrainer

TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-3
STEP_ATOL = 0.02 * LR


@pytest.fixture(scope="module")
def tiny():
    cfg = jaurora.AuroraConfig.tiny()
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    tree = {"visual_encoder": init_vit_params(keys[0], cfg.vit),
            "projector": init_projector_params(keys[1], cfg.projector),
            "llm": jllama.init_llama_params(keys[2], cfg.llm)}
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(x.dtype),
        jax.device_get(tree))
    return cfg, tree


def _model(cfg, tree):
    return bridge.aurora_from_params(tree, bridge.aurora_config_from(cfg),
                                     dtype=torch.float32, device="cpu")


def _batch(kind, seed=0, B=2, T=16):
    """numpy batch: text (padded row 1, some ignored labels) or
    multimodal (two image markers, two 56 px frames)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 250, size=(B, T))
    labels = ids.copy()
    labels[:, :3] = IGNORE_INDEX
    batch = {"input_ids": ids, "labels": labels}
    if kind == "text":
        mask = np.ones((B, T), bool)
        mask[1, -4:] = False
        labels[1, -4:] = IGNORE_INDEX
        batch["attention_mask"] = mask
    else:
        ids[:, 1] = IMAGE_TOKEN_INDEX
        ids[:, 4] = IMAGE_TOKEN_INDEX
        labels[:, 1] = labels[:, 4] = IGNORE_INDEX
        batch["attention_mask"] = np.ones((B, T), bool)
        frames = 3 if kind == "slowfast" else 2
        batch["pixel_values"] = rng.standard_normal(
            (B, frames, 3, 56, 56)).astype(np.float32)
        if kind == "slowfast":
            ids[:, 7] = IMAGE_TOKEN_INDEX
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@pytest.mark.parametrize("use_flash,masked", [(False, False), (False, True),
                                              (True, False)])
def test_llama_apply_logits_match_jax(tiny, use_flash, masked):
    cfg, tree = tiny
    b = _batch("text", seed=1)
    mask = b["attention_mask"] if masked else None
    want, _ = jllama.llama_apply(
        tree["llm"], cfg.llm, input_ids=jnp.asarray(b["input_ids"]),
        attention_mask=None if mask is None else jnp.asarray(mask),
        use_flash=use_flash)
    model = _model(cfg, tree)
    got = tllama.llama_apply(
        model.llm, model.cfg.llm,
        input_ids=torch.from_numpy(b["input_ids"]),
        attention_mask=None if mask is None else torch.from_numpy(mask),
        use_flash=use_flash)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_llama_lm_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(2, 9))
    labels[0, 2:5] = IGNORE_INDEX
    want, n_want = jllama.llama_lm_loss(jnp.asarray(logits),
                                        jnp.asarray(labels))
    got, n_got = tllama.llama_lm_loss(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    assert int(n_got) == int(n_want) == 13
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    per_tok, _ = tllama.llama_lm_loss(torch.from_numpy(logits),
                                      torch.from_numpy(labels), reduce=False)
    want_tok, _ = jllama.llama_lm_loss(jnp.asarray(logits),
                                       jnp.asarray(labels), reduce=False)
    np.testing.assert_allclose(_np(per_tok), np.asarray(want_tok),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["text", "multimodal", "slowfast"])
def test_aurora_forward_loss_matches_jax(tiny, kind):
    cfg, tree = tiny
    if kind == "slowfast":
        cfg = dataclasses.replace(cfg, slowfast=True)
    b = _batch(kind, seed=3)
    jb, tb = _jax(b), _torch(b)
    want = jaurora.aurora_forward(
        tree, cfg, jb["input_ids"], jb.get("pixel_values"),
        attention_mask=jb["attention_mask"], labels=jb["labels"],
        kept_ratio=0.5, mode="loss")
    got = taurora.aurora_forward(
        _model(cfg, tree), tb["input_ids"], tb.get("pixel_values"),
        attention_mask=tb["attention_mask"], labels=tb["labels"],
        kept_ratio=0.5, mode="loss")
    assert int(got[1]) == int(want[1])
    np.testing.assert_allclose(float(got[0].detach()), float(want[0]),
                               **TOL)


def _jax_steps(cfg, tree, tcfg, batches):
    state = jtrainer.init_train_state(tree, tcfg)
    step = jax.jit(jtrainer.make_train_step(
        cfg, tcfg, jtrainer.make_optimizer(tree, tcfg)))
    out = []
    for b in batches:
        state, m = step(state, _jax(b))
        out.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state.params), out


def _port_steps(cfg, tree, tcfg, batches):
    model = _model(cfg, tree)
    state = ttrainer.init_train_state(model, tcfg)
    step = ttrainer.make_train_step(model.cfg, tcfg)
    out = []
    for b in batches:
        state, m = step(state, _torch(b))
        out.append({k: float(v) for k, v in m.items()})
    return model, out


def _assert_params_match(model, jparams, cfg):
    want = bridge.aurora_state_dict(jparams, bridge.aurora_config_from(cfg))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(_np(got[name]), _np(w), rtol=0,
                                   atol=STEP_ATOL, err_msg=name)


def _assert_metrics_match(got, want):
    assert got["ntokens"] == want["ntokens"]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)


@pytest.mark.parametrize("kind", ["text", "multimodal"])
def test_train_step_matches_jax(tiny, kind):
    cfg, tree = tiny
    tcfg = jtrainer.TrainConfig(lr=LR, max_steps=20, warmup_ratio=0.1,
                                kept_ratio=0.5, remat=False,
                                weight_decay=0.01)
    b = _batch(kind, seed=4)
    jparams, (jm,) = _jax_steps(cfg, tree, tcfg, [b])
    model, (tm,) = _port_steps(
        cfg, tree, ttrainer.TrainConfig(**dataclasses.asdict(tcfg)), [b])
    _assert_metrics_match(tm, jm)
    _assert_params_match(model, jparams, cfg)


def test_grad_accum_matches_multisteps(tiny):
    """grad_accum=2: no update after the first step, the mean of both
    gradients applied after the second, lr at step // 2."""
    cfg, tree = tiny
    tcfg = jtrainer.TrainConfig(lr=LR, max_steps=20, warmup_ratio=0.2,
                                kept_ratio=0.5, remat=False, grad_accum=2,
                                grad_clip=0.5)
    batches = [_batch("multimodal", seed=5), _batch("multimodal", seed=6)]
    jparams, jms = _jax_steps(cfg, tree, tcfg, batches)
    model, tms = _port_steps(
        cfg, tree, ttrainer.TrainConfig(**dataclasses.asdict(tcfg)), batches)
    for got, want in zip(tms, jms):
        _assert_metrics_match(got, want)
    _assert_params_match(model, jparams, cfg)
    moved = _np(model.llm.lm_head.weight) - tree["llm"]["lm_head"].T
    assert np.abs(moved).max() > 0.9 * LR / 4     # lr at step 0: lr/warmup


def test_frozen_pretrain_stage(tiny):
    """freeze_llm + freeze_visual_encoder: the LLM and the ViT stay
    bitwise unchanged, the projector moves."""
    cfg, tree = tiny
    tcfg = ttrainer.TrainConfig(lr=1e-2, max_steps=10, warmup_ratio=0.0,
                                kept_ratio=1.0, remat=False,
                                freeze_llm=True, freeze_visual_encoder=True)
    model = _model(cfg, tree)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = ttrainer.init_train_state(model, tcfg)
    assert not any(p.requires_grad for p in model.llm.parameters())
    assert all(p.requires_grad for p in model.projector.parameters())
    state, m = ttrainer.make_train_step(model.cfg, tcfg)(
        state, _torch(_batch("multimodal", seed=7)))
    assert float(m["grad_norm"]) > 0
    for name, after in model.state_dict().items():
        if name.startswith("projector."):
            continue
        assert torch.equal(after, before[name]), name
    assert max((model.state_dict()[k] - before[k]).abs().max().item()
               for k in before if k.startswith("projector.")) > 0


@pytest.mark.parametrize("policy", [None, "dots_with_no_batch_dims_saveable",
                                    "dots_saveable"])
def test_remat_matches_no_remat(tiny, policy):
    """Remat, full or selective, changes what is recomputed, not the math
    (tests/test_trainer.py's check for the JAX trainer)."""
    cfg, tree = tiny
    tcfg = ttrainer.TrainConfig(lr=LR, max_steps=10, warmup_ratio=0.0,
                                kept_ratio=0.5, remat=False)
    b = [_batch("multimodal", seed=8)]
    base_model, (m0,) = _port_steps(cfg, tree, tcfg, b)
    model, (m1,) = _port_steps(
        cfg, tree, dataclasses.replace(tcfg, remat=True,
                                       remat_policy=policy), b)
    np.testing.assert_allclose(m1["loss"], m0["loss"], rtol=1e-5)
    np.testing.assert_allclose(m1["grad_norm"], m0["grad_norm"], rtol=1e-4)
    for name, p in base_model.state_dict().items():
        np.testing.assert_allclose(_np(model.state_dict()[name]), _np(p),
                                   rtol=0, atol=STEP_ATOL, err_msg=name)


@pytest.mark.parametrize("max_steps,warmup_ratio", [(1000, 0.03), (50, 0.1)])
def test_lr_schedule_matches_optax(max_steps, warmup_ratio):
    tcfg = jtrainer.TrainConfig(lr=2e-4, max_steps=max_steps,
                                warmup_ratio=warmup_ratio)
    warmup = max(1, int(max_steps * warmup_ratio))
    want = jtrainer.lr_schedule(tcfg)
    got = ttrainer.lr_schedule(
        ttrainer.TrainConfig(lr=2e-4, max_steps=max_steps,
                             warmup_ratio=warmup_ratio))
    for step in (0, warmup - 1, warmup, warmup + 7, max_steps - 1):
        np.testing.assert_allclose(
            got(step), float(want(jnp.asarray(step, jnp.int32))), rtol=1e-6,
            err_msg=str(step))


def test_adamw_step_matches_optax():
    """One clipped AdamW step with weight decay on a bare tensor, against
    optax's chain (clip → adamw)."""
    rng = np.random.default_rng(9)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    g = rng.standard_normal((6, 5)).astype(np.float32) * 2
    tcfg = ttrainer.TrainConfig(lr=3e-3, max_steps=10, warmup_ratio=0.0,
                                weight_decay=0.1, grad_clip=1.0)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(jtrainer.lr_schedule(
                          jtrainer.TrainConfig(lr=3e-3, max_steps=10,
                                               warmup_ratio=0.0)),
                                  b1=0.9, b2=0.999, weight_decay=0.1))
    state = opt.init(jnp.asarray(p0))
    upd, _ = opt.update(jnp.asarray(g), state, jnp.asarray(p0))
    want = np.asarray(optax.apply_updates(jnp.asarray(p0), upd))

    class One(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(p0.copy()))

    m = One()
    o = ttrainer.Optimizer(m, tcfg)
    st = o.init(m)
    o.update([torch.from_numpy(g)], st, m)
    np.testing.assert_allclose(_np(m.w), want, rtol=1e-6, atol=1e-7)


def test_unported_options_raise(tiny):
    cfg, tree = tiny
    with pytest.raises(NotImplementedError):
        ttrainer.TrainConfig(sp_mode="ring")
    with pytest.raises(NotImplementedError):
        ttrainer.TrainConfig(ring_layout="zigzag")
    model = _model(cfg, tree)
    b = _torch(_batch("text"))
    with pytest.raises(NotImplementedError):
        taurora.aurora_forward(model, b["input_ids"], labels=b["labels"],
                               segment_ids=torch.zeros_like(b["input_ids"]))
    with pytest.raises(NotImplementedError):
        ttrainer.make_train_step(model.cfg, ttrainer.TrainConfig(),
                                 mesh=object())
    with pytest.raises(ValueError):
        tllama.llama_apply(model.llm, model.cfg.llm,
                           input_ids=b["input_ids"], remat="nothing_saveable")


def test_profile_train_runs_on_cpu(tmp_path):
    """tools/profile_train.py's logic on the bench stage's model cut to
    tiny widths, on the CPU: both remat settings step and time, the first
    one is profiled, the summary is written (no device events on the
    CPU)."""
    import json

    from aurora_tpu_torch.tools import profile_train
    from aurora_tpu_torch.train import bench_stage
    cfg = bench_stage.aurora_config(layers=2, llm=tllama.LlamaConfig.tiny())
    batch = bench_stage.text_batch(cfg, "cpu", seq=32)
    assert int(batch["input_ids"].min()) >= 10
    profile_train.profile(cfg, batch, ["full", "none"], str(tmp_path),
                          "cpu")
    res = json.loads((tmp_path / "summary.json").read_text())
    assert (res["layers"], res["batch"], res["seq"]) == (2, 4, 32)
    assert set(res["settings"]) == {"full", "none"}
    assert all(r["step_ms"] > 0 and r["tflops"] > 0
               for r in res["settings"].values())
    assert res["profiled"] == "full" and res["device_ms"] == 0.0
    assert set(res["group_ms"]) == {"flash", "matmul", "other"}
    assert (tmp_path / "train_step_trace.json").exists()
    for name in ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                 "flash_bwd_dq_kernel"):
        assert profile_train.group_of(
            f"(anonymous namespace)::{name}(CUtensorMap, CUtensorMap, "
            "CUtensorMap, int const*, int const*, __nv_bfloat16*, "
            "float*, (anonymous namespace)::Shape)") == "flash"
    assert profile_train.group_of("nvjet_hsh_128x256") == "matmul"
