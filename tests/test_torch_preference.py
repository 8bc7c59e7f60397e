"""The preference objectives of the port (train/preference.py) against
the JAX package's (aurora_tpu/train/preference.py), on the CPU.

A tiny llama in float32 (the JAX init, bridged), pairs of 12-token
sequences from a seeded numpy generator (prompt labels IGNORE_INDEX):
sequence log-probs, the DPO, ORPO and Bradley-Terry losses and their
metrics within 1e-4 (tests/test_torch_train.py's bound); one DPO step
(policy and a separate reference model) and one ORPO step, with the
port's Optimizer on both sides' TrainConfig (clip by global norm →
AdamW, the JAX optimizer `make_optimizer` builds), give the JAX step's
loss and metrics within 1e-4 and its updated parameters within
0.02 x lr (tests/test_torch_train.py's STEP_ATOL); the reference model
stays unchanged, and without grads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aurora_tpu.models import llama as jllama
from aurora_tpu.train import preference as jpref
from aurora_tpu.train import trainer as jtrainer
from aurora_tpu.utils.constants import IGNORE_INDEX
from aurora_tpu_torch import bridge
from aurora_tpu_torch.train import preference as tpref
from aurora_tpu_torch.train import trainer as ttrainer

TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-3
STEP_ATOL = 0.02 * LR


@pytest.fixture(scope="module")
def tiny():
    cfg = jllama.LlamaConfig.tiny(vocab_size=128)
    trees = [jax.device_get(jllama.init_llama_params(
        jax.random.PRNGKey(s), cfg, dtype=jnp.float32)) for s in (1, 2)]
    return cfg, trees


def _model(cfg, tree):
    return bridge.llama_from_params(tree, bridge.llama_config_from(cfg),
                                    dtype=torch.float32, device="cpu")


def _batch(seed, B=2, T=12):
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("chosen", "rejected"):
        ids = rng.integers(3, 128, size=(B, T))
        labels = ids.copy()
        labels[:, :4] = IGNORE_INDEX
        out[side + "_ids"], out[side + "_labels"] = ids, labels
    return out


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_losses_and_logprobs_match_jax(tiny):
    cfg, (tree, ref_tree) = tiny
    model, ref = _model(cfg, tree), _model(cfg, ref_tree)
    b = _batch(3)
    want = jpref.sequence_logprob(tree, cfg, jnp.asarray(b["chosen_ids"]),
                                  jnp.asarray(b["chosen_labels"]))
    got = tpref.sequence_logprob(model, model.cfg,
                                 torch.from_numpy(b["chosen_ids"]),
                                 torch.from_numpy(b["chosen_labels"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    lps = np.random.default_rng(4).normal(-20, 3, size=(4, 3)).astype(
        np.float32)
    for smooth in (0.0, 0.1):
        wl = jpref.dpo_loss(*map(jnp.asarray, lps), beta=0.2,
                            label_smoothing=smooth)
        gl = tpref.dpo_loss(*map(torch.from_numpy, lps), beta=0.2,
                            label_smoothing=smooth)
        for w, g in zip(wl, gl):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    wo, wa = jpref.orpo_loss(tree, cfg, _j(b), beta=0.5)
    go, ga = tpref.orpo_loss(model, model.cfg, _t(b), beta=0.5)
    np.testing.assert_allclose(float(go.detach()), float(wo), **TOL)
    for k in wa:
        np.testing.assert_allclose(float(ga[k].detach()), float(wa[k]),
                                   **TOL)


def test_reward_model_matches_jax(tiny):
    """Scores at the last valid token (a right-padded mask) and the
    Bradley-Terry loss, with one value head drawn by numpy for both."""
    cfg, (tree, _) = tiny
    model = _model(cfg, tree)
    head = 0.02 * np.random.default_rng(5).standard_normal(
        (cfg.hidden_size, 1)).astype(np.float32)
    b = _batch(6)
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    b["chosen_mask"] = mask
    wl, wa = jpref.reward_bt_loss(tree, jnp.asarray(head), cfg, _j(b))
    gl, ga = tpref.reward_bt_loss(model, torch.from_numpy(head), model.cfg,
                                  _t(b))
    np.testing.assert_allclose(float(gl.detach()), float(wl), **TOL)
    for k in wa:
        np.testing.assert_allclose(float(ga[k].detach()), float(wa[k]),
                                   **TOL)
    gen = torch.Generator().manual_seed(0)
    vh = tpref.init_value_head(gen, model.cfg)
    assert vh.shape == (cfg.hidden_size, 1) and 0.01 < vh.std() < 0.03


@pytest.mark.parametrize("kind", ["dpo", "orpo"])
def test_one_step_matches_jax(tiny, kind):
    cfg, (tree, ref_tree) = tiny
    jtcfg = jtrainer.TrainConfig(lr=LR, max_steps=20, warmup_ratio=0.0,
                                 weight_decay=0.01, freeze_llm=False,
                                 freeze_visual_encoder=False,
                                 freeze_projector=False)
    opt = jtrainer.make_optimizer(tree, jtcfg)
    b = _batch(7)
    if kind == "dpo":
        jstep = jax.jit(jpref.make_dpo_step(cfg, ref_tree, opt,
                                            beta=0.5).with_ref)
        jparams, _, jm = jstep(tree, opt.init(tree), _j(b), ref_tree)
    else:
        jstep = jax.jit(jpref.make_orpo_step(cfg, opt, beta=0.5))
        jparams, _, jm = jstep(tree, opt.init(tree), _j(b))
    model, ref = _model(cfg, tree), _model(cfg, ref_tree)
    ref.requires_grad_(False)
    ref_before = {k: v.clone() for k, v in ref.state_dict().items()}
    o = ttrainer.Optimizer(model, ttrainer.TrainConfig(
        **dataclasses.asdict(jtcfg)))
    if kind == "dpo":
        step = tpref.make_dpo_step(model.cfg, ref, o, beta=0.5)
    else:
        step = tpref.make_orpo_step(model.cfg, o, beta=0.5)
    model, _, tm = step(model, o.init(model), _t(b))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    want = bridge.llama_state_dict(jax.device_get(jparams), model.cfg)
    for name, w in want.items():
        np.testing.assert_allclose(model.state_dict()[name].detach().numpy(),
                                   w.numpy(), rtol=0, atol=STEP_ATOL,
                                   err_msg=name)
    moved = max((model.state_dict()[k] - bridge.llama_state_dict(
        tree, model.cfg)[k]).abs().max().item() for k in want)
    assert moved > 0.5 * LR
    for k, v in ref.state_dict().items():
        assert torch.equal(v, ref_before[k]) and v.grad is None
