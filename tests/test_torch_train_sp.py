"""The port's train step on a mesh (parallel/mesh.py, train/trainer.py
`make_train_step(mesh=)`, train/lora.py `make_lora_train_step(mesh=)`)
against the JAX package's plain step and the port's one-process step,
on 4 gloo ranks on the CPU, at the tiny AuroraCap config in fp32.

One group of 4 ranks (tests/torch_mp_worker.py, suite "train") takes one
step in each case of `TRAIN_CASES` from the same weights (the JAX init,
perturbed, crossed through the bridge) and the same global batch: sp 4
in each mode (Ulysses, ring, hybrid u 2), sp 2 × tp 2, fsdp 2 × sp 2, dp
2 × tp 2, tp 4 (the attention whole: 4 does not divide the 2 KV heads),
packed batches on the llama3 ring (with heads_k_stride 1) and under
hybrid, a LoRA step on dp 2 × sp 2, a MoE LLM on tp 2 × sp 2 (its
experts cut over tp), Gemma-2's query_pre_attn_scalar through the ring,
and the step's refusals of zigzag and stripe and, under sp, of a
sliding window and an attention softcap. The multimodal batch fuses to 48 tokens (two image
markers of 16 visual tokens each), as the reference's
tests/test_trainer.py:107 has it.

Tolerances: the loss against the JAX plain step at rtol 1e-4 (the
reference's own test_sp_modes_match_baseline); loss and grad norm against
the port's one-process step at rtol 1e-5 (fp32 summation order over
ranks); each gradient (summed over the ranks) within 1e-5 of the
largest one-process gradient of any tensor (fp32 error scales with the
step's gradients, and some are 0 but for that error: a key bias's);
parameters after the AdamW step
within 0.02·lr of the one-process step's (tests/test_torch_train.py's
bound) wherever the one-process gradient exceeds 1e-6: the first AdamW
step moves a weight by lr·g/(|g| + 1e-8), about lr·sign(g), so where |g|
lies within the gradients' fp32 error of 0 the step may take either sign
(one weight in 4,096 of the packed ring case: 2.15e-5); every rank's loss
and grad norm equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mp_worker as W
from aurora_tpu.models import aurora as jaurora
from aurora_tpu.models import llama as jllama
from aurora_tpu.models.projector import init_projector_params
from aurora_tpu.models.vit import init_vit_params
from aurora_tpu.train import trainer as jtrainer
from aurora_tpu.utils.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from aurora_tpu_torch import bridge
from aurora_tpu_torch.models import aurora as taurora
from aurora_tpu_torch.models.aurora import AuroraConfig
from aurora_tpu_torch.train import trainer as ttrainer
from aurora_tpu_torch.train.lora import adapter_tensors, make_lora_train_step

WORLD = 4
STEP_ATOL = 0.02 * W.LR
RUN_CASES = [c for c, v in W.TRAIN_CASES.items() if v[3] != "refused"]


def _batches():
    """The multimodal batch (B 2, T 18, two image markers a row, two 56 px
    frames) and the packed text batch (B 2, T 40, two or three segments)."""
    rng = np.random.default_rng(0)
    B, T = 2, 18
    ids = rng.integers(3, 250, size=(B, T))
    ids[:, 1] = ids[:, 4] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    labels[:, :3] = labels[:, 4] = IGNORE_INDEX
    px = rng.standard_normal((B, 2, 3, 56, 56)).astype(np.float32)
    pk = rng.integers(3, 250, size=(B, 40))
    seg = np.zeros((B, 40), np.int64)
    seg[:, 17:] = 1
    seg[1, 33:] = 2
    pl = pk.copy()
    pl[:, 0] = pl[:, 17] = IGNORE_INDEX
    return {"mm": {"input_ids": ids, "labels": labels,
                   "attention_mask": np.ones((B, T), bool),
                   "pixel_values": px},
            "packed": {"input_ids": pk, "labels": pl,
                       "attention_mask": np.ones((B, 40), bool),
                       "segment_ids": seg}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = jaurora.AuroraConfig.tiny()
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    tree = {"visual_encoder": init_vit_params(keys[0], cfg.vit),
            "projector": init_projector_params(keys[1], cfg.projector),
            "llm": jllama.init_llama_params(keys[2], cfg.llm)}
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda x: (x + 0.02 * rng.standard_normal(x.shape)).astype(x.dtype),
        jax.device_get(tree))
    assert bridge.aurora_config_from(cfg) == AuroraConfig.tiny()
    model = bridge.aurora_from_params(tree, AuroraConfig.tiny(),
                                      dtype=torch.float32, device="cpu")
    outdir = tmp_path_factory.mktemp("train")
    torch.save(model.state_dict(), outdir / "model.pt")
    batches = _batches()
    np.savez(outdir / "batches.npz", **{f"{kind}/{k}": v for kind, b in
                                         batches.items()
                                         for k, v in b.items()})
    W.launch("train", WORLD, str(outdir), timeout=600)
    ranks = [np.load(outdir / f"train_rank{r}.npz") for r in range(WORLD)]
    return cfg, tree, str(outdir), batches, ranks


@pytest.fixture(scope="module")
def jax_loss(run):
    """The JAX plain step's loss on the multimodal batch (no mesh)."""
    cfg, tree, _, batches, _ = run
    tcfg = jtrainer.TrainConfig(lr=W.LR, max_steps=10, warmup_ratio=0.0,
                                remat=False)
    opt = jtrainer.make_optimizer(tree, tcfg)
    state = jtrainer.init_train_state(tree, tcfg)
    step = jax.jit(jtrainer.make_train_step(cfg, tcfg, opt))
    _, m = step(state, {k: jnp.asarray(v) for k, v in batches["mm"].items()})
    return float(m["loss"])


def _one_process(outdir, case):
    """The port's one-process step on the same model and global batch →
    (metrics, {name: tensor after the step}, {name: its gradient} (None
    for LoRA))."""
    _, batches = W.load_tiny(outdir)
    model = W.case_model(outdir, case)
    mesh_kw, _, kind, step_kind = W.TRAIN_CASES[case]
    tcfg = dataclasses.replace(W.train_config(case), sp_mode=None,
                               hybrid_ulysses=1, heads_k_stride=0)
    batch = batches[kind]
    if step_kind == "lora":
        lcfg, adapters = W.lora_setup(model)
        opt = ttrainer.lora_optimizer(tcfg)
        step = make_lora_train_step(model.cfg, tcfg, model, lcfg, opt)
        ad, _, m = step(adapters, opt.init(adapter_tensors(adapters)), batch)
        return m, {f"{p}/{k}": t for p, ab in ad.items()
                   for k, t in ab.items()}, None
    state = ttrainer.init_train_state(model, tcfg)
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    with ttrainer.repeatable_step():
        loss, _ = taurora.aurora_forward(
            model, batch["input_ids"], batch.get("pixel_values"),
            attention_mask=batch.get("attention_mask"),
            labels=batch["labels"], remat=True,
            segment_ids=batch.get("segment_ids"))
        got = torch.autograd.grad(loss, list(named.values()),
                                  allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), got)}
    state, m = ttrainer.make_train_step(model.cfg, tcfg)(state, batch)
    return m, named, grads


@pytest.mark.parametrize("case", [c for c in RUN_CASES
                                  if W.TRAIN_CASES[c][2] == "mm"
                                  and W.TRAIN_CASES[c][3] == "full"
                                  and c not in W.LLM_VARIANTS])
def test_mesh_step_loss_matches_the_jax_plain_step(run, jax_loss, case):
    ranks = run[-1]
    np.testing.assert_allclose(float(ranks[0][f"{case}/loss"]), jax_loss,
                               rtol=1e-4, err_msg=case)


@pytest.mark.parametrize("case", RUN_CASES)
def test_mesh_step_matches_the_one_process_step(run, case):
    _, _, outdir, _, ranks = run
    m, want, grads = _one_process(outdir, case)
    got = ranks[0]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[f"{case}/{key}"]),
                                   float(m[key]), rtol=1e-5,
                                   err_msg=f"{case} {key}")
    assert float(got[f"{case}/ntokens"]) == int(m["ntokens"])
    names = {k[len(f"{case}/param/"):] for k in got.files
             if k.startswith(f"{case}/param/")}
    assert names == set(want), case
    gmax = (max(float(g.abs().max()) for g in grads.values())
            if grads is not None else None)
    for name, t in want.items():
        sure = slice(None)
        if grads is not None:
            g = grads[name].numpy()
            np.testing.assert_allclose(got[f"{case}/grad/{name}"], g, rtol=0,
                                       atol=1e-5 * gmax,
                                       err_msg=f"{case} grad {name}")
            sure = np.abs(g) > 1e-6
        np.testing.assert_allclose(got[f"{case}/param/{name}"][sure],
                                   t.detach().numpy()[sure], rtol=0,
                                   atol=STEP_ATOL, err_msg=f"{case} {name}")
    for r in ranks[1:]:
        for key in ("loss", "grad_norm", "ntokens"):
            assert float(r[f"{case}/{key}"]) == float(got[f"{case}/{key}"])
    if f"{case}/roundtrip" in got.files:
        # the mesh state through the one-process checkpoint layout and back
        assert all(bool(r[f"{case}/roundtrip"]) for r in ranks), case


def test_fsdp_holds_half_the_trainable_bytes_a_rank(run):
    _, _, outdir, _, ranks = run
    model, _ = W.load_tiny(outdir)
    full = sum(p.numel() * p.element_size() for p in model.parameters())
    for r in ranks:
        got = int(r["fsdp2-sp2/param_bytes"])
        assert full / 2 <= got <= full / 2 + 64 * 4 * 8, (got, full)
        assert int(r["sp4-ring/param_bytes"]) == full


@pytest.mark.parametrize("case,kind", [
    ("sp4-ring-zigzag", "NotImplementedError"),
    ("sp4-hybrid-stripe", "NotImplementedError"),
    ("sp4-ring-zigzag-packed", "ValueError")])
def test_step_refuses_reordering_layouts(run, case, kind):
    """The reference's step runs zigzag and stripe on sequences it never
    reorders (ROADMAP queue 3); the port's step refuses them and names the
    fault; packed batches keep the reference's ValueError."""
    for r in run[-1]:
        msg = str(r[f"{case}/refused"])
        assert msg.startswith(kind), msg
        if kind == "NotImplementedError":
            assert "ROADMAP queue 3" in msg and "_split" in msg, msg
        else:
            assert "contiguous" in msg, msg


@pytest.mark.parametrize("case", ["sp2-dp2-window", "sp4-ulysses-softcap"])
def test_step_refuses_window_and_softcap_under_sp(run, case):
    """No sp attention applies a sliding window or an attention softcap;
    the reference's step drops them without a word (ROADMAP queue 3), the
    port's refuses the model under sp_mode."""
    for r in run[-1]:
        msg = str(r[f"{case}/refused"])
        assert msg.startswith("NotImplementedError"), msg
        assert "sliding window" in msg and "ROADMAP queue 3" in msg, msg


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "moe"])
def spec_tree(request):
    cfg = jaurora.AuroraConfig.tiny()
    if request.param:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
            cfg.llm, num_experts=4))
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    tree = {"visual_encoder": init_vit_params(keys[0], cfg.vit),
            "projector": init_projector_params(keys[1], cfg.projector),
            "llm": jllama.init_llama_params(keys[2], cfg.llm)}
    model = bridge.aurora_from_params(tree, bridge.aurora_config_from(cfg),
                                      dtype=torch.float32, device="cpu")
    return request.param, tree, model


class _OneRankOf:
    """Rank `tp_index` of a mesh as shard_model reads it, without a
    process group: each axis' size and this rank's index (laying a model
    out runs no collective)."""

    def __init__(self, cfg, tp_index):
        self.cfg, self.tp_index = cfg, tp_index

    def axis(self, names):
        from aurora_tpu_torch.parallel.collectives import Axis
        names = (names,) if isinstance(names, str) else tuple(names)
        ranks = list(range(int(np.prod([self.cfg.size(n) for n in names]))))
        return Axis(None, ranks, self.tp_index if names == ("tp",) else 0,
                    [ranks])


@pytest.mark.parametrize("axes", [dict(fsdp=2, tp=2), dict(dp=1, fsdp=3,
                                                            tp=3),
                                  dict(tp=4)])
def test_param_specs_match_the_reference_by_path(devices, spec_tree, axes):
    """shard_model's tp cut of each decoder tensor against the tp axis of
    the reference's `aurora_param_specs` at the same path, after its
    fall-back to replication where tp does not divide a dimension
    (`shard_pytree`): tp 2 cuts every branch, tp 3 none (the tiny widths
    are not multiples of 3). At tp 4 the MLP and the experts are cut and
    the attention is whole, as 4 does not divide the 2 KV heads; the
    reference still cuts the q/k/v/o kernels there, k/v inside a head
    (the port's fall-back is at head granularity, `mesh.tp_cut`). fsdp pads
    each flat unit and needs no fall-back: every shard holds
    ceil(numel / fsdp). The embeddings, the LM head, the ViT and the
    projector stay whole over tp (the module's stated deviation)."""
    from aurora_tpu.parallel import mesh as jmesh
    from aurora_tpu_torch.parallel.mesh import MeshConfig, shard_model
    moe, tree, model = spec_tree
    tp = axes["tp"]
    ref = jmesh.create_mesh(jmesh.MeshConfig(tp=tp), devices=devices)
    specs = jmesh.aurora_param_specs(tree)["llm"]["layers"]
    want = {}
    for key, s in specs.items():
        s = tuple(s)
        arr = tree["llm"]["layers"][key]
        if "tp" in s and jmesh._divisible(arr.shape, s, ref):
            want[key] = s.index("tp") - 1      # past the stacked L axis
        else:
            want[key] = None
    whole = {n: p.shape for n, p in model.named_parameters()}
    saw = set()
    for index in range(tp):
        m = bridge.aurora_from_params(tree, model.cfg, dtype=torch.float32,
                                      device="cpu")
        plan = shard_model(m, _OneRankOf(MeshConfig(**axes), index))
        for unit in plan.units:
            assert unit.n == -(-unit.numel // axes.get("fsdp", 1))
            for _, _, name, shape, _, _, dim in unit.entries:
                cut = [d for d, (a, b) in enumerate(zip(shape, whole[name]))
                       if a != b]
                assert cut == ([] if dim is None else [dim]), name
                if dim is not None:
                    assert shape[dim] * tp == whole[name][dim], name
                parts = name.split(".")
                if parts[:2] != ["llm", "layers"]:
                    assert dim is None, name
                    continue
                key = parts[3]
                if parts[2] != "0" or key not in want:
                    continue
                saw.add(key)
                if dim is not None and len(shape) == 2:
                    dim = 1 - dim      # [out, in] against the [in, out] kernel
                expect = want[key]
                if tp == 4 and key in ("q", "k", "v", "o"):
                    expect = None      # whole attention (see above)
                assert dim == expect, (name, dim, expect)
    assert saw == set(want), saw
    if moe:
        assert want["moe_gate"] == (0 if tp in (2, 4) else None)
