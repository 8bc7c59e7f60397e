"""One rank of the port's multi-process CPU tests, started as torchrun
starts it (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK):

    python tests/torch_mp_worker.py SUITE OUTDIR

The rank joins the gloo group through `parallel.distributed.
init_distributed`, runs every case of SUITE (a function of this module)
on inputs made from seeds with numpy, and writes what the tests compare
to OUTDIR/SUITE_rank<r>.npz. Imports torch and the port only (no JAX):
the tests compute the JAX side in their own process. `launch` starts the
ranks and waits for them.
"""

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# attention cases: B, T, H, Hkv, D, and how each runs
B, T, D = 2, 32, 16
SEG_BOUNDS = (0, 5, 17, 26, 32)      # four packed segments of a row
ATTN_CASES = {
    "ulysses-causal": dict(mode="ulysses", H=4, Hkv=4, causal=True),
    "ulysses-full": dict(mode="ulysses", H=4, Hkv=4, causal=False),
    "ulysses-inner-sp": dict(mode="ulysses", H=2, Hkv=2, causal=True),
    "ulysses-segments": dict(mode="ulysses", H=4, Hkv=4, causal=True,
                             segments=True),
    "ulysses-gqa": dict(mode="ulysses", H=4, Hkv=2, causal=True),
    "ring-contiguous": dict(mode="ring", H=4, Hkv=4, causal=True),
    "ring-full": dict(mode="ring", H=4, Hkv=4, causal=False),
    "ring-zigzag": dict(mode="ring", H=4, Hkv=4, causal=True,
                        layout="zigzag"),
    "ring-stripe": dict(mode="ring", H=4, Hkv=4, causal=True,
                        layout="stripe"),
    "ring-gqa": dict(mode="ring", H=4, Hkv=2, causal=True),
    "ring-varlen": dict(mode="ring", H=4, Hkv=2, causal=True, segments=True),
    "ring-varlen-stride": dict(mode="ring", H=4, Hkv=2, causal=True,
                               segments=True, heads_k_stride=1),
    "hybrid": dict(mode="hybrid", H=4, Hkv=4, causal=True),
    "hybrid-zigzag": dict(mode="hybrid", H=4, Hkv=2, causal=True,
                          layout="zigzag"),
    "hybrid-varlen": dict(mode="hybrid", H=4, Hkv=2, causal=True,
                          segments=True),
}
ULYSSES = 2           # the hybrid cases' Ulysses degree (ring degree 2)


def attn_inputs(case):
    """Global q, k, v, dout [B, T, H|Hkv, D] and segment ids [B, T]."""
    import numpy as np
    c = ATTN_CASES[case]
    rng = np.random.default_rng(list(ATTN_CASES).index(case))
    q = rng.standard_normal((B, T, c["H"], D)).astype(np.float32)
    k = rng.standard_normal((B, T, c["Hkv"], D)).astype(np.float32)
    v = rng.standard_normal((B, T, c["Hkv"], D)).astype(np.float32)
    dout = rng.standard_normal((B, T, c["H"], D)).astype(np.float32)
    seg = np.zeros((B, T), np.int32)
    for i, (a, b) in enumerate(zip(SEG_BOUNDS, SEG_BOUNDS[1:])):
        seg[:, a:b] = i
    return q, k, v, dout, seg


def layout_order(case, sp):
    """The permutation of global positions the case's layout lays out
    (position i of the reordered sequence holds token order[i])."""
    import numpy as np
    c = ATTN_CASES[case]
    layout = c.get("layout", "contiguous")
    idx = np.arange(T)
    if layout == "stripe":
        return idx.reshape(T // sp, sp).T.reshape(-1)
    if layout == "zigzag":
        n = sp if c["mode"] == "ring" else sp // ULYSSES
        chunks = np.split(idx, 2 * n)
        order = []
        for r in range(n):
            order += [r, 2 * n - 1 - r]
        return np.concatenate([chunks[i] for i in order])
    return idx


def suite_attn(mesh, rank):
    """Every attention case on sp = world: this rank's block of out and of
    dq / dk / dv (dout seeded), plus the collectives against their
    transposes and the flash launch counts (CPU: twin calls)."""
    import numpy as np
    import torch
    from aurora_tpu_torch.ops.pallas.flash_attention import (
        flash_attention_plain)
    from aurora_tpu_torch.parallel import hybrid, ring, ulysses
    from aurora_tpu_torch.parallel.ring import stripe_split, zigzag_split
    out = {}
    sp = mesh.cfg.sp
    for case, c in ATTN_CASES.items():
        q, k, v, dout, seg = attn_inputs(case)
        layout = c.get("layout", "contiguous")
        ts = [torch.from_numpy(x) for x in (q, k, v, dout)]
        if layout == "stripe":
            ts = [stripe_split(t, sp) for t in ts]
        elif layout == "zigzag":
            n = sp if c["mode"] == "ring" else sp // ULYSSES
            ts = [zigzag_split(t, n) for t in ts]
        n = T // sp
        blk = slice(rank * n, (rank + 1) * n)
        ql, kl, vl = (t[:, blk].clone().requires_grad_(True)
                      for t in ts[:3])
        segl = torch.from_numpy(seg[:, blk]) if c.get("segments") else None
        kw = dict(causal=c["causal"])
        calls = flash_attention_plain.calls
        if c["mode"] == "ulysses":
            o = ulysses.ulysses_mha(ql, kl, vl, mesh, q_segment_ids=segl,
                                    kv_segment_ids=segl, **kw)
        elif c["mode"] == "ring":
            if segl is not None:
                o = ring.ring_varlen_mha(
                    ql, kl, vl, segl, mesh,
                    heads_k_stride=c.get("heads_k_stride", 0), **kw)
            else:
                o = ring.ring_mha(ql, kl, vl, mesh, layout=layout, **kw)
        elif segl is not None:
            o = hybrid.hybrid_varlen_mha(ql, kl, vl, segl, mesh,
                                         ulysses=ULYSSES, **kw)
        else:
            o = hybrid.hybrid_mha(ql, kl, vl, mesh, ulysses=ULYSSES,
                                  layout=layout, **kw)
        out[f"{case}/flash_calls"] = flash_attention_plain.calls - calls
        dq, dk, dv = torch.autograd.grad(o, (ql, kl, vl), ts[3][:, blk])
        for name, t in (("out", o), ("dq", dq), ("dk", dk), ("dv", dv)):
            out[f"{case}/{name}"] = t.detach().numpy()
    out.update(_transposes(mesh, rank))
    return out


# collective → (input replicated over the ranks, output replicated)
TRANSPOSES = {"all_to_all": (False, False), "all_gather": (False, False),
              "all_gather_inner": (False, False), "ring_pass": (False, False), "reduce_sum": (False, True),
              "enter_parallel": (True, False)}


def _transposes(mesh, rank):
    """For each collective f, <f(x), w> and <x, f^T(w)> with f^T the
    autograd backward: a sum over the ranks for a tensor each rank holds
    its own of, one rank's value for a replicated one (Megatron's
    reduce_sum takes partial sums to a replicated tensor; enter_parallel
    the other way)."""
    import torch
    from aurora_tpu_torch.parallel import collectives as col
    sp = mesh.axis("sp")
    inner = sp.split(2)[0]
    fns = {"all_to_all": lambda x: col.all_to_all(x, sp, 2, 1),
           "all_gather": lambda x: col.all_gather(x, sp, 1),
           "all_gather_inner": lambda x: col.all_gather(x, inner, 3),
           "ring_pass": lambda x: torch.stack(col.ring_pass(x, sp)),
           "reduce_sum": lambda x: col.reduce_sum(x, sp),
           "enter_parallel": lambda x: col.enter_parallel(x, sp)}
    out = {}
    for i, (name, f) in enumerate(fns.items()):
        rep_in, rep_out = TRANSPOSES[name]
        gx_ = torch.Generator().manual_seed(100 * i + (0 if rep_in else rank))
        gw = torch.Generator().manual_seed(100 * i + 50
                                           + (0 if rep_out else rank))
        x = torch.randn((2, 3, 4, 6), generator=gx_, dtype=torch.float64,
                        requires_grad=True)
        y = f(x)
        w = torch.randn(y.shape, generator=gw, dtype=torch.float64)
        (gx,) = torch.autograd.grad(y, x, w)
        lhs, rhs = (y.detach() * w).sum(), (x.detach() * gx).sum()
        lhs = lhs if rep_out else col.all_reduce_(lhs, sp)
        rhs = rhs if rep_in else col.all_reduce_(rhs, sp)
        out[f"transpose/{name}"] = torch.stack([lhs, rhs]).numpy()
    return out


# train cases: mesh, TrainConfig fields, batch ("mm": multimodal, fused
# length 48; "packed": text rows of two segments), kind of step
LR = 1e-3
TRAIN_CASES = {
    "sp4-ulysses": (dict(sp=4), dict(sp_mode="ulysses"), "mm", "full"),
    "sp4-ring": (dict(sp=4), dict(sp_mode="ring"), "mm", "full"),
    "sp4-hybrid": (dict(sp=4), dict(sp_mode="hybrid", hybrid_ulysses=2),
                   "mm", "full"),
    "sp2-tp2": (dict(sp=2, tp=2), dict(sp_mode="ulysses"), "mm", "full"),
    "fsdp2-sp2": (dict(fsdp=2, sp=2), dict(sp_mode="ring"), "mm", "full"),
    "dp2-tp2": (dict(dp=2, tp=2), {}, "mm", "full"),
    "sp4-ring-packed": (dict(sp=4), dict(sp_mode="ring", heads_k_stride=1),
                        "packed", "full"),
    "sp4-hybrid-packed": (dict(sp=4), dict(sp_mode="hybrid",
                                           hybrid_ulysses=2),
                          "packed", "full"),
    "dp2-sp2-lora": (dict(dp=2, sp=2), dict(sp_mode="ulysses"), "mm",
                     "lora"),
    # a MoE LLM (4 experts, top 2): 2 experts a tp rank
    "moe-tp2-sp2": (dict(tp=2, sp=2), dict(sp_mode="ulysses"), "mm", "moe"),
    "sp4-ring-zigzag": (dict(sp=4), dict(sp_mode="ring",
                                         ring_layout="zigzag"), "mm",
                        "refused"),
    "sp4-hybrid-stripe": (dict(sp=4), dict(sp_mode="hybrid",
                                           hybrid_ulysses=2,
                                           ring_layout="stripe"), "mm",
                          "refused"),
    "sp4-ring-zigzag-packed": (dict(sp=4), dict(sp_mode="ring",
                                                ring_layout="zigzag"),
                               "packed", "refused"),
    # tp 4 divides the MLP width but not the 2 KV heads: the attention
    # runs whole on every tp rank, the MLP cut (mesh.py `tp_cut`)
    "tp4": (dict(tp=4), {}, "mm", "full"),
    # LLM variants (LLM_VARIANTS): Gemma-2's query_pre_attn_scalar scale
    # through the ring; a sliding window and an attention softcap, which
    # no sp attention applies, refused under sp
    "sp4-ring-scale": (dict(sp=4), dict(sp_mode="ring"), "mm", "full"),
    "sp2-dp2-window": (dict(sp=2, dp=2), dict(sp_mode="ring"), "mm",
                       "refused"),
    "sp4-ulysses-softcap": (dict(sp=4), dict(sp_mode="ulysses"), "mm",
                            "refused"),
}
LLM_VARIANTS = {"sp4-ring-scale": dict(query_pre_attn_scalar=8),
                "sp2-dp2-window": dict(sliding_window=8),
                "sp4-ulysses-softcap": dict(attn_logit_softcap=30.0)}
LORA_R = 4


def train_config(case):
    from aurora_tpu_torch.train.trainer import TrainConfig
    return TrainConfig(lr=LR, max_steps=10, warmup_ratio=0.0, remat=True,
                       **TRAIN_CASES[case][1])


def load_tiny(outdir):
    """The tiny AuroraCap the test wrote (model.pt) and its batches."""
    import numpy as np
    import torch
    from aurora_tpu_torch.models.aurora import AuroraConfig, init_aurora
    model = init_aurora(AuroraConfig.tiny(), device="cpu",
                        dtype=torch.float32,
                        generator=torch.Generator().manual_seed(0))
    model.load_state_dict(torch.load(os.path.join(outdir, "model.pt")))
    batches = {}
    with np.load(os.path.join(outdir, "batches.npz")) as f:
        for key in f.files:
            kind, name = key.split("/")
            batches.setdefault(kind, {})[name] = torch.from_numpy(f[key])
    return model, batches


def case_model(outdir, case):
    """The model of a train case: the tiny AuroraCap the test wrote, the
    MoE one, or the tiny one with the case's LLM_VARIANTS fields."""
    import dataclasses
    import torch
    from aurora_tpu_torch.models.aurora import init_aurora
    if TRAIN_CASES[case][3] == "moe":
        return moe_model()
    model, _ = load_tiny(outdir)
    if case in LLM_VARIANTS:
        cfg = dataclasses.replace(model.cfg, llm=dataclasses.replace(
            model.cfg.llm, **LLM_VARIANTS[case]))
        variant = init_aurora(cfg, device="cpu", dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
        variant.load_state_dict(model.state_dict())
        return variant
    return model


def moe_model():
    """The tiny AuroraCap with a MoE LLM (4 experts, top 2), seeded."""
    import dataclasses
    import torch
    from aurora_tpu_torch.models.aurora import AuroraConfig, init_aurora
    cfg = AuroraConfig.tiny()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_experts=4, num_experts_per_tok=2))
    return init_aurora(cfg, device="cpu", dtype=torch.float32,
                       generator=torch.Generator().manual_seed(5))


def lora_setup(model):
    """Adapters on q and v of every LLM layer, seeded; the optimizer."""
    import torch
    from aurora_tpu_torch.train.lora import LoraConfig, init_lora_params
    lcfg = LoraConfig(r=LORA_R, alpha=8,
                      target_patterns=(r"llm\.layers\.\d+\.(q|v)$",))
    adapters = init_lora_params(torch.Generator().manual_seed(7), model,
                                lcfg)
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():               # b starts at 0: move it
        for ab in adapters.values():
            ab["b"].normal_(0, 0.02, generator=g)
    return lcfg, adapters


def _roundtrip(state, mesh, outdir, tcfg, case):
    """The checkpoint path of a mesh state: `gathered_state` (the
    one-process layout) loaded into a fresh model and one-process state,
    then `shard_state` again → True when every shard, moment and the
    step come back equal."""
    import torch
    from aurora_tpu_torch.train import trainer
    tree = trainer.gathered_state(state)
    fresh = case_model(outdir, case)
    fresh.load_state_dict(tree["params"], strict=True)
    again = trainer.shard_state(trainer.TrainState(
        params=trainer.apply_freeze(fresh, tcfg),
        opt_state=tree["opt_state"], step=tree["step"]), mesh)
    plan, plan2 = state.params, again.params
    same = all(torch.equal(a, b) for a, b in zip(plan.params(),
                                                 plan2.params()))
    for key in ("mu", "nu"):
        same &= all(torch.equal(a, b) for a, b in zip(
            state.opt_state[key], again.opt_state[key]))
    return bool(same and again.step == state.step
                and again.opt_state["count"] == state.opt_state["count"])


def suite_train(_, rank, outdir):
    """Every train case: one step on its mesh from the same model and
    global batch; loss, ntokens, grad_norm and the updated trainable
    tensors (whole, by name) or the refusal's message."""
    import torch
    from aurora_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                                local_rows, shard_model)
    from aurora_tpu_torch.train import trainer
    from aurora_tpu_torch.train.lora import (adapter_tensors,
                                             make_lora_train_step)
    out, meshes = {}, {}
    _, batches = load_tiny(outdir)
    for case, (mesh_kw, _, kind, step_kind) in TRAIN_CASES.items():
        model = case_model(outdir, case)
        tcfg = train_config(case)
        key = tuple(sorted(mesh_kw.items()))
        if key not in meshes:           # one mesh (and its groups) a shape
            meshes[key] = create_mesh(MeshConfig(**mesh_kw), "cpu")
        mesh = meshes[key]
        batch = local_rows(mesh, batches[kind])
        if step_kind == "lora":
            lcfg, adapters = lora_setup(model)
            opt = trainer.lora_optimizer(tcfg)
            step = make_lora_train_step(model.cfg, tcfg, model, lcfg, opt,
                                        mesh=mesh)
            params = adapter_tensors(adapters)
            ad, _, m = step(adapters, opt.init(params), batch)
            named = {f"{path}/{k}": t for path, ab in ad.items()
                     for k, t in ab.items()}
        else:
            acfg = model.cfg
            plan = shard_model(trainer.apply_freeze(model, tcfg), mesh)
            state = trainer.init_train_state(plan, tcfg)
            step = trainer.make_train_step(acfg, tcfg, mesh=mesh)
            if step_kind == "refused":
                try:
                    step(state, batch)
                except (NotImplementedError, ValueError) as e:
                    out[f"{case}/refused"] = f"{type(e).__name__}: {e}"
                continue
            # the step's gradients (summed over the ranks), whole by name
            _, _, grads = trainer.loss_and_grads(
                plan.model, batch, tcfg, plan.params(), mesh,
                trainer._build_sp_attn(tcfg, mesh), plan.tp,
                before=plan.gather_root)
            plan.release()
            for name, g in plan.unshard(plan.reduce_grads(grads)).items():
                out[f"{case}/grad/{name}"] = g.numpy()
            state, m = step(state, batch)
            named = plan.unshard(plan.params())
            out[f"{case}/param_bytes"] = sum(
                p.numel() * p.element_size() for p in plan.params())
            out[f"{case}/roundtrip"] = _roundtrip(state, mesh, outdir, tcfg,
                                                  case)
        for key in ("loss", "ntokens", "grad_norm"):
            out[f"{case}/{key}"] = float(m[key])
        for name, t in named.items():
            out[f"{case}/param/{name}"] = t.detach().numpy()
    return out


DP_CASES = {"dp2": dict(dp=2), "fsdp2": dict(fsdp=2)}


def dp_batch():
    """A multimodal global batch of 4 rows (each rank of dp 2 or fsdp 2
    takes other rows)."""
    import numpy as np
    import torch
    from aurora_tpu_torch.utils.constants import (IGNORE_INDEX,
                                                  IMAGE_TOKEN_INDEX)
    rng = np.random.default_rng(11)
    ids = rng.integers(3, 250, size=(4, 14))
    ids[:, 2] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    labels[:, :3] = IGNORE_INDEX
    return {"input_ids": torch.from_numpy(ids),
            "labels": torch.from_numpy(labels),
            "attention_mask": torch.ones((4, 14), dtype=torch.bool),
            "pixel_values": torch.from_numpy(rng.standard_normal(
                (4, 1, 3, 56, 56)).astype(np.float32))}


def dp_model():
    import torch
    from aurora_tpu_torch.models.aurora import AuroraConfig, init_aurora
    return init_aurora(AuroraConfig.tiny(), device="cpu",
                       dtype=torch.float32,
                       generator=torch.Generator().manual_seed(3))


def suite_dp(_, rank, outdir):
    """One step on dp 2 and on fsdp 2 (2 ranks, other rows each): the
    rank's rows, loss, grad norm, the updated parameters (whole) and a
    checksum of their bytes."""
    import hashlib
    import torch
    from aurora_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                                local_rows, shard_model)
    from aurora_tpu_torch.train import trainer
    out = {"world": torch.distributed.get_world_size(), "rank": rank}
    for case, mesh_kw in DP_CASES.items():
        tcfg = trainer.TrainConfig(lr=LR, max_steps=10, warmup_ratio=0.0,
                                   remat=True)
        model = dp_model()
        mesh = create_mesh(MeshConfig(**mesh_kw), "cpu")
        plan = shard_model(trainer.apply_freeze(model, tcfg), mesh)
        state = trainer.init_train_state(plan, tcfg)
        batch = local_rows(mesh, dp_batch())
        state, m = trainer.make_train_step(model.cfg, tcfg, mesh=mesh)(
            state, batch)
        whole = plan.unshard(plan.params())
        digest = hashlib.sha256()
        for name in plan.names:
            digest.update(whole[name].numpy().tobytes())
            out[f"{case}/param/{name}"] = whole[name].numpy()
        out[f"{case}/rows"] = batch["input_ids"].numpy()
        out[f"{case}/checksum"] = digest.hexdigest()
        out[f"{case}/shard_bytes"] = sum(t.numel() * t.element_size()
                                         for t in plan.params())
        for key in ("loss", "grad_norm", "ntokens"):
            out[f"{case}/{key}"] = float(m[key])
    return out


SUITES = {"attn": (suite_attn, dict(sp=4)), "train": (suite_train, None),
          "dp": (suite_dp, None)}


def main(suite, outdir):
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    from aurora_tpu_torch.parallel.distributed import init_distributed
    from aurora_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    torch.set_num_threads(1)
    assert init_distributed(device_type="cpu", log=lambda *_: None)
    rank = torch.distributed.get_rank()
    fn, mesh_kw = SUITES[suite]
    if mesh_kw:
        out = fn(create_mesh(MeshConfig(**mesh_kw), "cpu"), rank)
    else:
        out = fn(None, rank, outdir)
    np.savez(os.path.join(outdir, f"{suite}_rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(suite, world, outdir, timeout=300, args=(), env=None,
           module=None):
    """Start `world` ranks (this script on SUITE, or `python -m module
    args...`) under a torchrun environment; wait for all of them; raise
    with a rank's output tail if any failed. → each rank's stdout."""
    port = free_port()
    base = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                OMP_NUM_THREADS="1", PYTHONPATH=REPO, **(env or {}))
    base.pop("JAX_PLATFORMS", None)
    cmd = ([sys.executable, "-m", module, *args] if module else
           [sys.executable, os.path.abspath(__file__), suite, outdir])
    procs = [subprocess.Popen(cmd, env=dict(base, RANK=str(r),
                                            LOCAL_RANK=str(r)),
                              cwd=outdir, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline -
                                               time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{suite} rank {r} exited {p.returncode}:\n"
                               f"{out[-4000:]}")
    return outs


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
