"""Training CLI, the `xtuner train` equivalent (aurora_tpu/cli/train.py).

    python -m aurora_tpu_torch train --stage pretrain \
        --model_path <xtuner dir> --data data.json --image_folder imgs/ \
        --work_dir runs/exp1 --max_steps 100

The reference's flags, one for one, plus --device (default cuda; the
tests pass cpu): the stage curriculum (train/configs.py, --config from
copy-cfg), the llava-format dataset with frames made on the device
(data/dataset.py), length-grouped sampling, the bucketed pad (the longest
sample rounded up to 64, capped at max_length) or --pack_max_length
packing with per-document segment attention, worker threads that decode
and collate the next batches (data/prefetch.py), checkpoints every
--checkpoint_interval steps and at the end (train/checkpoint.py) with
--resume from the latest, (Q)LoRA with --lora_r / --quant
(train/lora.py, train/quant.py; lora.json marks the run), and the log
record {step, loss, grad_norm, lr, tgs, tflops, eta_s} printed and
appended to train_log.jsonl. Throughput counts every rank's device. The
exposed data wait (the time `next()` on the prefetcher blocks) is printed
at the end.

--mesh dp=…,fsdp=…,sp=…,tp=… trains on a mesh of that many ranks, one
process each, as torchrun starts them:

    torchrun --nproc_per_node 4 -m aurora_tpu_torch train --mesh sp=4 ...

Each rank joins the group (parallel/distributed.py `init_distributed`;
NCCL on cards, gloo with --device cpu), takes card LOCAL_RANK, loads the
same weights, builds the same global batches (the same sampler and
seed), pads their sequence to a multiple of sp and keeps its rows of
them (parallel/mesh.py `local_rows`); the step is train/trainer.py's on
the mesh (a mesh with sp > 1 and a stage without sp_mode takes
"ulysses"; (Q)LoRA takes dp, fsdp and sp). Only rank 0 prints the log,
writes train_log.jsonl and writes checkpoints, in the one-process layout
(`trainer.gathered_state`), so that a run resumes on any mesh or in one
process. --mesh with a product above 1 and no torchrun environment
exits 2. `run(parse_args(argv))` is `main` that also returns the run
(per-step losses and grad norms unrounded, timings, the trained state)
for in-process callers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="aurora train", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--stage", default="pretrain",
                   choices=["pretrain", "vision", "language"])
    p.add_argument("--config", default=None,
                   help="copy-cfg JSON with stage-config overrides "
                        "(the --cfg-options analog); explicit CLI flags "
                        "still win")
    p.add_argument("--model_path", required=True,
                   help="xtuner-format (or llava-hf) model dir")
    p.add_argument("--data", required=True, help="llava-format json/jsonl")
    p.add_argument("--image_folder", default="")
    p.add_argument("--work_dir", default="work_dir")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_length", type=int, default=None)
    p.add_argument("--image_size", type=int, default=None)
    p.add_argument("--mesh", default="",
                   help="e.g. dp=2,fsdp=2,sp=1,tp=2: one rank each, "
                        "started by torchrun")
    p.add_argument("--checkpoint_interval", type=int, default=500)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--pack_max_length", type=int, default=0,
                   help=">0 packs samples to this fused length with "
                        "per-document segment attention")
    p.add_argument("--cache_dir", default=None,
                   help="cache tokenized datasets here")
    p.add_argument("--wandb_project", default=None,
                   help="mirror metrics to Weights & Biases (optional)")
    p.add_argument("--lora_r", type=int, default=0,
                   help=">0 trains LoRA adapters over a frozen base")
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--quant", default="none",
                   choices=["none", "int8", "int4"],
                   help="store the frozen LLM quantized and dequantize "
                        "per layer (QLoRA analog; needs --lora_r)")
    p.add_argument("--num_workers", type=int, default=2,
                   help="host decode/preprocess threads")
    p.add_argument("--prefetch", type=int, default=2,
                   help="in-flight batches (2 = double buffering)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--remat-policy", default=None,
                   help="selective remat policy (models/remat.py: "
                        "dots_with_no_batch_dims_saveable, dots_saveable); "
                        "default: full remat")
    p.add_argument("--float32", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.mesh:
        from aurora_tpu_torch.parallel.mesh import parse_mesh
        try:
            n = parse_mesh(args.mesh).num_devices
        except (ValueError, TypeError) as e:
            p.error(f"--mesh {args.mesh!r}: {e}")
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if n > 1 and world == 1:
            p.error(f"--mesh {args.mesh} asks for {n} ranks: start them with "
                    f"torchrun --nproc_per_node {n} -m aurora_tpu_torch "
                    "train ...")
        if world not in (1, n):
            p.error(f"--mesh {args.mesh} needs {n} ranks; torchrun started "
                    f"{world}")
    if args.quant != "none" and args.lora_r <= 0:
        p.error("--quant requires --lora_r (quantized base is frozen; "
                "full-parameter training needs a float base)")
    return args


@dataclasses.dataclass
class TrainRun:
    """What `run` did: `history` has one entry per step (loss, grad_norm,
    ntokens, lr: floats; on logged steps also step_s and data_s, the
    step's wall time and exposed data wait averaged over the log window
    it closed, and the window's tgs and tflops); `saves` one per
    checkpoint written (step, GB, seconds)."""
    start: int
    history: List[Dict[str, Any]]
    model: Any
    state: Any
    saves: List[Dict[str, float]]
    restore_s: Optional[float]
    base_bytes: Optional[Dict[str, int]] = None


def _batch_to_device(batch: Dict[str, Any], device, dtype) -> Dict:
    out = {}
    for k, v in batch.items():
        if k == "pixel_values":
            out[k] = torch.as_tensor(v, device=device).to(dtype)
        elif v.dtype == np.bool_:
            out[k] = torch.as_tensor(v, device=device)
        else:
            out[k] = torch.as_tensor(v, device=device).long()
    return out


def run(args: argparse.Namespace) -> TrainRun:
    from aurora_tpu_torch.cli.infer import load_model
    from aurora_tpu_torch.data.collate import (SoftPackerMM,
                                               default_collate_fn,
                                               packed_collate_mm)
    from aurora_tpu_torch.data.dataset import AuroraDataset, aurora_map_fn
    from aurora_tpu_torch.data.prefetch import BatchPrefetcher, index_stream
    from aurora_tpu_torch.data.sampler import LengthGroupedSampler
    from aurora_tpu_torch.models.aurora import num_visual_tokens
    from aurora_tpu_torch.train.checkpoint import (checkpoint_path,
                                                   latest_step,
                                                   restore_checkpoint,
                                                   save_checkpoint)
    from aurora_tpu_torch.train.configs import STAGES
    from aurora_tpu_torch.train.metrics import Throughput
    from aurora_tpu_torch.train.trainer import (gathered_state,
                                                init_train_state,
                                                make_optimizer,
                                                make_train_step, shard_state)
    from aurora_tpu_torch.utils.constants import IMAGE_TOKEN_INDEX
    from aurora_tpu_torch.utils.loggers import MetricsLogger
    from aurora_tpu_torch.utils.templates import PROMPT_TEMPLATE
    from aurora_tpu_torch.parallel import distributed
    from aurora_tpu_torch.parallel.mesh import (create_mesh, local_rows,
                                                parse_mesh)

    device = torch.device(args.device)
    mesh = None
    if args.mesh and distributed.init_distributed(device_type=device.type):
        device = distributed.rank_device(device.type)
        mesh = create_mesh(parse_mesh(args.mesh), device.type)
    lead = distributed.rank() == 0          # logs and checkpoints
    sp = mesh.cfg.sp if mesh is not None else 1
    dtype = torch.float32 if args.float32 else torch.bfloat16
    stage = STAGES[args.stage]()
    if args.config:
        from aurora_tpu_torch.cli.cfg_tools import load_cfg_overrides
        stage = load_cfg_overrides(args.config, stage)
    if args.max_steps:
        stage = dataclasses.replace(
            stage, train=dataclasses.replace(stage.train,
                                             max_steps=args.max_steps))
    batch_size = args.batch_size or stage.batch_size
    image_size = args.image_size or stage.image_size
    max_length = args.max_length or stage.max_length

    # ---- model
    model, acfg, tokenizer = load_model(args.model_path, dtype=dtype,
                                        device=device)
    acfg = dataclasses.replace(acfg, slowfast=stage.slowfast)
    model.cfg = acfg

    # ---- data
    ds = AuroraDataset(args.data, tokenizer,
                       image_folder=args.image_folder,
                       map_fn=aurora_map_fn,
                       template=PROMPT_TEMPLATE.vicuna,
                       max_length=max_length, image_size=image_size,
                       cache_dir=args.cache_dir, device=device)
    packer = None
    if args.pack_max_length:
        n_vis = num_visual_tokens(acfg, stage.train.kept_ratio,
                                  image_size, image_size)
        packer = SoftPackerMM(ds.text_data, args.pack_max_length,
                              n_visual_tokens=n_vis, dataset=ds)

        # modality-signed lengths keep batches pack-homogeneous (mixed
        # text/frame packs would inflate the fused width)
        def pack_len(members):
            n = sum(len(ds.text_data[i]["input_ids"]) for i in members)
            has_img = any(IMAGE_TOKEN_INDEX in ds.text_data[i]["input_ids"]
                          for i in members)
            return n if has_img else -n
        sampler = LengthGroupedSampler(
            [pack_len(p) for p in packer.packs], batch_size,
            seed=args.seed)
    else:
        sampler = LengthGroupedSampler(ds.modality_length(), batch_size,
                                       seed=args.seed)

    # ---- state
    tcfg = stage.train
    if args.remat_policy:
        tcfg = dataclasses.replace(tcfg, remat_policy=args.remat_policy)
    if sp > 1 and tcfg.sp_mode is None:
        tcfg = dataclasses.replace(tcfg, sp_mode="ulysses")
        if lead:
            print(f"--mesh sp={sp}: the stage names no sp_mode; Ulysses")
    ckpt_dir = os.path.join(args.work_dir, "checkpoints")
    start, restore_s, base_bytes = 0, None, None
    use_lora = args.lora_r > 0
    resume = args.resume and latest_step(ckpt_dir) is not None
    if use_lora:
        # (Q)LoRA: the adapters alone enter the optimizer; the (int8/int4)
        # base stays frozen (train/lora.py, train/quant.py)
        from aurora_tpu_torch.train.lora import (LoraConfig,
                                                 adapter_tensors,
                                                 init_lora_params,
                                                 make_lora_train_step)
        from aurora_tpu_torch.train.quant import (make_qlora_train_step,
                                                  quantize_base, tree_nbytes)
        from aurora_tpu_torch.train.trainer import lora_optimizer
        lcfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha)
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        adapters = init_lora_params(gen, model, lcfg)
        if args.quant != "none":
            bits = 8 if args.quant == "int8" else 4
            float_bytes = tree_nbytes(model)
            quantize_base(model, bits=bits)
            base_bytes = {"quantized": tree_nbytes(model),
                          "float": float_bytes}
            if lead:
                print(f"quantized base: {base_bytes['quantized'] / 1e9:.2f} "
                      f"GB (int{bits}) vs {float_bytes / 1e9:.2f} GB")
        opt = lora_optimizer(tcfg)
        make = (make_qlora_train_step if args.quant != "none"
                else make_lora_train_step)
        raw = make(acfg, tcfg, model, lcfg, opt, mesh=mesh)
        state = {"adapters": adapters,
                 "opt_state": opt.init(adapter_tensors(adapters))}
        if resume:
            t0 = time.perf_counter()
            state = restore_checkpoint(ckpt_dir, state)
            restore_s = time.perf_counter() - t0
            start = latest_step(ckpt_dir)

        def step_fn(st, batch):
            ad, ost, m = raw.with_base(st["adapters"], st["opt_state"],
                                       batch, model)
            return {"adapters": ad, "opt_state": ost}, m
    else:
        state = init_train_state(model, tcfg)
        if resume:
            t0 = time.perf_counter()
            state = restore_checkpoint(ckpt_dir, state)
            restore_s = time.perf_counter() - t0
            start = int(state.step)
        if mesh is not None:
            state = shard_state(state, mesh)
        opt = make_optimizer(state.params, tcfg)
        step_fn = make_train_step(acfg, tcfg, opt, mesh=mesh)
    if resume and lead:
        print(f"resumed from step {start} (restored in {restore_s:.2f} s)")
    thr = Throughput(acfg.llm.hidden_size, acfg.llm.num_hidden_layers,
                     acfg.llm.vocab_size,
                     num_devices=distributed.world_size(),
                     intermediate=acfg.llm.intermediate_size)

    os.makedirs(args.work_dir, exist_ok=True)
    logger = MetricsLogger(
        jsonl_path=(os.path.join(args.work_dir, "train_log.jsonl") if lead
                    else None),
        wandb_project=args.wandb_project if lead else None,
        run_name=f"{args.stage}-{os.path.basename(args.work_dir)}",
        config=vars(args))

    # ---- the host pipeline: worker threads decode and collate the next
    # batches while the card runs the current step; index_stream
    # fast-forwards to the resume position, so a resumed run consumes
    # exactly the batches an uninterrupted one would
    if packer is not None:
        fetch = packer.__getitem__

        def collate(items):
            return rows(packed_collate_mm(items))
    else:
        fetch = ds.__getitem__

        def collate(samples):
            # bucket the pad length: a handful of shapes, not one a batch
            longest = max(len(s["input_ids"]) for s in samples)
            bucket = min(max_length, ((longest + 63) // 64) * 64)
            return rows(default_collate_fn(samples, max_length=bucket,
                                           sequence_parallel_size=sp))

    def rows(batch):
        """This rank's rows of the global batch, on its device."""
        if mesh is not None:
            batch = local_rows(mesh, batch)
        return _batch_to_device(batch, device, dtype)

    saves: List[Dict[str, float]] = []

    def save(step: int) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        tree = (gathered_state(state)
                if mesh is not None and not use_lora else state)
        if lead and save_checkpoint(ckpt_dir, tree, step):
            gb = os.path.getsize(checkpoint_path(ckpt_dir, step)) / 1e9
            saves.append({"step": step, "gb": gb,
                          "s": time.perf_counter() - t0})
            print(f"saved checkpoint step {step}: {gb:.3f} GB in "
                  f"{saves[-1]['s']:.2f} s")

    prefetcher = BatchPrefetcher(
        index_stream(sampler, batch_size, start_step=start),
        fetch, collate, depth=max(1, args.prefetch),
        workers=max(1, args.num_workers), device=device)
    history: List[Dict[str, Any]] = []
    data_wait = 0.0
    last_logged = start
    try:
        for step_i in range(start, tcfg.max_steps):
            thr.data_tick()
            t0 = time.perf_counter()
            batch = next(prefetcher)   # blocks only on exposed host time
            data_wait += time.perf_counter() - t0
            thr.data_tock()
            state, metrics = step_fn(state, batch)
            history.append({"step": step_i + 1, **metrics})
            if lead and ((step_i + 1) % args.log_interval == 0
                         or step_i == start):
                loss = float(metrics["loss"])
                ntok = int(metrics["ntokens"])
                window = (step_i + 1) - last_logged
                last_logged = step_i + 1
                m = thr.step(ntok * window, batch["input_ids"].shape[1],
                             step_i + 1, tcfg.max_steps, window_steps=window)
                history[-1].update(step_s=m["step_time"] / window,
                                   data_s=m["data_time"] / window,
                                   tgs=m["tgs"], tflops=m["tflops"])
                rec = {"step": step_i + 1, "loss": round(loss, 4),
                       "grad_norm": round(float(metrics["grad_norm"]), 4),
                       "lr": (float(metrics["lr"]) if "lr" in metrics
                              else None),
                       "tgs": round(m["tgs"], 1),
                       "tflops": round(m["tflops"], 2),
                       "eta_s": int(m["eta_s"])}
                print(json.dumps(rec))
                logger.log(rec, step=step_i + 1)
            if (step_i + 1) % args.checkpoint_interval == 0:
                save(step_i + 1)
    finally:
        prefetcher.close()
    save(tcfg.max_steps)
    if use_lora and lead:
        # the merge recipe for export
        with open(os.path.join(args.work_dir, "lora.json"), "w") as f:
            json.dump({"r": args.lora_r, "alpha": args.lora_alpha,
                       "quant": args.quant}, f)
    logger.finish()
    for h in history:
        for k in ("loss", "grad_norm", "lr", "ntokens"):
            if k in h:
                h[k] = float(h[k])
    n = max(len(history), 1)
    if lead:
        print(f"exposed data wait: {data_wait / n * 1e3:.3f} ms a step "
              f"over {len(history)} steps")
        print(f"done; checkpoints at {ckpt_dir}")
    return TrainRun(start=start, history=history, model=model, state=state,
                    saves=saves, restore_s=restore_s, base_bytes=base_bytes)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
