"""Where the training step's device time goes, on one GPU.

    python3 -m aurora_tpu_torch.tools.profile_train             # repo root
    python3 -m aurora_tpu_torch.tools.profile_train --remat full,dots_saveable

Steps `make_train_step` on bench.py's training stage as chip_smoke.py's
`[train]` phase builds it (train/bench_stage.py: Vicuna-7B widths at
depth 4, batch 4 × seq 2048, no attention mask, so attention runs the
flash kernels). For each remat setting in --remat (full,
dots_with_no_batch_dims_saveable, dots_saveable, none) it reads the
median unprofiled step wall after one warm-up step and the peak device
memory; the first setting's step is then profiled:

* device    — summed duration of the trace's kernel, memcpy and memset
              events; busy = their union over the profiled span;
* groups    — device time of the flash kernels (csrc/flash_attention.cu),
              the cuBLAS/CUTLASS matmuls, and everything else
              (elementwise, reductions, copies, the optimizer);
* kernels   — the top kernels by device time.

The trace and a summary go to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np

from aurora_tpu_torch.tools.profile_serve import (device_events,
                                                  kernel_table, union_us)

_GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
# the kernels of csrc/flash_attention.cu as the trace names them
_FLASH_MARKS = ("::flash_fwd_kernel(", "::flash_bwd_dkv_kernel(",
                "::flash_bwd_dq_kernel(")
REPS = 3          # timed steps per setting, after one warm-up


def group_of(name: str) -> str:
    if any(m in name for m in _FLASH_MARKS):
        return "flash"
    if any(m in name.lower() for m in _GEMM_MARKS):
        return "matmul"
    return "other"


def profile(cfg, batch, settings, out: str, device) -> dict:
    """Time and profile the step of `cfg` on `batch` for each remat
    setting → the summary (also written to out/summary.json)."""
    import torch
    from aurora_tpu_torch.train import bench_stage
    from aurora_tpu_torch.train.metrics import megatron_tflops_per_device
    from aurora_tpu_torch.train.trainer import (init_train_state,
                                                make_train_step)

    dev = torch.device(device)
    on_gpu = dev.type == "cuda"
    dtype = torch.bfloat16 if on_gpu else torch.float32
    B, T = batch["input_ids"].shape
    llm = cfg.llm
    os.makedirs(out, exist_ok=True)

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    card = "cpu"
    if on_gpu:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)

    res = {"card": card, "layers": llm.num_hidden_layers, "batch": B,
           "seq": T, "settings": {}}
    profiled = None
    for setting in settings:
        remat = setting != "none"
        policy = None if setting in ("full", "none") else setting
        if on_gpu:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        model = bench_stage.init_model(cfg, dev, seed=0, dtype=dtype)
        tcfg = bench_stage.train_config(remat, policy)
        state = init_train_state(model, tcfg)
        step = make_train_step(cfg, tcfg)
        times = []
        for _ in range(REPS + 1):
            sync()
            t = time.perf_counter()
            state, m = step(state, batch)
            m["loss"].item()
            sync()
            times.append(time.perf_counter() - t)
        step_s = float(np.median(times[1:]))
        tflops = megatron_tflops_per_device(
            B * T, step_s, llm.hidden_size, llm.num_hidden_layers,
            llm.vocab_size, T, intermediate=llm.intermediate_size)
        row = {"step_ms": step_s * 1e3, "tokens_per_s": B * T / step_s,
               "tflops": tflops}
        if on_gpu:
            row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["settings"][setting] = row
        print(f"{setting}: {json.dumps(row)}", flush=True)
        if profiled is None:
            profiled = setting
            from torch.profiler import ProfilerActivity, profile as trace
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if on_gpu else [])
            sync()
            with trace(activities=acts) as prof:
                t = time.perf_counter()
                state, m = step(state, batch)
                m["loss"].item()
                sync()
                wall = (time.perf_counter() - t) * 1e3
            path = os.path.join(out, "train_step_trace.json")
            prof.export_chrome_trace(path)
            evs = device_events(path)
            groups = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
            for name, _, dur in evs:
                groups[group_of(name)] += dur / 1e3
            res.update(profiled=setting, profiled_wall_ms=wall,
                       device_ms=sum(d for _, _, d in evs) / 1e3,
                       device_union_ms=union_us(evs) / 1e3,
                       group_ms=groups, kernels=kernel_table(evs, 1, 20))
            res["busy_of_unprofiled_wall"] = res["device_ms"] / row["step_ms"]
        del model, state, step
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--remat", default="full",
                    help="comma-separated: full, none or a policy name")
    ap.add_argument("--out", default="build/profile_train")
    args = ap.parse_args(argv)

    import torch
    from aurora_tpu_torch.train import bench_stage
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available")
        return 1
    dev = torch.device("cuda", 0)
    cfg = bench_stage.aurora_config()
    res = profile(cfg, bench_stage.text_batch(cfg, dev),
                  args.remat.split(","), args.out, dev)
    print(f"top kernels of one {res['profiled']} step (µs):")
    for row in res["kernels"]:
        print(f"  {row['us_per']:>10.1f}  x{row['calls_per']:<6g} "
              f"{row['name']}")
    print(json.dumps({k: v for k, v in res.items() if k != "kernels"}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
