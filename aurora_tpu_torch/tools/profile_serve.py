"""Where the serving path's device time goes: the extend wave and the
K-step decode block of the port's DeviceRunner, on one GPU.

    python3 -m aurora_tpu_torch.tools.profile_serve          # from the repo root
    python3 -m aurora_tpu_torch.tools.profile_serve --w4kv8  # W4 weights, int8 KV
    python3 -m aurora_tpu_torch.tools.profile_serve --w8kv8  # W8 weights, int8 KV
    python3 -m aurora_tpu_torch.tools.profile_serve --w4kv4  # W4, packed int4 KV
    python3 -m aurora_tpu_torch.tools.profile_serve --w4kv8-fused  # W4 fused MLP
    python3 -m aurora_tpu_torch.tools.profile_serve --w4kv8-flat   # W4 flat layout
    python3 -m aurora_tpu_torch.tools.profile_serve --w4kv8-a8     # W4, A8 prefill
    python3 -m aurora_tpu_torch.tools.profile_serve --mistral  # sliding window
    python3 -m aurora_tpu_torch.tools.profile_serve --tiny --device cpu  # logic check

Builds Vicuna-7B-v1.5-16k (the AuroraCap-7B decoder) at full width with
random bf16 weights from a seed and the engine configuration of
chip_smoke.py (4 rows, kv_chunk 256, 1536 bucket, KV rows of prompt +
256; with --w4kv8 / --w8kv8 / --w4kv4 the LLM quantized on the device to
W4 or W8 weights with an int8 LM head, and int8 or packed int4 KV;
--w4kv8-fused / --w4kv8-flat lay the W4 weights out as
`EngineConfig(w4_fused_mlp=True)` / `(w4_tiled=False)` do, --w4kv8-a8
extends through the A8 prefill, `EngineConfig(w4_prefill="a8")`; --mistral
builds Mistral-7B instead, GQA 32/8 with its 4096-token sliding window,
bf16 weights and KV, a prompt of 6000 tokens in a 6144 bucket and rows
of 7168, so that both attention kernels run windowed), fills
the rows with one extend wave of text embeddings (the ViT is not run
here; chip_smoke.py times it), then reads:

* wall      — median host wall time of an extend wave and of a K-step
              decode block, unprofiled. Both end in a host read of their
              result, so the wall includes all device work.
* issue     — K decode forwards (forward + LM head + argmax, tokens fed
              back on the device) issued with no host sync: the host's
              issue time, and the time until the device has finished
              (CUDA events). When the device finishes within a few ms of
              the host's last launch, the host sets the pace.
* trace     — one extend wave and one decode block under torch.profiler,
              exported as a Chrome trace. Device time is the summed
              duration of the trace's kernel, memcpy and memset events;
              busy is the union of those intervals over the profiled
              span.

Two busy shares are printed for the decode block: device time /
unprofiled wall (kernels of one stream do not overlap, so this is the
share of an unprofiled step the device computes), and trace union /
profiled wall (lower: the profiler slows the host, not the kernels).
The extend wave's and the decode block's device time are also split by
kernel family, in ms per wave and per step: attention (the ragged
kernels), W4A8 (either layout),
the fused MLP (its tile kernel and its reduction), the activation
quantizer that W4A8, the fused MLP and the W8A8 path launch, and the
rest (W8A8's kernel is in the rest and in the per-kernel table); the
cuBLAS matmuls within the rest (the bf16 weight stream) are also summed
on their own, and the device events (kernels, copies, sets) a step are
counted. The trace and a per-kernel table go to --out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from collections import defaultdict

import numpy as np

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# flag → (weight_quant, kv_quant, W4 layout switches of EngineConfig)
_QUANT_MODES = {"w4kv8": ("int4", "int8", {}), "w8kv8": ("int8", "int8", {}),
                "w4kv4": ("int4", "int4", {}),
                "w4kv8-fused": ("int4", "int8", {"w4_fused_mlp": True}),
                "w4kv8-flat": ("int4", "int8", {"w4_tiled": False}),
                "w4kv8-a8": ("int4", "int8", {"w4_prefill": "a8"})}
# decode kernel families: name → substrings of the device kernels' names
_FAMILIES = {"attention": ("decode_kernel", "extend_kernel"),
             "w4a8": ("w4a8_kernel",),
             "fused_mlp": ("mlp_tile_kernel", "mlp_reduce"),
             "quantizer": ("quantize_rows",)}
# dense matmul kernels (cuBLAS, CUTLASS), a part of "other"
_MATMUL = ("nvjet", "gemm", "gemv", "cutlass", "xmma")


def device_events(trace_path):
    """(name, start_us, dur_us) of every device event in a Chrome trace."""
    with open(trace_path) as f:
        trace = json.load(f)
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in evs
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]


def union_us(events) -> float:
    """Length of the union of the events' [start, start + dur) intervals."""
    total, end = 0.0, -np.inf
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        if ts >= end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def kernel_table(events, per: int, top: int = 15):
    """The `top` kernel names by summed duration, in µs per `per`."""
    acc = defaultdict(lambda: [0.0, 0])
    for name, _, dur in events:
        acc[name][0] += dur
        acc[name][1] += 1
    rows = sorted(acc.items(), key=lambda kv: -kv[1][0])[:top]
    return [{"name": n[:90], "us_per": round(t / per, 1),
             "calls_per": c / per} for n, (t, c) in rows]


def family_ms(events, per: int):
    """Device ms per `per` of each family of _FAMILIES, and "other"."""
    out = dict.fromkeys(list(_FAMILIES) + ["other"], 0.0)
    for name, _, dur in events:
        fam = next((f for f, keys in _FAMILIES.items()
                    if any(k in name for k in keys)), "other")
        out[fam] += dur / 1e3 / per
    return out


def matmul_ms(events, per: int) -> float:
    """Device ms per `per` of the dense matmul kernels (_MATMUL) outside
    the families of _FAMILIES."""
    return sum(dur for name, _, dur in events
               if any(k in name for k in _MATMUL)
               and not any(k in name for keys in _FAMILIES.values()
                           for k in keys)) / 1e3 / per


def trace_device(fn, path, sync, activities):
    """Run fn once under torch.profiler, synchronized before and after,
    and export its Chrome trace to `path` → (profiled wall ms, the
    trace's device events)."""
    from torch.profiler import profile
    sync()
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t) * 1e3
    prof.export_chrome_trace(path)
    return wall, device_events(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16,
                    help="decode steps per block (K)")
    ap.add_argument("--reps", type=int, default=5,
                    help="unprofiled repetitions per timing")
    ap.add_argument("--prompt", type=int, default=None,
                    help="prompt tokens per row (1406; 6000 with --mistral)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="LlamaConfig.tiny() with a short prompt")
    for flag, what in _QUANT_MODES.items():
        ap.add_argument("--" + flag, dest=flag.replace("-", "_"),
                        action="store_true",
                        help=f"{what[0]} weights (quantized on the device) "
                             f"and {what[1]} KV")
    ap.add_argument("--mistral", action="store_true",
                    help="Mistral-7B with its sliding window, bf16 weights "
                         "and KV")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="build/profile_serve")
    args = ap.parse_args(argv)

    import torch
    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from aurora_tpu_torch.serve.engine import (DeviceRunner, EngineConfig,
                                               _forward_rows, _lm_head,
                                               fuse_serving_weights,
                                               quantize_weights_int4,
                                               quantize_weights_int8,
                                               w4_decode_layout)

    dev = torch.device(args.device)
    on_gpu = dev.type == "cuda"
    if on_gpu and not torch.cuda.is_available():
        print("profile_serve: CUDA is not available")
        return 1
    if args.tiny:       # --mistral: a window shorter than the prompt
        cfg = LlamaConfig.tiny()
        if args.mistral:
            cfg = dataclasses.replace(cfg, sliding_window=8)
    elif args.mistral:
        cfg = LlamaConfig.mistral_7b()
    else:
        cfg = LlamaConfig.vicuna_7b_v15_16k()
    P = 20 if args.tiny else args.prompt or (6000 if args.mistral else 1406)
    bucket = 32 if args.tiny else 6144 if args.mistral else 1536
    kv_chunk = 1024 if args.mistral and not args.tiny else 256
    dtype = torch.bfloat16 if on_gpu else torch.float32
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = build(LlamaModel, cfg, device=dev, dtype=dtype, generator=gen)
    K, B = args.steps, args.batch
    if K * (args.reps + 3) > 256:
        ap.error("steps × (reps + 3) decode positions must fit the 256 "
                 "generated tokens of a row")
    modes = [m for m in _QUANT_MODES if getattr(args, m.replace("-", "_"))]
    if len(modes) > 1 or (modes and args.mistral):
        ap.error("at most one of --mistral, --" + ", --".join(_QUANT_MODES))
    wq, kq, layout = _QUANT_MODES[modes[0]] if modes else (None, None, {})
    quant = {}
    if modes:
        quantize = {"int4": quantize_weights_int4,
                    "int8": quantize_weights_int8}[wq]
        model = fuse_serving_weights(quantize(model, free_source=True))
        quant = dict(weight_quant=wq, kv_quant=kq, **layout)
    ecfg = EngineConfig(max_batch=B, kv_chunk=kv_chunk,
                        prefill_buckets=(bucket,),
                        decode_steps=K, kv_dtype=dtype, max_seq_len=P + 256,
                        **quant)
    model = w4_decode_layout(model, cfg, ecfg)
    runner = DeviceRunner(model, cfg, ecfg, dev, seed=args.seed)
    os.makedirs(args.out, exist_ok=True)

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

    rows = np.arange(B, dtype=np.int32)
    offs = np.zeros(B, np.int32)
    lens = np.full(B, P, np.int32)
    embeds = (0.02 * torch.randn((B, bucket, cfg.hidden_size), device=dev,
                                 generator=gen)).to(dtype)
    ids = torch.randint(0, cfg.vocab_size, (B,), device=dev, generator=gen)
    tokens = ids.cpu().numpy()
    active = np.ones(B, bool)
    samp = {"temp": np.zeros(B, np.float32),
            "top_k": np.zeros(B, np.int64), "top_p": np.ones(B, np.float32),
            "min_p": np.zeros(B, np.float32),
            "freq": np.zeros(B, np.float32), "pres": np.zeros(B, np.float32),
            "rep": np.ones(B, np.float32)}
    pos = [P]   # next decode position; each block advances it by K

    def extend():
        return runner.extend(embeds, rows, offs, lens).cpu()

    def decode():
        runner.decode_block(tokens, np.full(B, pos[0], np.int32), active,
                            samp, K, None, all_greedy=True,
                            want_logprobs=False)
        pos[0] += K

    def walls(fn, reps):
        fn()                                        # warm-up
        out = []
        for _ in range(reps):
            sync()
            t = time.perf_counter()
            fn()
            out.append(time.perf_counter() - t)
        return float(np.median(out)) * 1e3

    extend_ms = walls(extend, args.reps)
    pos[0] = P
    decode_ms = walls(decode, args.reps)

    # issue: forwards with no host sync, device finish by CUDA events
    layer_ids = runner.layer_ids
    row_t = torch.arange(B, dtype=torch.int32, device=dev)
    issue_ms = drain_ms = float("nan")
    if on_gpu:
        with torch.no_grad():
            tok = ids.clone()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            p0 = pos[0]
            sync()
            t = time.perf_counter()
            start.record()
            for j in range(K):
                p = torch.full((B,), p0 + j, dtype=torch.int32, device=dev)
                x = _forward_rows(model, cfg, model.embed_tokens[tok][:, None],
                                  runner.rows, row_t, p, p + 1, layer_ids)
                tok = _lm_head(model, x).argmax(-1)
            stop.record()
            issue_ms = (time.perf_counter() - t) * 1e3
            stop.synchronize()
            done_ms = (time.perf_counter() - t) * 1e3
            drain_ms = done_ms - issue_ms
            device_span_ms = start.elapsed_time(stop)
            pos[0] += K

    # trace
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu
                                     else [])
    res = {"card": card, "model": "mistral-7b" if args.mistral else
           "vicuna-7b-v1.5-16k", "window": cfg.sliding_window,
           "K": K, "batch": B, "prompt": P,
           "weights": wq or str(dtype).split(".")[-1],
           "mode": modes[0] if modes else None,
           "kv": kq or str(dtype).split(".")[-1],
           "extend_wall_ms": extend_ms, "decode_wall_ms_per_step":
           decode_ms / K, "issue_ms_per_step": issue_ms / K,
           "drain_ms_after_issue": drain_ms}
    if on_gpu:
        res["issue_device_span_ms_per_step"] = device_span_ms / K
    for name, fn, per in (("extend", extend, 1), ("decode", decode, K)):
        wall, evs = trace_device(fn, os.path.join(args.out,
                                                  f"{name}_trace.json"),
                                 sync, acts)
        dev_ms = sum(d for _, _, d in evs) / 1e3
        uni_ms = union_us(evs) / 1e3
        res[f"{name}_profiled_wall_ms"] = wall
        res[f"{name}_device_ms"] = dev_ms
        res[f"{name}_device_union_ms"] = uni_ms
        res[f"{name}_kernels"] = kernel_table(evs, per)
        unit = "wave" if name == "extend" else "step"
        res[f"{name}_ms_per_{unit}_by_family"] = family_ms(evs, per)
        res[f"{name}_ms_per_{unit}_dense_matmul"] = matmul_ms(evs, per)
        if name == "decode":
            res["decode_device_events_per_step"] = len(evs) / per
        print(f"{name}: {len(evs)} device events, device {dev_ms:.3f} ms, "
              f"union {uni_ms:.3f} ms, profiled wall {wall:.3f} ms",
              flush=True)
    unprof = {"extend": extend_ms, "decode": decode_ms}
    for name in ("extend", "decode"):
        res[f"{name}_busy_of_unprofiled_wall"] = \
            res[f"{name}_device_ms"] / unprof[name]
        res[f"{name}_busy_of_profiled_wall"] = \
            res[f"{name}_device_union_ms"] / res[f"{name}_profiled_wall_ms"]
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(res, f, indent=1)
    for name, unit in (("extend", "wave"), ("decode", "step")):
        print(f"top {name} kernels (µs per {unit}):")
        for row in res[f"{name}_kernels"]:
            print(f"  {row['us_per']:>10.1f}  x{row['calls_per']:<6g} "
                  f"{row['name']}")
    print(json.dumps({k: v for k, v in res.items()
                      if not k.endswith("_kernels")}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
