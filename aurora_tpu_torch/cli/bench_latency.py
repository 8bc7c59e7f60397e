"""Serving latency and throughput microbench (aurora_tpu/cli/bench_latency.py,
sglang's bench_latency.py): one batch's prefill seconds and decode tokens/s
of the continuous-batching engine on seeded random weights of a preset's
size.

    python -m aurora_tpu_torch bench-latency --preset vicuna-7b \
        --batch 8 --prompt-len 512 --decode-steps 64 \
        --weight-quant int4 --kv-quant int8

A warm-up batch runs first (the kernels' build and the first launches),
then the timed one: the extend wave of `batch` random prompts of exactly
prompt-len tokens, then decode until each request has decode-steps
tokens. On the card both phases are timed with CUDA events; with
--device cpu (the tests) by the host clock. One JSON line names the
device it ran on.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

PRESETS = {
    "tiny": dict(vocab_size=32000, hidden_size=512, intermediate_size=1024,
                 num_hidden_layers=8, num_attention_heads=8,
                 num_key_value_heads=8),
    "1b": dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
               num_hidden_layers=16, num_attention_heads=16,
               num_key_value_heads=16),
    "vicuna-7b": dict(vocab_size=32000, hidden_size=4096,
                      intermediate_size=11008, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=32,
                      max_position_embeddings=16384,
                      rope_linear_scaling=4.0),
}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def timed_s(fn, device: torch.device) -> float:
    """Seconds of fn(): CUDA events around it on the card, the host clock
    on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=512)
    p.add_argument("--decode-steps", type=int, default=64)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--block-steps", type=int, default=1,
                   help="decode steps per host sync "
                        "(EngineConfig.decode_steps)")
    p.add_argument("--kv-quant", default="none",
                   choices=["none", "int8", "int4"])
    p.add_argument("--weight-quant", default="none",
                   choices=["none", "int8", "int4"])
    p.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from aurora_tpu_torch.models.init import build
    from aurora_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from aurora_tpu_torch.serve.engine import (EngineConfig, ServeEngine,
                                               fuse_serving_weights,
                                               quantize_weights_int4,
                                               quantize_weights_int8)
    from aurora_tpu_torch.serve.scheduler import Request

    dev = torch.device(args.device)
    dtype = _DTYPES[args.dtype]
    cfg = LlamaConfig(**PRESETS[args.preset])
    model = build(LlamaModel, cfg, device=dev, dtype=dtype,
                  generator=torch.Generator(device=dev).manual_seed(0))
    if args.weight_quant == "int8":
        model = quantize_weights_int8(model, free_source=True)
    elif args.weight_quant == "int4":
        model = quantize_weights_int4(model, free_source=True)
    if args.weight_quant != "none":
        model = fuse_serving_weights(model)
    ecfg = EngineConfig(
        max_batch=args.batch, max_seq_len=args.max_seq_len,
        num_slots=args.batch * args.max_seq_len + 1,
        prefill_buckets=(args.prompt_len,), kv_dtype=dtype,
        decode_steps=args.block_steps, kv_quant=args.kv_quant,
        weight_quant=args.weight_quant)
    engine = ServeEngine(model, cfg, ecfg, device=dev)
    rng = np.random.default_rng(0)

    def submit_all():
        for i in range(args.batch):
            ids = [int(x) for x in
                   rng.integers(3, cfg.vocab_size, size=args.prompt_len)]
            engine.add_request(Request(
                rid=f"w{i}", input_ids=ids, eos_ids=(-1,),
                max_new_tokens=args.decode_steps))

    def drain():
        while engine.has_work():
            engine.step()

    with torch.inference_mode():
        submit_all()                # warm-up: build and first launches
        drain()
        submit_all()
        t_prefill = timed_s(engine._admit, dev)
        t_decode = timed_s(drain, dev)

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({
        "preset": args.preset, "batch": args.batch,
        "prompt_len": args.prompt_len,
        "weight_quant": args.weight_quant, "kv_quant": args.kv_quant,
        "prefill_s": round(t_prefill, 4),
        "prefill_tokens_per_s": round(
            args.batch * args.prompt_len / max(t_prefill, 1e-9), 1),
        "decode_steps": args.decode_steps,
        "decode_tokens_per_s": round(
            args.batch * args.decode_steps / max(t_decode, 1e-9), 1),
        "backend": dev.type, "device": name}))


if __name__ == "__main__":
    main()
