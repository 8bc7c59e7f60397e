"""Serving launch CLI (aurora_tpu/cli/serve.py): the HTTP server of
serve/api.py over one ServeEngine on the card.

    python -m aurora_tpu_torch serve --model_path <hf-or-xtuner dir> \
        --port 30000 --max-batch 8 --mem-fraction 0.8 [--aurora]

The reference's flags (its launch_server_auroracap and launch_server
surface), plus --device (default cuda). --aurora loads an xtuner-format
AuroraCap directory (models/convert.py `load_auroracap_dir`) and serves
/generate with videos; otherwise a HF directory of a dense or sparse-MoE
decoder family (models/convert.py DENSE_TYPES, MOE_TYPES: Mixtral,
Qwen-MoE, DBRX, Grok-1, DeepSeek v1), Gemma-2 or DeepSeek-V2 (MLA,
bf16 only) (`load_serving_dir`). --weight-quant int8|int4 quantizes each
layer as it reaches the card, so Mixtral-8x7B, 93 GB in bf16, loads as
W8 or W4. The checkpoint's tokenizer loads through transformers.
--max-batch 0 or --num-slots 0 sizes the engine from the free device
memory (`auto_engine_config`). Requests may take `regex` or
`choices_constraint` (constrained decoding) and prompts up to
--max-seq-len. --tp N cuts each engine's model into N shards on N cards
(serve/tp.py; the streams of W8 weights are fused per shard, after the
cut), --dp N serves N replicas behind --dispatch (serve/controller.py).
What a model does not take exits 2, as the reference stops it:
DeepSeek-V2 (MLA) with --weight-quant, --kv-quant or --tp above 1, and W4
weights or packed int4 KV with --tp above 1.
"""

from __future__ import annotations

import argparse
import sys

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _is_mla(model_path: str) -> bool:
    """A DeepSeek-V2 (MLA) checkpoint directory."""
    from aurora_tpu_torch.models.convert import _read_config
    hf = _read_config(model_path)
    return ("DeepseekV2" in " ".join(hf.get("architectures") or [])
            or hf.get("model_type") == "deepseek_v2")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True,
                   help="HF decoder dir or xtuner-format AuroraCap dir")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=30000)
    p.add_argument("--max-batch", type=int, default=8,
                   help="running-batch rows; 0 → auto from free memory")
    p.add_argument("--max-seq-len", type=int, default=4096,
                   help="prompt + output tokens a request may hold; a "
                        "prompt past the largest prefill bucket (2048) "
                        "prefills in chunks beside the running decode")
    p.add_argument("--num-slots", type=int, default=0,
                   help="KV slots; 0 → sized from free device memory x "
                        "--mem-fraction")
    p.add_argument("--mem-fraction", type=float, default=0.8)
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel replicas, one a card (or a group of "
                        "--tp cards)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel cards per replica; must divide "
                        "the KV heads (W8 or bf16 weights)")
    p.add_argument("--dispatch", default="shortest_queue",
                   choices=["shortest_queue", "round_robin"])
    p.add_argument("--decode-steps", type=int, default=1,
                   help="decode steps per host sync")
    p.add_argument("--schedule-policy", default="lpm",
                   choices=["lpm", "fcfs", "lof", "random", "dfs-weight"])
    p.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--kv-quant", default="none",
                   choices=["none", "int8", "int4"],
                   help="int8 KV with per-token scales, or nibble-packed "
                        "int4")
    p.add_argument("--weight-quant", default="none",
                   choices=["none", "int8", "int4"],
                   help="int8 weights (per output channel) or int4 "
                        "(nibble-packed, groups of 128)")
    p.add_argument("--disable-radix-cache", action="store_true",
                   help="no prefix caching: every request prefills from "
                        "scratch")
    p.add_argument("--aurora", action="store_true",
                   help="model_path is an xtuner-format AuroraCap dir; "
                        "enables multimodal /generate")
    p.add_argument("--token-kept-ratio", type=float, default=0.1,
                   help="ToMe ratio for serving "
                        "(launch_server_auroracap.py:18 tome_ratio)")
    p.add_argument("--image-size", type=int, default=378)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.tp > 1 and "int4" in (args.weight_quant, args.kv_quant):
        print("W4 packed layout and packed int4 KV are single-device (use "
              "W8 with --tp>1)", file=sys.stderr)
        return 2

    from aurora_tpu_torch.data.text import auto_tokenizer
    from aurora_tpu_torch.models.convert import load_serving_dir
    from aurora_tpu_torch.serve.api import build_engine, serve_engine
    from aurora_tpu_torch.serve.engine import (_QUANTIZE, EngineConfig,
                                               auto_engine_config,
                                               fuse_serving_weights,
                                               weight_quant_of)
    from aurora_tpu_torch.serve.scheduler import SchedulePolicy
    from aurora_tpu_torch.serve.tp import shard_bytes, visible_devices

    dtype = _DTYPES[args.dtype]
    # under --tp the checkpoint loads to the host and each engine cuts it
    # onto its cards, so no card holds more than its shard; the host copy
    # goes once the engines are built
    devices = visible_devices(args.device, args.dp * args.tp)
    load_device = "cpu" if args.tp > 1 else args.device
    mm = aurora = None
    if args.aurora:
        from aurora_tpu_torch.cli.infer import load_model
        from aurora_tpu_torch.serve.multimodal import AuroraCapServing
        aurora, acfg, tokenizer = load_model(args.model_path, dtype,
                                             load_device)
        aurora.visual_encoder.to(devices[0])
        aurora.projector.to(devices[0])
        model, cfg = aurora.llm, acfg.llm
        mm = AuroraCapServing(aurora, tokenizer,
                              kept_ratio=args.token_kept_ratio,
                              image_size=args.image_size)
    else:
        if (args.kv_quant != "none" or args.tp > 1) \
                and _is_mla(args.model_path):
            print(f"--kv-quant {args.kv_quant} --tp {args.tp}: MLA "
                  "(DeepSeek-V2) serves bf16 latents on one device, as in "
                  "the reference", file=sys.stderr)
            return 2
        try:
            model, cfg = load_serving_dir(args.model_path, dtype,
                                          load_device, args.weight_quant)
        except NotImplementedError as e:
            print(f"{e}", file=sys.stderr)
            return 2
        tokenizer = auto_tokenizer(args.model_path)

    # quantize (where the loader has not, layer by layer) and fuse before
    # the engine, dropping each dense source as it goes, so that the peak
    # stays about one model; under --tp the engine cuts the model first
    # and fuses each shard
    if weight_quant_of(model) != args.weight_quant:
        model = _QUANTIZE[args.weight_quant](model, free_source=True)
    if args.weight_quant != "none" and args.tp == 1:
        model = fuse_serving_weights(model)

    ecfg = EngineConfig(max_batch=args.max_batch,
                        max_seq_len=args.max_seq_len,
                        num_slots=args.num_slots,
                        policy=SchedulePolicy(args.schedule_policy),
                        kv_dtype=dtype, kv_quant=args.kv_quant,
                        weight_quant=args.weight_quant,
                        decode_steps=args.decode_steps,
                        disable_radix_cache=args.disable_radix_cache,
                        tp=args.tp)
    if args.max_batch <= 0 or args.num_slots <= 0:
        # at tp 1 the weights are resident, so the free memory excludes
        # them; under --tp the shard that each card will hold is set aside
        ecfg = auto_engine_config(
            cfg, ecfg, mem_fraction=args.mem_fraction, device=devices[0],
            pending_bytes=shard_bytes(model, args.tp) if args.tp > 1 else 0)
        print(f"[serve] auto-sized from free memory: max_batch="
              f"{ecfg.max_batch} num_slots={ecfg.num_slots}", flush=True)
    engine = build_engine(model, cfg, ecfg,
                          devices=devices,
                          dp=args.dp, dispatch=args.dispatch,
                          embed_fn=mm.embed_fn if mm else None,
                          tokenizer=tokenizer)
    del model
    if aurora is not None and args.tp > 1:
        # the text embeddings of the prompts: the first shard's replica
        first = engine.engines[0] if args.dp > 1 else engine
        aurora.llm = first.runner.model
    serve_engine(engine, tokenizer, host=args.host, port=args.port, mm=mm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
