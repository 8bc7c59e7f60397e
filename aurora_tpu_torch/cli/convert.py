"""Checkpoint conversion CLI (aurora_tpu/cli/convert.py): an AuroraCap
checkpoint → the xtuner, huggingface (llava-hf) or official LLaVA layout
of models/export.py.

    python -m aurora_tpu_torch convert --src <dir> --dst out/ \
        --format xtuner|huggingface|official [--ref_model <dir>] [--step N]

--src is an xtuner-format or llava-hf directory, or a training checkpoint
directory of this package's trainer (`train/checkpoint.py`: <step>/state.pt
holding the model's state dict), whose model is sized from --ref_model
(an xtuner or llava-hf directory) and then takes the saved weights of
--step (default the latest). The reference reads an orbax checkpoint
there; this package never writes one. A (Q)LoRA run's checkpoint holds
adapters, not a model, and exits 2. The model loads in float32 on
--device (default cuda) and is written in float32, as the reference
writes it; an xtuner export copies the source directory's tokenizer
files beside the LLM.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import torch

_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                    "special_tokens_map.json", "tokenizer.model",
                    "added_tokens.json", "vocab.json", "merges.txt")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--src", required=True,
                   help="training checkpoint dir, or xtuner / llava-hf dir")
    p.add_argument("--ref_model", default=None,
                   help="xtuner or llava-hf dir that sizes the model when "
                        "--src is a training checkpoint")
    p.add_argument("--dst", required=True)
    p.add_argument("--format", default="xtuner",
                   choices=["xtuner", "huggingface", "official"])
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_aurora(model_dir: str, device):
    """An xtuner or llava-hf directory → (AuroraModel, AuroraConfig) in
    float32 on `device` (no tokenizer: cli/infer.py `load_model` without
    transformers)."""
    from aurora_tpu_torch.models.aurora import AuroraConfig, AuroraModel
    from aurora_tpu_torch.models.convert import (_read_config,
                                                 load_auroracap_dir,
                                                 load_llava_hf_dir)
    load = (load_llava_hf_dir if _read_config(model_dir).get("model_type")
            in ("llava", "llava_next") else load_auroracap_dir)
    llm, llm_cfg, vit, vit_cfg, pj, pj_cfg = load(
        model_dir, llm_dtype=torch.float32, vit_dtype=torch.float32,
        device=device)
    cfg = AuroraConfig(vit=vit_cfg, llm=llm_cfg, projector=pj_cfg)
    model = AuroraModel(cfg, device="meta")
    model.visual_encoder, model.projector, model.llm = vit, pj, llm
    return model, cfg


def main(argv=None) -> int:
    args = parse_args(argv)
    from aurora_tpu_torch.models.export import EXPORTERS
    from aurora_tpu_torch.train.checkpoint import (checkpoint_path,
                                                   latest_step)
    device = torch.device(args.device)
    step = latest_step(args.src) if os.path.isdir(args.src) else None
    if step is not None or args.step is not None:     # a training run
        if not args.ref_model:
            print("--ref_model is needed to size the model of a training "
                  "checkpoint", file=sys.stderr)
            return 2
        model, _ = load_aurora(args.ref_model, device)
        saved = torch.load(checkpoint_path(args.src, args.step or step),
                           map_location="cpu", weights_only=True)
        if "params" not in saved:
            print(f"{args.src}: a (Q)LoRA checkpoint holds adapters, not a "
                  "model", file=sys.stderr)
            return 2
        model.load_state_dict(saved["params"], strict=True)
        tok_dir = args.ref_model
    else:
        model, _ = load_aurora(args.src, device)
        tok_dir = args.src
    with torch.no_grad():
        EXPORTERS[args.format](model, args.dst)
    if args.format == "xtuner":
        for fn in _TOKENIZER_FILES:
            if os.path.exists(os.path.join(tok_dir, fn)):
                shutil.copy(os.path.join(tok_dir, fn),
                            os.path.join(args.dst, fn))
    print(f"wrote {args.format} checkpoint to {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
