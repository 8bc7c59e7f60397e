"""Offline pre-tokenization, the process_untokenized_llava_data workflow
(aurora_tpu/cli/preprocess.py): tokenize the text side once and save a
`datasets` directory that AuroraDataset (and the train CLI's --data)
loads directly.

    python -m aurora_tpu_torch preprocess --data in.json --out tok_data/ \
        --tokenizer <model dir> [--shard_size 100000] [--image_only]

The output is the reference's, row for row. `datasets` and transformers
(the tokenizer) are imported when the mode runs; where either is missing,
the mode exits 1 naming the package.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="aurora preprocess",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--max_length", type=int, default=4096)
    p.add_argument("--shard_size", type=int, default=0,
                   help=">0 → shard every N records (large-data flow)")
    p.add_argument("--image_only", action="store_true",
                   help="projector-stage map fn (markers only)")
    args = p.parse_args(argv)

    try:
        import datasets
    except ImportError:
        print("preprocess writes a `datasets` directory and needs the "
              "datasets package, which is not installed", file=sys.stderr)
        return 1
    from aurora_tpu_torch.data.dataset import (aurora_image_only_map_fn,
                                               aurora_map_fn,
                                               encode_conversation,
                                               read_json_or_jsonl,
                                               template_map_fn)
    from aurora_tpu_torch.data.text import auto_tokenizer
    from aurora_tpu_torch.utils.templates import PROMPT_TEMPLATE

    try:
        tokenizer = auto_tokenizer(args.tokenizer)
    except ImportError as e:
        print(f"preprocess: {e}", file=sys.stderr)
        return 1
    map_fn = aurora_image_only_map_fn if args.image_only else aurora_map_fn
    rows = []
    for rec in read_json_or_jsonl(args.data):
        ex = template_map_fn(map_fn(rec), PROMPT_TEMPLATE.vicuna)
        enc = encode_conversation(ex, tokenizer, args.max_length)
        enc["image"] = rec.get("image")
        rows.append(enc)

    if args.shard_size and len(rows) > args.shard_size:
        for i in range(0, len(rows), args.shard_size):
            shard = datasets.Dataset.from_list(rows[i:i + args.shard_size])
            shard.save_to_disk(f"{args.out}_shard{i // args.shard_size}")
        print(f"wrote {-(-len(rows) // args.shard_size)} shards")
    else:
        datasets.Dataset.from_list(rows).save_to_disk(args.out)
        print(f"wrote {len(rows)} pre-tokenized rows to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
