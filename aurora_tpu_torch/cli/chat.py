"""Interactive chat CLI (aurora_tpu/cli/chat.py): multi-turn vicuna-template
chat over an xtuner-format AuroraCap (or llava-hf) directory, with an
optional video or image as context.

    python -m aurora_tpu_torch chat --model_path <dir> [--visual_input v.npy]

Each turn renders the whole history and decodes through generate/engine.py
(the inference.py path). The frames are read on the host and resized and
normalized on the device (cli/infer.py `preprocess_frames`); the ViT and
the projector run once, at the first turn, and their output is spliced
into every later turn's history, whose <image> markers stay in it. Type
an empty line or `exit` to quit, `reset` to clear the history. The flags
are the reference's, plus --device (default cuda).
"""

from __future__ import annotations

import argparse

import torch

from aurora_tpu_torch.cli.infer import (load_model, preprocess_frames,
                                        read_frames)
from aurora_tpu_torch.data.text import encode_with_image_tokens, ids_to_array
from aurora_tpu_torch.generate.engine import decode_tokens, generate
from aurora_tpu_torch.generate.sampler import SamplingParams
from aurora_tpu_torch.models.aurora import (aurora_forward, encode_visual,
                                            fuse_multimodal)
from aurora_tpu_torch.utils.constants import DEFAULT_IMAGE_TOKEN
from aurora_tpu_torch.utils.templates import PROMPT_TEMPLATE

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_path", required=True)
    p.add_argument("--visual_input", default=None)
    p.add_argument("--num_frm", type=int, default=8)
    p.add_argument("--image_size", type=int, default=378)
    p.add_argument("--token_kept_ratio", type=float, default=0.8)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--system", default="")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    model, cfg, tokenizer = load_model(args.model_path, _DTYPES[args.dtype],
                                       args.device)
    emb = model.llm.embed_tokens
    tpl = PROMPT_TEMPLATE.vicuna

    px = None
    n_frames = 0
    if args.visual_input:
        frames = preprocess_frames(read_frames(args.visual_input,
                                               args.num_frm),
                                   args.image_size, args.device)
        n_frames = frames.shape[0]
        px = frames.to(emb.dtype)[None]

    history = tpl["SYSTEM"].format(system=args.system) if args.system \
        else ""
    eos = tuple({tokenizer.eos_token_id} - {None}) or (2,)
    first = True
    vis_groups = None  # the ViT's output, kept across turns
    print("chat ready — empty line or 'exit' quits, 'reset' clears")
    while True:
        try:
            user = input("USER: ").strip()
        except EOFError:
            break
        if not user or user == "exit":
            break
        if user == "reset":
            history = ""
            first = True
            continue
        if first and n_frames:
            image_tokens = " ".join([DEFAULT_IMAGE_TOKEN] * n_frames)
            user = image_tokens + "\n" + user
        history += tpl["INSTRUCTION"].format(input=user, round=1)
        ids = torch.as_tensor(
            ids_to_array(encode_with_image_tokens(history, tokenizer)),
            dtype=torch.int64, device=emb.device)
        with torch.inference_mode():
            # the history keeps its <image> markers, so every turn splices
            # the visual embeddings again, from the first turn's encode
            if px is not None and vis_groups is None:
                vis_groups = encode_visual(model, px, args.token_kept_ratio)
            if vis_groups is not None:
                fused = fuse_multimodal(emb, ids, [vis_groups])
            else:
                fused = aurora_forward(model, ids, None,
                                       kept_ratio=args.token_kept_ratio,
                                       mode="inference")
            result = generate(
                model.llm, cfg.llm, fused["inputs_embeds"],
                fused["attention_mask"], max_new_tokens=args.max_new_tokens,
                sampling=SamplingParams(temperature=args.temperature,
                                        top_p=args.top_p),
                eos_ids=eos,
                generator=torch.Generator(device=emb.device).manual_seed(0))
        text = decode_tokens(tokenizer, result, eos_ids=eos)[0]
        print(f"ASSISTANT: {text}")
        history += text + tpl.get("SEP", "\n")
        first = False


if __name__ == "__main__":
    main()
