"""Single-shot captioning CLI, the reference's inference.py
(aurora_tpu/cli/infer.py).

    python -m aurora_tpu_torch infer --model_path <xtuner-format dir> \
        --visual_input video.npy --prompt "Describe the video in detail." \
        --num_frm 8 --token_kept_ratio 0.8 --max_new_tokens 2048

The flags, the prompt and the greedy defaults are the reference's
(inference.py:29-98), plus --device (default cuda; the tests pass cpu).
Frames are decoded on the host (`read_video`; an image through PIL), then
resized, cropped and normalized on the device (`clip_resize_crop_device`,
`clip_normalize_device`); the ViT with ToMe, the projector and the fusion
run once (`aurora_forward`), and the caption comes from
generate/engine.py (greedy or sampled) or generate/beam.py.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from aurora_tpu_torch.data.preprocess import (clip_normalize_device,
                                              clip_resize_crop_device)
from aurora_tpu_torch.data.text import (auto_tokenizer, build_video_prompt,
                                        encode_with_image_tokens,
                                        ids_to_array)
from aurora_tpu_torch.data.video import read_video
from aurora_tpu_torch.generate.beam import beam_generate
from aurora_tpu_torch.generate.engine import decode_tokens, generate
from aurora_tpu_torch.generate.sampler import SamplingParams
from aurora_tpu_torch.models.aurora import (AuroraConfig, AuroraModel,
                                            aurora_forward)
from aurora_tpu_torch.models.convert import (load_auroracap_dir,
                                             load_llava_hf_dir)
from aurora_tpu_torch.utils.constants import DEFAULT_IMAGE_TOKEN
from aurora_tpu_torch.utils.templates import PROMPT_TEMPLATE

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_model(model_path: str, dtype=torch.bfloat16, device="cuda"):
    """xtuner-format or llava-hf directory → (AuroraModel, AuroraConfig,
    tokenizer). A llava-hf directory (model_type "llava") is detected;
    at --token_kept_ratio 1.0 its pipeline is LLaVA-1.5's."""
    with open(os.path.join(model_path, "config.json")) as f:
        model_type = json.load(f).get("model_type")
    load = (load_llava_hf_dir if model_type in ("llava", "llava_next")
            else load_auroracap_dir)
    llm, llm_cfg, vit, vit_cfg, pj, pj_cfg = load(
        model_path, llm_dtype=dtype, vit_dtype=dtype, device=device)
    cfg = AuroraConfig(vit=vit_cfg, llm=llm_cfg, projector=pj_cfg)
    model = AuroraModel(cfg, device="meta", dtype=dtype)
    model.visual_encoder, model.projector, model.llm = vit, pj, llm
    tokenizer = auto_tokenizer(model_path, padding_side="right")
    return model, cfg, tokenizer


@torch.no_grad()
def caption(model: AuroraModel, cfg: AuroraConfig, tokenizer, *,
            pixel_values, prompt: str, token_kept_ratio: float = 0.8,
            temperature: float = 0.0, top_p: float = 1.0,
            num_beams: int = 1, max_new_tokens: int = 2048,
            image_size: int = 378) -> str:
    """pixel_values: [F, C, H, W] normalized frames (a tensor or an
    array); one frame is an image. tokenizer: anything with encode,
    decode and eos_token_id."""
    f = pixel_values.shape[0]
    if f == 1:
        prompt_text = PROMPT_TEMPLATE.vicuna["INSTRUCTION"].format(
            input=DEFAULT_IMAGE_TOKEN + "\n" + prompt, round=1)
    else:
        prompt_text = build_video_prompt(prompt, f, PROMPT_TEMPLATE.vicuna)
    emb = model.llm.embed_tokens
    ids = torch.as_tensor(
        ids_to_array(encode_with_image_tokens(prompt_text, tokenizer)),
        dtype=torch.int64, device=emb.device)
    px = torch.as_tensor(pixel_values, device=emb.device).to(emb.dtype)
    fused = aurora_forward(model, ids, px[None], kept_ratio=token_kept_ratio,
                           mode="inference")
    eos = tuple({tokenizer.eos_token_id} - {None}) or (2,)
    if num_beams > 1:
        toks, n = beam_generate(model.llm, cfg.llm, fused["inputs_embeds"],
                                fused["attention_mask"], num_beams=num_beams,
                                max_new_tokens=max_new_tokens, eos_ids=eos)
        return tokenizer.decode(toks[:n].tolist(), skip_special_tokens=True)
    generator = torch.Generator(device=emb.device).manual_seed(
        int(time.time()))
    result = generate(model.llm, cfg.llm, fused["inputs_embeds"],
                      fused["attention_mask"], max_new_tokens=max_new_tokens,
                      sampling=SamplingParams(temperature=temperature,
                                              top_p=top_p),
                      eos_ids=eos, generator=generator)
    return decode_tokens(tokenizer, result, eos_ids=eos)[0]


def read_frames(path: str, num_frm: int) -> np.ndarray:
    """A video (read_video's backends) or an image (.png/.jpg, through
    PIL) → [F, H, W, 3] uint8 frames."""
    if path.lower().endswith((".png", ".jpg", ".jpeg")):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("decoding an image needs PIL (pillow)") from e
        return np.array(Image.open(path).convert("RGB"))[None]
    return read_video(path, num_frm)


def preprocess_frames(frames, image_size: int, device) -> torch.Tensor:
    """[F, H, W, 3] uint8 → [F, 3, size, size] normalized on `device`."""
    x = torch.as_tensor(frames, device=device)
    return clip_normalize_device(clip_resize_crop_device(x, image_size,
                                                         image_size))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model_path", type=str, required=True,
                        help="xtuner-format (or llava-hf) model dir")
    parser.add_argument("--prompt", type=str,
                        default="Describe the video in detail.")
    parser.add_argument("--visual_input", type=str, required=True,
                        help="video (npy/npz/frame-dir/mp4/webm/mkv) or "
                             "image (png/jpg)")
    parser.add_argument("--num_frm", type=int, default=8)
    parser.add_argument("--token_kept_ratio", type=float, default=0.8)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top_p", type=float, default=1.0)
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--max_new_tokens", type=int, default=2048)
    parser.add_argument("--image_size", type=int, default=378)
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=sorted(_DTYPES))
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    model, cfg, tokenizer = load_model(args.model_path, _DTYPES[args.dtype],
                                       args.device)
    frames = preprocess_frames(read_frames(args.visual_input, args.num_frm),
                               args.image_size, args.device)
    print(caption(model, cfg, tokenizer, pixel_values=frames,
                  prompt=args.prompt,
                  token_kept_ratio=args.token_kept_ratio,
                  temperature=args.temperature, top_p=args.top_p,
                  num_beams=args.num_beams,
                  max_new_tokens=args.max_new_tokens,
                  image_size=args.image_size))


if __name__ == "__main__":
    main()
