"""Prompt text → input_ids with image markers (aurora_tpu/data/text.py)."""

from __future__ import annotations

from typing import List

import numpy as np

from aurora_tpu_torch.utils.constants import (DEFAULT_IMAGE_TOKEN,
                                              IMAGE_TOKEN_INDEX)


def encode_with_image_tokens(text: str, tokenizer,
                             first_chunk_special: bool = True
                             ) -> List[int]:
    """Tokenize `text`, replacing each '<image>' with IMAGE_TOKEN_INDEX.
    The first chunk carries the tokenizer's special tokens (BOS)."""
    ids: List[int] = []
    for idx, chunk in enumerate(text.split(DEFAULT_IMAGE_TOKEN)):
        if idx == 0:
            ids.extend(tokenizer.encode(
                chunk, add_special_tokens=first_chunk_special))
        else:
            ids.append(IMAGE_TOKEN_INDEX)
            ids.extend(tokenizer.encode(chunk, add_special_tokens=False))
    return ids


def build_video_prompt(prompt: str, num_frames: int,
                       template: dict) -> str:
    """One '<image>' per frame, space-joined, a newline, the user prompt,
    wrapped in the template's INSTRUCTION (the reference's
    inference.py:76-85)."""
    image_tokens = " ".join([DEFAULT_IMAGE_TOKEN] * num_frames)
    return template["INSTRUCTION"].format(input=image_tokens + "\n" + prompt,
                                          round=1)


def ids_to_array(ids: List[int]) -> np.ndarray:
    """[1, T] int32 batch of one prompt."""
    return np.asarray(ids, dtype=np.int32)[None, :]


def auto_tokenizer(model_path: str, **kwargs):
    """A checkpoint's tokenizer through transformers' AutoTokenizer."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "loading a checkpoint's tokenizer needs the transformers "
            "package (AutoTokenizer); without it, build the model with "
            "models.convert and pass any tokenizer with encode/decode/"
            "eos_token_id") from e
    return AutoTokenizer.from_pretrained(model_path, **kwargs)
