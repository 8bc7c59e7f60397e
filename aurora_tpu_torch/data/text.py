"""Prompt text → input_ids with image markers (aurora_tpu/data/text.py)."""

from __future__ import annotations

from typing import List

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
