"""Training dataset: llava-format records → tokenized samples with frames
(aurora_tpu/data/dataset.py).

  * aurora_map_fn / aurora_image_only_map_fn — llava `conversations` →
    {conversation: [{input, output}]}, n '<image>' collapsed into a
    space-joined prefix line (the image-only variant keeps the markers);
  * template_map_fn + encode_conversation — per turn BOS + prompt
    (IGNORE_INDEX labels) + output and EOS (supervised), image markers as
    IMAGE_TOKEN_INDEX;
  * AuroraDataset — json / jsonl (through utils/fileio.py) or a
    pre-tokenized `datasets` directory (the package imported only then),
    an optional tokenization cache, modality-signed lengths.

Token records equal the reference's. Frames differ in where they are
made: the reference decodes with PIL and resizes on the host; here PNG is
read by data/image.py (other formats by PIL where it is importable) and
the geometry runs on the dataset's `device` (data/preprocess.py:
`clip_resize_crop_device` + `clip_normalize_device`, `expand2square`,
`keep_aspect_preprocess`), within 2 levels per channel of PIL's. A file
that is missing or does not decode gives a zero frame, as in the
reference; a format no decoder on this host reads raises
(`UnsupportedImageFormat`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

import torch

from aurora_tpu_torch.data.image import ImageDecodeError, decode_image
from aurora_tpu_torch.data.preprocess import (clip_normalize_device,
                                              clip_resize_crop_device,
                                              expand2square,
                                              keep_aspect_preprocess)
from aurora_tpu_torch.data.text import encode_with_image_tokens
from aurora_tpu_torch.utils.constants import (DEFAULT_IMAGE_TOKEN,
                                              IGNORE_INDEX)


# ---------------------------------------------------------------------------
# map fns: raw llava `conversations` → {conversation: [{input, output}]}
# ---------------------------------------------------------------------------

def _trim(messages: List[Dict]) -> List[Dict]:
    """Drop leading gpt and trailing human turns."""
    while messages and messages[0]["from"] == "gpt":
        messages = messages[1:]
    while messages and messages[-1]["from"] == "human":
        messages = messages[:-1]
    return messages


def aurora_map_fn(example: Dict) -> Dict:
    conversation, cur = [], ""
    for msg in _trim(list(example["conversations"])):
        if msg["from"] == "human":
            value = msg["value"]
            if DEFAULT_IMAGE_TOKEN in value:
                n = value.count(DEFAULT_IMAGE_TOKEN)
                prefix = " ".join([DEFAULT_IMAGE_TOKEN] * n)
                value = (prefix + "\n"
                         + value.replace(DEFAULT_IMAGE_TOKEN, "").strip())
            cur += value.strip()
        elif msg["from"] == "gpt":
            conversation.append({"input": cur, "output": msg["value"]})
            cur = ""
        else:
            raise ValueError(f"unknown speaker {msg['from']!r}")
    return {"conversation": conversation}


def aurora_image_only_map_fn(example: Dict) -> Dict:
    """Projector-stage variant: the prompt reduced to the image markers."""
    conversation, cur = [], ""
    for msg in _trim(list(example["conversations"])):
        if msg["from"] == "human":
            if DEFAULT_IMAGE_TOKEN not in msg["value"]:
                raise ValueError("a human turn without an image marker")
            cur += DEFAULT_IMAGE_TOKEN
        elif msg["from"] == "gpt":
            conversation.append({"input": cur, "output": msg["value"]})
            cur = ""
    return {"conversation": conversation}


def template_map_fn(example: Dict, template: Dict,
                    system: str = "") -> Dict:
    """Wrap the turns in the prompt template (utils/templates.py)."""
    out = []
    for i, turn in enumerate(example["conversation"]):
        text = template["INSTRUCTION"].format(input=turn["input"],
                                              round=i + 1)
        if i == 0 and (system or "{system}" not in
                       template.get("SYSTEM", "{system}")):
            text = template["SYSTEM"].format(system=system) + text
        out.append({"input": text, "output": turn["output"]})
    return {"conversation": out}


# ---------------------------------------------------------------------------
# tokenization
# ---------------------------------------------------------------------------

def encode_conversation(example: Dict, tokenizer, max_length: int,
                        with_image_token: bool = True,
                        input_ids_with_output: bool = True) -> Dict:
    """Per turn: BOS + prompt (IGNORE_INDEX labels), then output + EOS
    (supervised); cut to max_length."""
    bos = [tokenizer.bos_token_id] if tokenizer.bos_token_id is not None \
        else []
    eos = [tokenizer.eos_token_id] if tokenizer.eos_token_id is not None \
        else []
    input_ids: List[int] = []
    labels: List[int] = []
    for turn in example["conversation"]:
        if with_image_token and DEFAULT_IMAGE_TOKEN in turn["input"]:
            # no special tokens on the first chunk: BOS is added here
            enc = encode_with_image_tokens(turn["input"], tokenizer,
                                           first_chunk_special=False)
        else:
            enc = tokenizer.encode(turn["input"],
                                   add_special_tokens=False)
        input_ids += bos + enc
        labels += [IGNORE_INDEX] * (len(bos) + len(enc))
        if input_ids_with_output:
            out = tokenizer.encode(turn["output"],
                                   add_special_tokens=False)
            input_ids += out + eos
            labels += list(out) + list(eos)
    return {"input_ids": input_ids[:max_length],
            "labels": labels[:max_length]}


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

class AuroraDataset:
    """json/jsonl (or pre-tokenized `datasets` dir) multimodal dataset;
    frames are made on `device` (the card unless the caller says
    otherwise)."""

    def __init__(self, data_path: str, tokenizer=None,
                 image_folder: str = "",
                 map_fn: Callable = aurora_map_fn,
                 template: Optional[Dict] = None,
                 max_length: int = 4096,
                 image_size: int = 378,
                 pad_image_to_square: bool = False,
                 keep_aspect_ratio: bool = False,
                 cache_dir: Optional[str] = None,
                 device="cuda"):
        self.image_folder = image_folder
        self.image_size = image_size
        self.pad_image_to_square = pad_image_to_square
        self.keep_aspect_ratio = keep_aspect_ratio
        self.device = torch.device(device)

        if os.path.isdir(data_path):  # offline pre-tokenized
            import datasets
            self.text_data = list(datasets.load_from_disk(data_path))
            return
        # cached tokenization: the key is the source file's identity and
        # every knob that changes the encoding (the reference's key, so
        # the cache files are interchangeable)
        cache_file = None
        if cache_dir:
            import hashlib
            st = os.stat(data_path)
            tpl_id = "" if template is None else template.get(
                "INSTRUCTION", "")
            key = hashlib.sha1(":".join([
                os.path.abspath(data_path), str(st.st_mtime_ns),
                str(st.st_size), str(max_length), map_fn.__name__,
                tpl_id, getattr(tokenizer, "name_or_path", "")]
            ).encode()).hexdigest()[:16]
            cache_file = os.path.join(cache_dir, f"tok_{key}.json")
            if os.path.exists(cache_file):
                with open(cache_file) as f:
                    self.text_data = json.load(f)
                return
        records = read_json_or_jsonl(data_path)
        if tokenizer is None:
            raise ValueError("tokenizing a json/jsonl dataset needs a "
                             "tokenizer")
        self.text_data = []
        for rec in records:
            ex = map_fn(rec)
            if template is not None:
                ex = template_map_fn(ex, template)
            enc = encode_conversation(ex, tokenizer, max_length)
            enc["image"] = rec.get("image")
            self.text_data.append(enc)
        if cache_file:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = cache_file + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.text_data, f)
            os.replace(tmp, cache_file)

    def modality_length(self) -> List[int]:
        """+len for multimodal, −len for text-only samples (feeds
        LengthGroupedSampler)."""
        out = []
        for d in self.text_data:
            n = len(d["input_ids"])
            out.append(n if d.get("image") is not None else -n)
        return out

    def __len__(self) -> int:
        return len(self.text_data)

    def _zero_frame(self) -> torch.Tensor:
        return torch.zeros((3, self.image_size, self.image_size),
                           dtype=torch.float32, device=self.device)

    def load_frame(self, path: str) -> torch.Tensor:
        """One image file → [3, H, W] float32 normalized on the device; a
        zero frame if the file is missing or does not decode."""
        try:
            with open(path, "rb") as f:
                data = f.read()
            rgb = decode_image(data)
        except (OSError, ImageDecodeError):
            return self._zero_frame()
        frame = torch.as_tensor(rgb, device=self.device)
        if self.keep_aspect_ratio:
            return keep_aspect_preprocess(frame, self.image_size,
                                          self.pad_image_to_square)
        if self.pad_image_to_square:
            frame = expand2square(frame)
        return clip_normalize_device(clip_resize_crop_device(
            frame[None], self.image_size, self.image_size))[0]

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        d = dict(self.text_data[idx])
        images = d.get("image")
        if images is not None:
            if not isinstance(images, list):
                images = [images]
            frames = [self.load_frame(
                f if os.path.exists(f) else os.path.join(self.image_folder,
                                                         f))
                for f in images]
            d["pixel_values"] = torch.stack(frames)
        else:
            # text-only: zero frames, so that an all-text batch has no
            # pixel_values and the trainer skips the ViT
            d["pixel_values"] = torch.zeros(
                (0, 3, self.image_size, self.image_size),
                dtype=torch.float32, device=self.device)
        return d


def read_json_or_jsonl(path: str) -> List[dict]:
    """Annotation records, local or remote (utils/fileio.py)."""
    from aurora_tpu_torch.utils.fileio import read_text
    text = read_text(path)
    if path.endswith(".jsonl"):
        return [json.loads(ln) for ln in text.splitlines() if ln.strip()]
    return json.loads(text)
