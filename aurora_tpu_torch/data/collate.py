"""Batch collation: padding, SP padding, packing (aurora_tpu/data/collate.py).

  * default_collate_fn — pad ids/labels, a bool attention mask, frames
    stacked and zero-padded to the batch's frame count;
  * pad_for_sequence_parallel — pad the sequence axis to an sp multiple;
  * SoftPacker / packed_collate_fn — greedy text packing to
    pack_max_length with segment ids;
  * SoftPackerMM / packed_collate_mm — multimodal packing budgeted on the
    fused length (each image marker expands to n_visual_tokens).

Token ids, labels, masks and segment ids are numpy arrays built exactly
as the reference builds them. Frames (`pixel_values`) may be numpy arrays
or torch tensors (the port's dataset preprocesses them on its device);
they are stacked, padded and concatenated with the library they come in,
so frames on the card stay there.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from aurora_tpu_torch.utils.constants import (DEFAULT_PAD_TOKEN_INDEX,
                                              IGNORE_INDEX, IMAGE_TOKEN_INDEX)


def _pad_frames(px, n: int):
    """[F, ...] → [n, ...], zero frames appended."""
    if px.shape[0] == n:
        return px
    if isinstance(px, torch.Tensor):
        return torch.cat([px, px.new_zeros((n - px.shape[0],)
                                           + tuple(px.shape[1:]))])
    return np.pad(px, ((0, n - px.shape[0]),) + ((0, 0),) * (px.ndim - 1))


def _stack(arrays):
    if isinstance(arrays[0], torch.Tensor):
        return torch.stack(arrays)
    return np.stack(arrays)


def pad_for_sequence_parallel(arr: np.ndarray, sp: int, pad_value,
                              axis: int = 1) -> np.ndarray:
    n = arr.shape[axis]
    pad = (-n) % sp
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=pad_value)


def default_collate_fn(samples: List[Dict[str, Any]],
                       pad_token_id: int = DEFAULT_PAD_TOKEN_INDEX,
                       sequence_parallel_size: int = 1,
                       max_length: Optional[int] = None) -> Dict[str, Any]:
    """samples: dicts with input_ids, labels, pixel_values [F, C, H, W].
    An all-text batch (every sample with 0 frames) gets no pixel_values
    key, so the trainer skips the ViT."""
    lens = [len(s["input_ids"]) for s in samples]
    T = max_length or max(lens)
    B = len(samples)
    input_ids = np.full((B, T), pad_token_id, np.int32)
    labels = np.full((B, T), IGNORE_INDEX, np.int32)
    mask = np.zeros((B, T), bool)
    for i, s in enumerate(samples):
        n = min(len(s["input_ids"]), T)
        input_ids[i, :n] = s["input_ids"][:n]
        labels[i, :n] = s["labels"][:n]
        mask[i, :n] = True
    batch = {"input_ids": input_ids, "labels": labels,
             "attention_mask": mask}
    if sequence_parallel_size > 1:
        batch = {
            "input_ids": pad_for_sequence_parallel(
                input_ids, sequence_parallel_size, pad_token_id),
            "labels": pad_for_sequence_parallel(
                labels, sequence_parallel_size, IGNORE_INDEX),
            "attention_mask": pad_for_sequence_parallel(
                mask, sequence_parallel_size, False),
        }
    if "pixel_values" in samples[0]:
        fmax = max(s["pixel_values"].shape[0] for s in samples)
        if fmax > 0:
            batch["pixel_values"] = _stack(
                [_pad_frames(s["pixel_values"], fmax) for s in samples])
    return batch


class SoftPacker:
    """Greedy text packing to pack_max_length; the packs carry segment ids
    so that attention stays per document."""

    def __init__(self, samples: List[Dict[str, Any]],
                 pack_max_length: int = 4096):
        self.pack_max_length = pack_max_length
        self.packs: List[List[Dict]] = []
        cur, cur_len = [], 0
        for s in samples:
            n = len(s["input_ids"])
            if n > pack_max_length:
                s = {"input_ids": s["input_ids"][:pack_max_length],
                     "labels": s["labels"][:pack_max_length]}
                n = pack_max_length
            if cur_len + n > pack_max_length and cur:
                self.packs.append(cur)
                cur, cur_len = [], 0
            cur.append(s)
            cur_len += n
        if cur:
            self.packs.append(cur)

    def __len__(self) -> int:
        return len(self.packs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        pack = self.packs[idx]
        T = self.pack_max_length
        input_ids = np.full((T,), DEFAULT_PAD_TOKEN_INDEX, np.int32)
        labels = np.full((T,), IGNORE_INDEX, np.int32)
        segment_ids = np.full((T,), -1, np.int32)  # -1 = padding segment
        pos = 0
        for seg, s in enumerate(pack):
            n = len(s["input_ids"])
            input_ids[pos:pos + n] = s["input_ids"]
            labels[pos:pos + n] = s["labels"]
            segment_ids[pos:pos + n] = seg
            pos += n
        return {"input_ids": input_ids, "labels": labels,
                "segment_ids": segment_ids,
                "num_tokens": np.asarray(pos, np.int32)}


def packed_collate_fn(packs: List[Dict[str, np.ndarray]]) -> Dict:
    return {k: np.stack([p[k] for p in packs]) for k in packs[0]}


class SoftPackerMM:
    """Multimodal packing, budgeted on the fused length: each image marker
    counts n_visual_tokens, so a pack fits pack_max_length after the ViT
    splice. Packs carry pre-fusion input_ids / labels / segment_ids and the
    concatenated frames; fuse_multimodal(segment_ids=...) carries the
    segments over the visual spans."""

    def __init__(self, samples: List[Dict[str, Any]],
                 pack_max_length: int = 4096,
                 n_visual_tokens: int = 1,
                 dataset=None):
        """dataset: when given, `samples` are token records (e.g.
        AuroraDataset.text_data) and the frames load through dataset[i]
        when a pack is assembled."""
        self.pack_max_length = pack_max_length
        self.n_visual_tokens = n_visual_tokens
        self.dataset = dataset
        self.packs: List[List[Any]] = []
        cur, cur_len = [], 0

        def fused_len(s):
            n_img = sum(1 for t in s["input_ids"]
                        if t == IMAGE_TOKEN_INDEX)
            return (len(s["input_ids"]) - n_img
                    + n_img * n_visual_tokens)

        for i, s in enumerate(samples):
            n = fused_len(s)
            if n > pack_max_length:
                raise ValueError(f"sample fused length {n} exceeds "
                                 f"pack_max_length {pack_max_length}")
            if cur_len + n > pack_max_length and cur:
                self.packs.append(cur)
                cur, cur_len = [], 0
            cur.append(i if dataset is not None else s)
            cur_len += n
        if cur:
            self.packs.append(cur)

    def __len__(self) -> int:
        return len(self.packs)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        pack = self.packs[idx]
        if self.dataset is not None:
            pack = [self.dataset[i] for i in pack]
        ids, labels, segs, frames = [], [], [], []
        for seg, s in enumerate(pack):
            ids.extend(int(t) for t in s["input_ids"])
            labels.extend(int(t) for t in s["labels"])
            segs.extend([seg] * len(s["input_ids"]))
            px = s.get("pixel_values")
            if px is not None:
                if not isinstance(px, torch.Tensor):
                    px = np.asarray(px)
                if px.ndim == 3:      # single image [C, H, W]
                    px = px[None]
                if px.ndim != 4:
                    raise ValueError(f"pixel_values of shape {px.shape}")
                if px.shape[0]:       # text-only samples carry 0 frames
                    frames.append(px)
        if not frames:
            px = None
        elif isinstance(frames[0], torch.Tensor):
            px = torch.cat(frames)
        else:
            px = np.concatenate(frames)
        return {"input_ids": np.asarray(ids, np.int32),
                "labels": np.asarray(labels, np.int32),
                "segment_ids": np.asarray(segs, np.int32),
                "pixel_values": px,
                "num_tokens": np.asarray(len(ids), np.int32)}


def packed_collate_mm(packs: List[Dict[str, Any]],
                      pad_token: int = DEFAULT_PAD_TOKEN_INDEX) -> Dict:
    """Batch multimodal packs: token streams right-pad to the batch max;
    frame stacks zero-pad to the max frame count (frames without a
    matching marker scatter nowhere: fuse_multimodal drops them).

    The fused width is max_tokens + max_frames·(n_vis − 1) maxed over
    different rows, so batching a text-heavy pack with a frame-heavy one
    inflates it past pack_max_length: the train CLI signs the sampler's
    lengths by modality to keep batches homogeneous."""
    B = len(packs)
    f_counts = [0 if p["pixel_values"] is None
                else p["pixel_values"].shape[0] for p in packs]
    f_max = max(f_counts)
    t_max = max(int(p["num_tokens"]) for p in packs)
    input_ids = np.full((B, t_max), pad_token, np.int32)
    labels = np.full((B, t_max), IGNORE_INDEX, np.int32)
    segment_ids = np.full((B, t_max), -1, np.int32)
    mask = np.zeros((B, t_max), bool)
    for b, p in enumerate(packs):
        n = int(p["num_tokens"])
        input_ids[b, :n] = p["input_ids"]
        labels[b, :n] = p["labels"]
        segment_ids[b, :n] = p["segment_ids"]
        mask[b, :n] = True
    out = {"input_ids": input_ids, "labels": labels,
           "segment_ids": segment_ids, "attention_mask": mask}
    if f_max > 0:
        live = next(p["pixel_values"] for p in packs
                    if p["pixel_values"] is not None)
        shape = (f_max,) + tuple(live.shape[1:])
        if isinstance(live, torch.Tensor):
            zero = live.new_zeros(shape, dtype=torch.float32)
        else:
            zero = np.zeros(shape, np.float32)
        px = _stack([zero if p["pixel_values"] is None
                     else _pad_frames(p["pixel_values"], f_max)
                     for p in packs])
        out["pixel_values"] = (px.float() if isinstance(px, torch.Tensor)
                               else px.astype(np.float32, copy=False))
    return out
