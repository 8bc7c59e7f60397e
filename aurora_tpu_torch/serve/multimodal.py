"""AuroraCap multimodal serving (aurora_tpu/serve/multimodal.py).

A video request enters the engine as a text request whose prompt carries
num_frames × n_visual_tokens placeholder ids, derived from a hash of the
frame bytes. At extend time `embed_fn` runs the ViT with ToMe and the
projector and splices the visual embeddings over the placeholder span;
decode is text-only.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List

import numpy as np
import torch

from aurora_tpu_torch.data.preprocess import clip_normalize_device
from aurora_tpu_torch.data.text import encode_with_image_tokens
from aurora_tpu_torch.models.aurora import (AuroraModel, encode_visual,
                                            encode_visual_slowfast,
                                            fuse_multimodal,
                                            num_visual_tokens)
from aurora_tpu_torch.serve.scheduler import Request
from aurora_tpu_torch.utils.constants import IMAGE_TOKEN_INDEX

# placeholder ids live in a high pseudo-vocab band: they never reach the
# embedding table (the fused embeds replace them)
_PLACEHOLDER_BASE = 1 << 24


def _is_split_uint8(px: np.ndarray) -> bool:
    """[F, H, W, 3] uint8 (resized/cropped frames) vs [F, C, H, W] float."""
    return px.dtype == np.uint8 and px.ndim == 4 and px.shape[-1] == 3


def frame_hash_ids(pixel_values: np.ndarray, n_tokens: int) -> List[int]:
    """Deterministic pseudo-ids for a clip: sha1(frames) → n ids."""
    digest = hashlib.sha1(
        np.ascontiguousarray(pixel_values).tobytes()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    return [int(x) for x in
            rng.integers(_PLACEHOLDER_BASE, _PLACEHOLDER_BASE + (1 << 20),
                         size=n_tokens)]


def expand_placeholders(raw_ids: List[int], counts: List[int],
                        clip_ids: List[int]) -> List[int]:
    """Replace each IMAGE_TOKEN_INDEX marker with the next counts[k]
    pseudo-ids of clip_ids."""
    out: List[int] = []
    k = pos = 0
    for tok in raw_ids:
        if tok == IMAGE_TOKEN_INDEX:
            out.extend(clip_ids[pos:pos + counts[k]])
            pos += counts[k]
            k += 1
        else:
            out.append(tok)
    return out


class AuroraCapServing:
    """Builds engine requests and the engine's embed_fn for AuroraCap."""

    def __init__(self, model: AuroraModel, tokenizer,
                 kept_ratio: float = 0.8, image_size: int = 378,
                 embed_cache_size: int = 8):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.kept_ratio = kept_ratio
        self.image_size = image_size
        # clip hash → encoded visual groups: a repeated clip skips the ViT
        self._cache: Dict[tuple, list] = {}
        self._cache_size = embed_cache_size
        self._cache_lock = threading.Lock()

    def _frame_counts(self, F: int, h: int, w: int,
                      kept_ratio: float) -> List[int]:
        n = num_visual_tokens(self.cfg, kept_ratio, h, w)
        if self.cfg.slowfast and F > 1:
            return [num_visual_tokens(self.cfg, 1.0, h, w)] + [n] * (F - 1)
        return [n] * F

    def n_visual_tokens(self, h: int = None, w: int = None) -> int:
        return num_visual_tokens(self.cfg, self.kept_ratio,
                                 h or self.image_size, w or self.image_size)

    def build_request(self, rid: str, prompt_text: str,
                      pixel_values: np.ndarray, kept_ratio: float = None,
                      **req_kwargs) -> Request:
        """prompt_text holds one '<image>' marker per frame; pixel_values
        is [F, H, W, 3] uint8 (cropped frames, normalized on the device)
        or [F, C, H, W] float (already normalized)."""
        raw_ids = encode_with_image_tokens(prompt_text, self.tokenizer)
        kept = self.kept_ratio if kept_ratio is None else kept_ratio
        if _is_split_uint8(pixel_values):
            F, H, W, _ = pixel_values.shape
        else:
            F, _, H, W = pixel_values.shape
        if raw_ids.count(IMAGE_TOKEN_INDEX) != F:
            raise ValueError("one <image> marker per frame required")
        counts = self._frame_counts(F, H, W, kept)
        clip_ids = frame_hash_ids(pixel_values, sum(counts))
        req = Request(rid=rid,
                      input_ids=expand_placeholders(raw_ids, counts,
                                                    clip_ids),
                      **req_kwargs)
        req.pixel_values = pixel_values
        req.kept_ratio = kept
        req._raw_ids = raw_ids  # type: ignore[attr-defined]
        return req

    @torch.no_grad()
    def _visual_groups(self, req: Request):
        key = (hashlib.sha1(np.ascontiguousarray(
            req.pixel_values).tobytes()).digest(), req.kept_ratio)
        with self._cache_lock:
            groups = self._cache.get(key)
        if groups is None:
            emb = self.model.llm.embed_tokens
            px = torch.as_tensor(req.pixel_values, device=emb.device)
            if _is_split_uint8(req.pixel_values):
                px = clip_normalize_device(px)
            px = px.to(emb.dtype)[None]
            if self.cfg.slowfast and px.shape[1] > 1:
                groups = list(encode_visual_slowfast(self.model, px,
                                                     req.kept_ratio))
            else:
                groups = [encode_visual(self.model, px, req.kept_ratio)]
            with self._cache_lock:
                if len(self._cache) >= self._cache_size:
                    self._cache.pop(next(iter(self._cache)))
                self._cache[key] = groups
        return groups

    @torch.no_grad()
    def embed_fn(self, req: Request) -> torch.Tensor:
        """Engine hook: the fused embedding sequence [T_total, D] of the
        request's prompt, on the model's device."""
        emb = self.model.llm.embed_tokens
        ids = torch.as_tensor(np.asarray(req._raw_ids)[None],
                              device=emb.device)
        fused = fuse_multimodal(emb, ids, self._visual_groups(req))
        out = fused["inputs_embeds"][0]
        if out.shape[0] != len(req.input_ids):
            raise ValueError(f"fused length {out.shape[0]} != prompt "
                             f"length {len(req.input_ids)}")
        return out
