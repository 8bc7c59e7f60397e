"""Multimodal serving: AuroraCap and InternVL
(aurora_tpu/serve/multimodal.py).

A video request enters the engine as a text request whose prompt carries
num_frames × n_visual_tokens placeholder ids, derived from a hash of the
frame bytes. At extend time `embed_fn` runs the ViT with ToMe and the
projector and splices the visual embeddings over the placeholder span;
decode is text-only. `InternVLServing` does the same for InternVL's image
tiles (InternViT, pixel shuffle, projector), whose decoder, any dense
family of the zoo, the engine serves as it is.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, List

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


class FeatureCache:
    """A locked FIFO of encoded visual features: a repeated clip or image
    skips the tower. `get(key, encode)` returns the cached value or runs
    encode() outside the lock and keeps its result (`size` entries, the
    oldest evicted first)."""

    def __init__(self, size: int):
        self.size = size
        self._items: dict = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._items)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()

    def get(self, key, encode: Callable[[], Any]):
        with self._lock:
            value = self._items.get(key)
        if value is None:
            value = encode()
            with self._lock:
                if len(self._items) >= self.size:
                    self._items.pop(next(iter(self._items)))
                self._items[key] = value
        return value


def fused_prompt(embed_tokens, req: Request, groups) -> torch.Tensor:
    """The fused embedding sequence [T_total, D] of the request's raw
    prompt, `groups` spliced over its markers; its length must be the
    expanded prompt's."""
    ids = torch.as_tensor(np.asarray(req._raw_ids)[None],
                          device=embed_tokens.device)
    out = fuse_multimodal(embed_tokens, ids, groups)["inputs_embeds"][0]
    if out.shape[0] != len(req.input_ids):
        raise ValueError(f"fused length {out.shape[0]} != prompt "
                         f"length {len(req.input_ids)}")
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
        self._cache = FeatureCache(embed_cache_size)

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

        def encode():
            emb = self.model.llm.embed_tokens
            px = torch.as_tensor(req.pixel_values, device=emb.device)
            if _is_split_uint8(req.pixel_values):
                px = clip_normalize_device(px)
            px = px.to(emb.dtype)[None]
            if self.cfg.slowfast and px.shape[1] > 1:
                return list(encode_visual_slowfast(self.model, px,
                                                   req.kept_ratio))
            return [encode_visual(self.model, px, req.kept_ratio)]
        return self._cache.get(key, encode)

    def prewarm(self, req: Request) -> None:
        """Decode-ahead: encode the request's clip (ViT with ToMe, the
        projector) into the cache now, from the HTTP server's worker
        thread, so that the extend's embed_fn finds it there instead of
        running the ViT on the step's path. The ViT calls none of the
        serving kernels, so it shares no per-device scratch with a step
        that runs meanwhile; on the card both queue on the device's
        default stream."""
        self._visual_groups(req)

    @torch.no_grad()
    def embed_fn(self, req: Request) -> torch.Tensor:
        """Engine hook: the fused embedding sequence [T_total, D] of the
        request's prompt, on the model's device."""
        return fused_prompt(self.model.llm.embed_tokens, req,
                            self._visual_groups(req))


class InternVLServing:
    """Engine requests and the embed_fn hook for InternVL
    (models/internvl.py). Each '<image>' marker (one an image tile)
    expands to cfg.n_visual_tokens pseudo-ids hashed from the tiles, so
    that a repeated image hits the radix cache; at extend time
    `internvl_image_features` runs on the request's tiles and
    fuse_multimodal splices them. The engine serves `llm_params` (the
    model's LlamaModel) with `llm_cfg` unchanged."""

    def __init__(self, model, tokenizer, embed_cache_size: int = 8):
        self.model = model              # models.internvl.InternVLModel
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        # tile hash → projected features: a repeated image skips InternViT
        self._cache = FeatureCache(embed_cache_size)

    @property
    def llm_params(self):
        return self.model.text

    @property
    def llm_cfg(self):
        return self.cfg.text

    def n_visual_tokens(self) -> int:
        return self.cfg.n_visual_tokens

    def build_request(self, rid: str, prompt_text: str,
                      pixel_values: np.ndarray, **req_kwargs) -> Request:
        """prompt_text holds one '<image>' marker per tile; pixel_values
        [N_img, C, H, W], preprocessed to the tower's resolution."""
        raw_ids = encode_with_image_tokens(prompt_text, self.tokenizer)
        F = pixel_values.shape[0]
        if raw_ids.count(IMAGE_TOKEN_INDEX) != F:
            raise ValueError("one <image> marker per image required")
        n = self.cfg.n_visual_tokens
        clip_ids = frame_hash_ids(pixel_values, F * n)
        req = Request(rid=rid,
                      input_ids=expand_placeholders(raw_ids, [n] * F,
                                                    clip_ids),
                      **req_kwargs)
        req.pixel_values = pixel_values
        req._raw_ids = raw_ids  # type: ignore[attr-defined]
        return req

    @torch.no_grad()
    def _features(self, px: np.ndarray) -> torch.Tensor:
        """[N_img, C, H, W] → [N_img, N_vis, D], cached by the tiles'
        hash (embed_cache_size entries, the oldest evicted first)."""
        from aurora_tpu_torch.models.internvl import internvl_image_features
        key = hashlib.sha1(np.ascontiguousarray(px).tobytes()).digest()
        emb = self.model.text.embed_tokens
        return self._cache.get(key, lambda: internvl_image_features(
            self.model, torch.as_tensor(px, device=emb.device).to(
                emb.dtype)))

    def prewarm(self, req: Request) -> None:
        """Decode-ahead: encode the request's tiles into the cache now,
        off the extend's path (AuroraCapServing.prewarm)."""
        self._features(req.pixel_values)

    @torch.no_grad()
    def embed_fn(self, req: Request) -> torch.Tensor:
        """Engine hook: the fused embedding sequence [T_total, D] of the
        request's prompt, on the model's device."""
        return fused_prompt(self.model.text.embed_tokens, req,
                            [self._features(req.pixel_values)[None]])
