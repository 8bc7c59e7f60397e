"""AuroraModel: ViT → projector → LLM (aurora_tpu/models/aurora.py).

Ported: the configuration, the static visual token count, the visual
encode (frames folded into the batch, select layer −2, token 0 dropped,
projected; a CLIP or a SigLIP tower) and the multimodal fusion that
splices the visual embeddings over the prompt's image markers, carrying
packed batches' segment ids over the fused sequence, and the composite
forward `aurora_forward` (modes "loss", "loss_sum", "tensor"/"predict"
and "inference"), with sequence-parallel attention and this rank's block
of the fused sequence under a training mesh (parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from aurora_tpu_torch.models.init import build
from aurora_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                           llama_apply, llama_lm_loss,
                                           token_losses)
from aurora_tpu_torch.models.projector import (Projector, ProjectorConfig,
                                               apply_projector)
from aurora_tpu_torch.models.vit import (ViTConfig, VisionTransformer,
                                         vit_encode, vit_tome_r)
from aurora_tpu_torch.ops.tome import tome_schedule
from aurora_tpu_torch.utils.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX


@dataclasses.dataclass(frozen=True)
class AuroraConfig:
    vit: ViTConfig
    llm: LlamaConfig
    projector: ProjectorConfig
    visual_select_layer: int = -2
    slowfast: bool = False

    @classmethod
    def auroracap_7b(cls) -> "AuroraConfig":
        vit = ViTConfig.dfn5b_vit_h_378()
        llm = LlamaConfig.vicuna_7b_v15_16k()
        return cls(vit=vit, llm=llm,
                   projector=ProjectorConfig(
                       visual_hidden_size=vit.hidden_size,
                       llm_hidden_size=llm.hidden_size, depth=2))

    @classmethod
    def tiny(cls) -> "AuroraConfig":
        vit = ViTConfig(hidden_size=32, intermediate_size=64,
                        num_hidden_layers=3, num_attention_heads=4,
                        image_size=56, patch_size=14)
        return cls(vit=vit, llm=LlamaConfig.tiny(),
                   projector=ProjectorConfig(visual_hidden_size=32,
                                             llm_hidden_size=64, depth=2))


class AuroraModel(nn.Module):
    """The composite parameter tree {visual_encoder, projector, llm}."""

    def __init__(self, cfg: AuroraConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.visual_encoder = VisionTransformer(cfg.vit, device, dtype)
        self.projector = Projector(cfg.projector, device, dtype)
        self.llm = LlamaModel(cfg.llm, device, dtype)


def init_aurora(cfg: AuroraConfig, *, device, dtype,
                generator: torch.Generator) -> AuroraModel:
    """Random weights from `generator`, built directly on `device`."""
    return build(AuroraModel, cfg, device=device, dtype=dtype,
                 generator=generator)


def num_visual_tokens(cfg: AuroraConfig, kept_ratio: float,
                      h: Optional[int] = None,
                      w: Optional[int] = None) -> int:
    """Visual tokens per frame at the selected hidden layer, from the
    static ToMe schedule: CLIP's patches plus its CLS, SigLIP's patches,
    less token 0, which vit_encode drops for both towers."""
    h = h or cfg.vit.image_size
    w = w or cfg.vit.image_size
    r = vit_tome_r(cfg.vit, kept_ratio, h, w)
    n0 = (h // cfg.vit.patch_size) * (w // cfg.vit.patch_size)
    n0 += 1 if cfg.vit.class_token else 0
    sched = tome_schedule(n0, r, cfg.vit.num_hidden_layers, 1)
    L = cfg.vit.num_hidden_layers
    idx = cfg.visual_select_layer % (L + 1)
    n = sched[idx].t_in if idx < L else sched[-1].t_out
    return n - 1


def encode_visual(model: AuroraModel, pixel_values: torch.Tensor,
                  kept_ratio: float, remat=False) -> torch.Tensor:
    """[B, F, C, H, W] → projected visual embeds [B, F, N, D_llm]."""
    B, F, C, H, W = pixel_values.shape
    feats = vit_encode(model.visual_encoder,
                       pixel_values.reshape(B * F, C, H, W),
                       kept_ratio=kept_ratio,
                       select_layer=model.cfg.visual_select_layer,
                       remat=remat)
    feats = apply_projector(model.projector, feats)
    return feats.reshape(B, F, feats.shape[1], feats.shape[2])


def encode_visual_slowfast(model: AuroraModel, pixel_values: torch.Tensor,
                           kept_ratio: float, remat=False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame 0 un-merged, frames 1..F-1 at kept_ratio → (hi, lo)."""
    hi = encode_visual(model, pixel_values[:, :1], 1.0, remat)
    lo = encode_visual(model, pixel_values[:, 1:], kept_ratio, remat)
    return hi, lo


def fuse_multimodal(embed_table: torch.Tensor, input_ids: torch.Tensor,
                    visual_groups: Sequence[torch.Tensor],
                    attention_mask: Optional[torch.Tensor] = None,
                    labels: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> Dict[str, Optional[torch.Tensor]]:
    """Splice visual embeddings over the IMAGE_TOKEN_INDEX markers.

    input_ids [B, T] with markers; visual_groups: [B, F_g, N_g, D] tensors
    in marker order. Returns inputs_embeds [B, T_out, D], attention_mask
    [B, T_out] bool, position_ids [B, T_out], labels (IGNORE_INDEX
    under visual spans) and segment_ids with T_out = T - F_total +
    Σ F_g·N_g. Writes that would land at or past T_out are dropped, as the
    reference's scatters drop them; rows with fewer markers than F_total
    leave the missing frames unwritten.

    segment_ids [B, T] (packed batches, data/collate.py SoftPackerMM):
    each live token keeps its segment, each visual span takes its
    marker's, and every position past a row's live length is padding
    (-1), as the reference's aurora_tpu/models/aurora.py does.
    """
    B, T = input_ids.shape
    dev = input_ids.device
    sizes: List[int] = []
    for g in visual_groups:
        sizes.extend([g.shape[2]] * g.shape[1])
    F_total = len(sizes)
    D = visual_groups[0].shape[-1] if visual_groups else embed_table.shape[1]
    T_out = T - F_total + sum(sizes)
    if attention_mask is None:
        attention_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    else:
        attention_mask = attention_mask.to(torch.bool)

    is_img = input_ids == IMAGE_TOKEN_INDEX
    before = torch.cumsum(is_img.to(torch.int64), dim=1) - is_img.to(
        torch.int64)
    growth = itertools.accumulate(s - 1 for s in sizes)
    exp = torch.tensor([0] + list(growth), dtype=torch.int64, device=dev)
    shift = exp[before.clamp(0, F_total)]
    base_pos = torch.arange(T, device=dev)[None, :] + shift     # [B, T]

    out = torch.zeros((B, T_out, D), dtype=embed_table.dtype, device=dev)
    text = ~is_img & attention_mask & (base_pos < T_out)
    bi, ti = text.nonzero(as_tuple=True)
    out[bi, base_pos[bi, ti]] = embed_table[input_ids[bi, ti]]

    out_segments = None
    if segment_ids is not None:
        # live tokens, image markers included, keep their segment
        out_segments = torch.full((B, T_out), -1, dtype=segment_ids.dtype,
                                  device=dev)
        live = attention_mask & (base_pos < T_out)
        bs, ts = live.nonzero(as_tuple=True)
        out_segments[bs, base_pos[bs, ts]] = segment_ids[bs, ts]

    bm, tm = is_img.nonzero(as_tuple=True)
    marker_k = before[bm, tm]                    # ordinal of each marker
    marker_start = base_pos[bm, tm]
    marker_seg = (segment_ids[bm, tm] if segment_ids is not None
                  else torch.zeros_like(bm))
    k0 = 0
    for g in visual_groups:
        Fg, Ng = g.shape[1], g.shape[2]
        sel = (marker_k >= k0) & (marker_k < k0 + Fg)
        for b, k, start, seg in zip(
                bm[sel].tolist(), marker_k[sel].tolist(),
                marker_start[sel].tolist(), marker_seg[sel].tolist()):
            n = max(0, min(Ng, T_out - start))
            out[b, start:start + n] = g[b, k - k0, :n].to(out.dtype)
            if out_segments is not None:
                out_segments[b, start:start + n] = seg
        k0 += Fg

    n_markers = is_img.sum(dim=1)
    new_len = attention_mask.sum(dim=1) + exp[n_markers.clamp(0, F_total)]
    out_mask = torch.arange(T_out, device=dev)[None, :] < new_len[:, None]
    position_ids = torch.arange(T_out, device=dev)[None, :] * out_mask
    if out_segments is not None:
        out_segments = torch.where(out_mask, out_segments, -1)

    out_labels = None
    if labels is not None:
        out_labels = torch.full((B, T_out), IGNORE_INDEX,
                                dtype=labels.dtype, device=dev)
        out_labels[bi, base_pos[bi, ti]] = labels[bi, ti]
    return {"inputs_embeds": out, "attention_mask": out_mask,
            "position_ids": position_ids, "labels": out_labels,
            "segment_ids": out_segments}


def sequence_block(fused: Dict, index: int, size: int) -> Dict:
    """Rank `index` of `size`'s block of a fused batch (xtuner's
    split_for_sequence_parallel): the labels shifted first (each block's
    last position keeps its target, the first token of the next block),
    the sequence padded at its end to a multiple of `size` (zero
    embeddings, no target, segment −1, positions running on), then cut.
    → inputs_embeds, position_ids (global), targets, segment_ids."""
    x = fused["inputs_embeds"]
    B, T = x.shape[:2]
    dev = x.device
    pos = fused["position_ids"]
    if pos is None:
        pos = torch.arange(T, device=dev)[None].expand(B, T)
    labels = fused["labels"]
    targets = None
    if labels is not None:
        targets = torch.cat([labels[:, 1:], labels.new_full(
            (B, 1), IGNORE_INDEX)], dim=1)
    seg = fused["segment_ids"]
    pad = (-T) % size
    if pad:
        x = torch.cat([x, x.new_zeros((B, pad) + tuple(x.shape[2:]))], 1)
        pos = torch.cat([pos, torch.arange(T, T + pad, device=dev)[None]
                         .expand(B, pad).to(pos.dtype)], 1)
        if targets is not None:
            targets = torch.cat([targets, targets.new_full(
                (B, pad), IGNORE_INDEX)], 1)
        if seg is not None:
            seg = torch.cat([seg, seg.new_full((B, pad), -1)], 1)
    n = (T + pad) // size
    cut = slice(index * n, (index + 1) * n)
    return {"inputs_embeds": x[:, cut], "position_ids": pos[:, cut],
            "targets": None if targets is None else targets[:, cut],
            "segment_ids": None if seg is None else seg[:, cut]}


def aurora_forward(model: AuroraModel, input_ids: torch.Tensor,
                   pixel_values: Optional[torch.Tensor] = None,
                   attention_mask: Optional[torch.Tensor] = None,
                   labels: Optional[torch.Tensor] = None,
                   kept_ratio: float = 1.0, mode: str = "loss",
                   remat=False, segment_ids: Optional[torch.Tensor] = None,
                   sp_attn=None, seq_shard: Optional[Tuple[int, int]] = None,
                   tp=None):
    """mode "loss" → (mean loss, valid-token count); "loss_sum" → (sum of
    the token losses, valid-token count); "tensor"/"predict" → logits
    [B, T_out, V] fp32; "inference" → the fused-input dict.

    On a training mesh: sp_attn (models/llama.py `llama_apply`) attends
    over the sequence-parallel group; seq_shard (index, size) runs this
    rank's block of the fused sequence (`sequence_block`: the ViT, the
    projector and the fusion run whole first; modes "loss_sum" and
    "tensor" only, the logits are the block's); tp the tensor-parallel
    hooks of a model whose cfg.llm is its tp-local view.

    pixel_values [B, F, C, H, W] (or [B, C, H, W], one frame) splice the
    visual embeddings over the IMAGE_TOKEN_INDEX markers (frame 0 un-merged
    with cfg.slowfast); without them the batch is text. segment_ids [B, T]
    (packed batches): attention stays within each segment, carried over
    the visual spans by `fuse_multimodal`. remat applies to the ViT and
    the LLM layers alike. Attention takes the flash kernels for CUDA
    tensors without an attention mask (`mha`'s rule).
    """
    cfg = model.cfg
    if pixel_values is not None:
        if pixel_values.dim() == 4:     # one image → a one-frame video
            pixel_values = pixel_values[:, None]
        if cfg.slowfast and pixel_values.shape[1] != 1:
            groups = list(encode_visual_slowfast(model, pixel_values,
                                                 kept_ratio, remat))
        else:
            groups = [encode_visual(model, pixel_values, kept_ratio, remat)]
        fused = fuse_multimodal(model.llm.embed_tokens, input_ids, groups,
                                attention_mask, labels, segment_ids)
    else:
        fused = {"inputs_embeds": model.llm.embed_tokens[input_ids],
                 "attention_mask": attention_mask, "position_ids": None,
                 "labels": labels, "segment_ids": segment_ids}
    if mode == "inference":
        return fused
    if seq_shard is not None:
        if mode not in ("loss_sum", "tensor", "predict"):
            raise ValueError(f"mode {mode!r} under seq_shard: a block's "
                             "mean is not the loss; take 'loss_sum'")
        block = sequence_block(fused, *seq_shard)
        logits = llama_apply(model.llm, cfg.llm,
                             inputs_embeds=block["inputs_embeds"],
                             position_ids=block["position_ids"],
                             segment_ids=block["segment_ids"], remat=remat,
                             sp_attn=sp_attn, tp=tp)
        if mode != "loss_sum":
            return logits
        losses, n = token_losses(logits, block["targets"])
        return losses.sum(), n
    logits = llama_apply(model.llm, cfg.llm,
                         inputs_embeds=fused["inputs_embeds"],
                         attention_mask=fused["attention_mask"],
                         position_ids=fused["position_ids"],
                         segment_ids=fused["segment_ids"], remat=remat,
                         sp_attn=sp_attn, tp=tp)
    if mode in ("tensor", "predict"):
        return logits
    if mode == "loss":
        return llama_lm_loss(logits, fused["labels"])
    if mode == "loss_sum":
        losses, n = llama_lm_loss(logits, fused["labels"], reduce=False)
        return losses.sum(), n
    raise ValueError(f"unknown mode {mode!r}")
