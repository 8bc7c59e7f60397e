"""Weight-only int8/int4 frozen base for LoRA training, the QLoRA analog
(aurora_tpu/train/quant.py).

`quantize_base` turns every projection of the LLM's layers into a
`QuantLinear` holding the reference's codes and scales, in its [in, out]
orientation:
  * int8 — per-output-channel absmax: q8 [in, out], s [1, out];
  * int4 — groupwise absmax (group_size contiguous input rows share a
    scale), two nibbles packed per byte along the input axis (even row in
    the low nibble): q4 [in/2, out], s [in/gs, 1, out].
The codes and scales equal the reference's `quantize_base` bit for bit as
its train CLI runs it, outside jit: the divisions by 127 and 7 there are
IEEE divisions (under jit XLA would multiply by the fp32 reciprocal
instead), and so they are here. The embeddings, the LM head, the norms,
the ViT and the projector stay float.

A QuantLinear dequantizes its weight when the layer runs (under remat,
again in the backward), so one projection's float weight exists at a
time; `inject_lora` attaches scaled LoRA factors, so that the adapter's
delta W + (scale·A)@B is formed per layer too, in fp32, as the
reference's `dequant_leaf`. The dequantization and the delta are plain
torch: the reference computes them in XLA, outside any Pallas kernel.
`make_qlora_train_step` trains the adapters over such a base.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from aurora_tpu_torch.models.aurora import AuroraModel
from aurora_tpu_torch.train.lora import (Adapters, LoraConfig,
                                         make_lora_train_step)

Leaf = Dict[str, torch.Tensor]


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE division on every device: CUDA's division by a
    Python number multiplies by its reciprocal, a division by a 0-dim
    tensor on x's device does not."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def quantize_leaf_int8(w: torch.Tensor) -> Leaf:
    """Per-output-channel symmetric absmax over the input axis (-2):
    w [..., in, out] → q8 int8 of w's shape, s [..., 1, out] fp32."""
    w = w.float()
    s = w.abs().amax(dim=-2, keepdim=True)
    s = _div(torch.clamp_min(s, 1e-8), 127.0)
    q = torch.clamp(torch.round(w / s), -127, 127)
    return {"q8": q.to(torch.int8), "s": s}


def quantize_leaf_int4(w: torch.Tensor, group_size: int = 64) -> Leaf:
    """Groupwise symmetric int4: w [..., in, out] → q4 [..., in/2, out]
    int8 (two nibbles a byte), s [..., in/gs, 1, out] fp32."""
    *lead, n_in, n_out = w.shape
    if n_in % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {n_in}")
    gs = min(group_size, n_in)
    while n_in % gs:
        gs //= 2
    g = w.float().reshape(*lead, n_in // gs, gs, n_out)
    s = _div(torch.clamp_min(g.abs().amax(dim=-2, keepdim=True), 1e-8), 7.0)
    q = torch.clamp(torch.round(g / s), -8, 7).to(torch.int16)
    q = q.reshape(*lead, n_in, n_out)
    lo, hi = q[..., 0::2, :], q[..., 1::2, :]
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8)
    return {"q4": packed.view(torch.int8), "s": s}


def dequant_leaf(leaf: Leaf, dtype) -> torch.Tensor:
    """Inverse of quantize_leaf_int{8,4} → [..., in, out] in `dtype`; adds
    the LoRA delta a@b (fp32) when the leaf carries injected factors (the
    scale pre-baked into a)."""
    if "q8" in leaf:
        w = leaf["q8"].float() * leaf["s"]
    else:
        p = leaf["q4"].to(torch.int16)
        lo = ((p & 0xF) ^ 8) - 8            # sign-extended low nibble
        hi = p >> 4                         # arithmetic: the high nibble
        q = torch.stack([lo, hi], dim=-2)   # [..., in/2, 2, out]
        *lead, half, _, n_out = q.shape
        s = leaf["s"]
        groups = s.shape[-3]
        g = q.reshape(*lead, groups, (half * 2) // groups, n_out)
        w = (g.float() * s).reshape(*lead, half * 2, n_out)
    if leaf.get("a") is not None:
        w = w + leaf["a"].float() @ leaf["b"].float()
    return w.to(dtype)


class QuantLinear(nn.Module):
    """A frozen projection stored int8 or int4 (codes and scales as
    buffers, the reference's [in, out] orientation): y = h @ W with W
    dequantized in h's dtype at each call, plus the injected LoRA delta
    (`a`, `b`: plain attributes, None without an adapter)."""

    def __init__(self, leaf: Leaf, dtype: torch.dtype):
        super().__init__()
        self.kind = "q8" if "q8" in leaf else "q4"
        self.register_buffer("q", leaf[self.kind])
        self.register_buffer("s", leaf["s"])
        self.dtype = dtype                  # the float weight's dtype
        n_in = self.q.shape[-2] * (1 if self.kind == "q8" else 2)
        self.in_features, self.out_features = n_in, self.q.shape[-1]
        self.a: Optional[torch.Tensor] = None
        self.b: Optional[torch.Tensor] = None

    def leaf(self) -> Leaf:
        return {self.kind: self.q, "s": self.s, "a": self.a, "b": self.b}

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h @ dequant_leaf(self.leaf(), h.dtype)


def quantize_base(model: AuroraModel, bits: int = 8,
                  group_size: int = 64) -> AuroraModel:
    """Quantize the LLM's layer projections (nn.Linear weights [out, in],
    read as the reference's [in, out] kernels) in place: each becomes a
    QuantLinear and its float weight is freed. The rest stays float."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: 4 or 8")
    for layer in model.llm.layers:
        for name, m in list(layer.named_children()):
            if not isinstance(m, nn.Linear):
                continue
            w = m.weight.detach().t()
            leaf = (quantize_leaf_int8(w) if bits == 8
                    else quantize_leaf_int4(w, group_size))
            setattr(layer, name, QuantLinear(leaf, m.weight.dtype))
    return model


def tree_nbytes(model: nn.Module) -> int:
    """Bytes of the module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))


def inject_lora(qmodel: AuroraModel, adapters: Optional[Adapters],
                lora_cfg: LoraConfig) -> AuroraModel:
    """Attach (scale·a, b) to each adapted QuantLinear, as the reference
    attaches them to its quantized leaves (the product scale·a is part of
    the step's graph); adapters=None detaches them all."""
    mods = dict(qmodel.named_modules())
    if adapters is None:
        for m in mods.values():
            if isinstance(m, QuantLinear):
                m.a = m.b = None
        return qmodel
    for path, ab in adapters.items():
        m = mods[path]
        if not isinstance(m, QuantLinear):
            raise TypeError(f"LoRA target {path!r} is not a quantized "
                            "projection: use train/lora.apply_lora for "
                            "float bases")
        m.a, m.b = lora_cfg.scale * ab["a"], ab["b"]
    return qmodel


def make_qlora_train_step(acfg, tcfg, base_q: AuroraModel,
                          lora_cfg: LoraConfig, opt, mesh=None):
    """make_lora_train_step over an int8/int4 base: the quantized base is
    never fully dequantized and never enters the optimizer; gradients
    flow to the adapters only."""
    return make_lora_train_step(acfg, tcfg, base_q, lora_cfg, opt, mesh,
                                attach=inject_lora)
