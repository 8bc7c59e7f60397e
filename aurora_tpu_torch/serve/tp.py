"""Tensor-parallel serving (aurora_tpu/serve/tp.py): the engine's model
cut into `tp` shards, KV rows and the radix pool cut on heads, all shards
driven in lockstep from one host thread.

The reference compiles one `shard_map` step over a ('tp',) mesh with two
psums a layer. Here `TPRunner` has `DeviceRunner`'s interface and holds
`tp` shard models, each with its KV rows on its own device; the engine's
`_forward_rows` takes the group (`tp=`, the reference's `tp_axis`) and
runs each layer's attention and MLP on every shard, summing the o and
down partial products before their biases add.

Layout, by parameter name (the reference's `tp_param_specs`):
  * q/k/v/gate/up (`_COL`) are cut on their output rows, with their
    biases and per-output scales; o/down (`_ROW`) on their input columns,
    their per-output scales and biases replicated (the biases add once,
    after the sum);
  * Cohere's per-head q_norm / k_norm [H, hd] follow the heads;
  * MoE experts are cut on the MLP width (moe_gate / moe_up [E, D, F] on
    F, moe_down [E, F, D] on its F rows, its scales replicated), the
    shared expert likewise; the router and the scalar shared gate are
    replicated (their outputs are the same on every shard, and the
    sigmoid gate distributes over the sum);
  * embeddings, norms, final norm and LM head are replicated;
  * KV rows [L, B, Hkv/tp, S, hd] (and their int8 scale planes) and the
    radix pool [L, slots, Hkv/tp, hd] hold each shard's heads.
The LM head, the sampler, its histograms and its `torch.Generator` live
once, on the first shard's device, so that the sampler draws the same
stream at any tp.

The sum (`TPGroup.all_reduce`) is a gather-sum-broadcast with one code
path for every device layout: each partial (fp32) is copied to the first
shard's device and added in shard order, rounded once to the
activations' dtype, and the replicated activations that the next stage
reads are copied back to each shard's device (no copy where a shard lives
on the first device). A device may repeat, so that
the CPU and one card hold any number of shards; the reference's mesh
needs distinct devices.

Quantization and fusing: a dense model served at weight_quant="int8" is
quantized whole (per-output-channel scales over the full input rows, as
the reference's tree is quantized before it is sharded), then cut; each
shard's q/k/v and gate/up are then fused into one stream
(`fuse_serving_weights`, exact for per-output-channel scales). A model
fused before the cut is refused: its heads could not be told apart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from aurora_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                           extras_of, moe_layout)
from aurora_tpu_torch.serve.engine import (DeviceRunner, EngineConfig,
                                           KVWriteIndex, Shard, _load_prefix,
                                           _store_prompt, _weight_pairs,
                                           alloc_rows, device_scope,
                                           fuse_serving_weights,
                                           weight_quant_of)
from aurora_tpu_torch.serve.kv_pool import KVPool

# cut on their output rows / on their input columns ([out, in] weights)
_COL = {"q", "k", "v", "gate", "up"}
_ROW = {"o", "down"}
# expert stacks [E, in, out] cut on the MLP width F: its out axis for the
# gate and up stacks, its in axis for down
_EXPERT_COL = {"moe_gate", "moe_up", "moe_shared_gate", "moe_shared_up"}
_EXPERT_ROW = {"moe_down", "moe_shared_down"}


def local_cfg(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """Per-shard view: heads divided, head_dim pinned, hidden unchanged."""
    if cfg.num_key_value_heads % tp or cfg.num_attention_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_key_value_heads="
            f"{cfg.num_key_value_heads} and "
            f"num_attention_heads={cfg.num_attention_heads}")
    return dataclasses.replace(
        cfg, num_attention_heads=cfg.num_attention_heads // tp,
        num_key_value_heads=cfg.num_key_value_heads // tp,
        head_dim_override=cfg.head_dim)


def check_tp(model: LlamaModel, cfg: LlamaConfig, tp: int) -> None:
    """The reference's refusals of a tp > 1 engine, in its words: tp must
    divide the heads (and here the MLP widths it cuts), the weights must
    be per-name, and a dense prefix is single-device."""
    local_cfg(cfg, tp)
    if cfg.num_experts and cfg.first_k_dense:
        raise NotImplementedError(
            "dense-prefix (first_k_dense) serving is single-device")
    fused = sorted({"qkv", "gateup", "mlp"}
                   & {n for lp in model.layers for n, _ in
                      lp.named_children()})
    if fused:
        raise ValueError(
            f"tp={tp} requires the per-name weight layout; fuse AFTER "
            f"deciding tp (found fused {fused} — fuse_serving_weights is "
            "single-device only)")
    widths = {"intermediate_size": cfg.intermediate_size,
              **{k: v for k, v in moe_layout(model).items()
                 if k != "shared_gate"}}
    for name, width in widths.items():
        if width % tp:
            raise ValueError(f"tp={tp} must divide {name}={width}")


def visible_devices(device, n: int) -> List[torch.device]:
    """The devices of n shards or replicas when the caller names none, as
    the reference takes its first local devices: the first n visible
    cards for a model on the card (fewer where fewer are visible), the CPU
    n times for one on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    return [torch.device("cuda", i)
            for i in range(min(n, torch.cuda.device_count()))]


def split_dim(name: str, t: torch.Tensor) -> Optional[int]:
    """The axis on which state-dict tensor `name` of a LlamaModel is cut,
    or None where it is replicated (the module docstring's table)."""
    parts = name.split(".")
    if parts[0] != "layers" or len(parts) < 3:
        return None
    mod, leaf = parts[2], parts[-1]
    if len(parts) == 3:                 # a layer's own parameter
        if mod.endswith("_bias") and mod[:-len("_bias")] in _COL:
            return 0
        if mod in ("q_norm", "k_norm") and t.dim() == 2:
            return 0                    # Cohere's [H, hd]
        return None
    if mod in _COL:                     # [out, in] weight, [out] scale
        return 0
    if mod in _ROW:                     # [out, in]; the scale replicated
        return 1 if leaf == "weight" else None
    if mod in _EXPERT_COL:              # [E, D, F] weight, [E, F] scale
        return 2 if leaf == "weight" else 1
    if mod in _EXPERT_ROW:              # [E, F, D]; [E, D] replicated
        return 1 if leaf == "weight" else None
    return None


def shard_bytes(model: LlamaModel, tp: int) -> int:
    """Device bytes of one shard of `model` cut tp ways (`cut_model`):
    1/tp of each cut tensor, every replicated tensor whole."""
    return sum(t.numel() * t.element_size()
               // (1 if split_dim(name, t) is None else tp)
               for name, t in model.state_dict().items())


def _new_tensor(t: torch.Tensor, device) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def cut_model(model: LlamaModel, tp: int, devices) -> List[LlamaModel]:
    """`model` (per-name, unquantized or W8) → tp shard models of its
    config's local view, shard r on devices[r]. Every cut tensor is a new
    copy on its shard's device; a replicated tensor is copied once per
    distinct device and shared by the shards there. The source is left as
    it is. W8 shards get their streams fused (`fuse_serving_weights`)."""
    cfg = model.cfg
    cfg_l = local_cfg(cfg, tp)
    layout = moe_layout(model)
    for key in ("moe_inter", "shared_inter"):
        if key in layout:
            layout[key] //= tp
    build = dataclasses.replace(
        cfg_l, intermediate_size=cfg.intermediate_size // tp)
    wq = weight_quant_of(model)
    sd = model.state_dict()
    replicated: Dict[tuple, torch.Tensor] = {}
    shards = []
    with torch.no_grad():
        for r, dev in enumerate(devices):
            dev = torch.device(dev)
            part = {}
            for name, t in sd.items():
                dim = split_dim(name, t)
                if dim is None:
                    key = (name, str(dev))
                    if key not in replicated:
                        replicated[key] = _new_tensor(t, dev)
                    part[name] = replicated[key]
                else:
                    n = t.shape[dim] // tp
                    part[name] = _new_tensor(t.narrow(dim, r * n, n), dev)
            shard = LlamaModel(build, device="meta", weight_quant=wq,
                               extras=extras_of(model), **layout,
                               num_labels=(model.score.out_features
                                           if hasattr(model, "score")
                                           else 0))
            shard.load_state_dict(part, strict=True, assign=True)
            shard.cfg = cfg_l
            for p in shard.parameters():
                p.requires_grad_(False)
            if wq != "none":
                fuse_serving_weights(shard)
            shards.append(shard)
    return shards


class TPGroup:
    """The shards of one engine: their models, local config, KV rows and
    layer indexes; the forward's scatter of inputs and sum of partials."""

    def __init__(self, models: List[LlamaModel], rows, devices):
        self.models = models
        self.cfg = models[0].cfg
        self.rows = rows
        self.devices = [torch.device(d) for d in devices]
        L = self.cfg.num_hidden_layers
        self.layer_ids = [torch.arange(L, dtype=torch.int32, device=d)
                          for d in self.devices]

    def _put(self, x, device, cache):
        """x on `device`, copied once per distinct device (x itself on
        its own device; None stays None)."""
        if x is None or x.device == device:
            return x
        key = (id(x), str(device))
        if key not in cache:
            cache[key] = x.to(device)
        return cache[key]

    def shards(self, row_ids, q_offsets, kv_lens, kv_write, cos, sin):
        """The forward's Shard of each shard: the wave's index tensors,
        KV write plan and rotary tables on its device."""
        cache: Dict[tuple, torch.Tensor] = {}
        out = []
        for model, rows, ids, dev in zip(self.models, self.rows,
                                         self.layer_ids, self.devices):
            def put(x, dev=dev):
                return self._put(x, dev, cache)
            widx = None if kv_write is None else KVWriteIndex(
                **{f.name: put(getattr(kv_write, f.name))
                   for f in dataclasses.fields(kv_write)})
            out.append(Shard(model, self.cfg, rows, ids, put(row_ids),
                             put(q_offsets), put(kv_lens), widx, put(cos),
                             put(sin)))
        return out

    def scatter(self, shards, h):
        """(shard, h on its device) for each shard, each shard's device
        current while its work is issued."""
        cache: Dict[tuple, torch.Tensor] = {}
        for s, dev in zip(shards, self.devices):
            with device_scope(dev):
                yield s, self._put(h, dev, cache)

    def all_reduce(self, parts):
        """The partial products' sum on the first shard's device, added
        in shard order in fp32."""
        out = parts[0].float()
        for p in parts[1:]:
            out = out + p.to(out.device)
        return out


class TPRunner(DeviceRunner):
    """`DeviceRunner` over tp shards (module docstring): the LM head,
    embeddings, sampler histograms and generator on the first shard's
    device (`model` is the first shard), every shard's KV rows on its
    own. `rows` are the first shard's; `group.rows` all of them."""

    def __init__(self, model: LlamaModel, cfg: LlamaConfig,
                 ecfg: EngineConfig, devices, seed: int = 0):
        devices = [torch.device(d) for d in devices]
        if len(devices) < ecfg.tp:
            raise ValueError(f"tp={ecfg.tp} needs {ecfg.tp} devices, "
                             f"have {len(devices)} (devices= may repeat "
                             "one)")
        devices = devices[:ecfg.tp]
        models = cut_model(model, ecfg.tp, devices)
        rows = [alloc_rows(models[0].cfg, ecfg, d) for d in devices]
        self.group = TPGroup(models, rows, devices)
        super().__init__(models[0], cfg, ecfg, devices[0], seed, rows[0])
        self.tp = self.group

    def make_pool(self, num_slots: int):
        """One slot pool a shard, on its heads and device."""
        return [KVPool(self.group.cfg, num_slots, self.ecfg.kv_dtype,
                       quant=self.ecfg.kv_quant in ("int8", "int4"),
                       device=d) for d in self.group.devices]

    def load_prefix(self, pool, slots, row: int, start: int, n: int):
        for rows, p, dev in zip(self.group.rows, pool, self.group.devices):
            with device_scope(dev):
                _load_prefix(rows, p.planes, slots, row, start, n)

    def store_prompt(self, pool, row: int, start: int, slots):
        for rows, p, dev in zip(self.group.rows, pool, self.group.devices):
            with device_scope(dev):
                _store_prompt(p.planes, rows, row, start, slots)

    def weight_pairs(self, model: LlamaModel):
        """`model` (dense or W8, per-name) cut as the live shards are, and
        paired with them shard by shard."""
        check_tp(model, self.cfg, self.ecfg.tp)
        new = cut_model(model, self.ecfg.tp, self.group.devices)
        pairs, seen = [], set()
        for live, cut in zip(self.group.models, new):
            for t, v in _weight_pairs(live.state_dict(), cut.state_dict()):
                key = (t.device, t.data_ptr())
                if key not in seen:     # replicated tensors are shared
                    seen.add(key)
                    pairs.append((t, v))
        return pairs
