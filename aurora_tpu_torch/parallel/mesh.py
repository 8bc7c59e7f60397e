"""The training mesh and how the model is laid out on it
(aurora_tpu/parallel/mesh.py).

The reference builds one `jax.sharding.Mesh` over named axes
('dp', 'fsdp', 'sp', 'tp') and lets GSPMD place the collectives. The port
runs one process per rank and makes the same four axes a
`torch.distributed.device_mesh.DeviceMesh` (`create_mesh`); each rank
holds only its part:

  * dp, fsdp — rows of the global batch (`local_rows`); dp replicates the
    parameters, fsdp shards them (below);
  * sp — the fused sequence, cut after the ViT, the projector and the
    fusion (xtuner's `split_for_sequence_parallel`; models/aurora.py
    `aurora_forward(seq_shard=)`); attention runs through
    parallel/{ulysses,ring,hybrid}.py;
  * tp — heads and MLP width of the LLM's decoder layers.

`shard_model` lays a model out for one rank:
  * tp cuts each branch of a decoder layer that it divides (`tp_cut`;
    a branch it does not divide runs whole on every tp rank, the
    reference's fall-back to replication) as serve/tp.py cuts a serving
    shard (`split_dim`: q/k/v/gate/up on their output rows, o/down on their
    input columns; the o/down products are summed over tp before their
    biases and output norms, models/llama.py `attn_out_tail` /
    `mlp_tail`), and puts a MoE layer's experts on tp (the reference's
    `layers/moe_*` rule: expert stacks [E, in, out] cut on E; each rank
    computes its experts for every token and the partial outputs are
    summed; the router is whole on every rank and its gradient summed over
    tp; the shared expert is whole and runs outside the sum);
  * fsdp is ZeRO-3 written out (`FlatUnit`): the trainable parameters of
    each decoder layer, and the rest (embeddings, LM head, final norm and
    any trainable part of the ViT and projector) as one more unit, are
    flattened into one buffer, padded to a multiple of fsdp and cut; a
    rank keeps its 1/fsdp of each. A layer's unit is all-gathered when
    the layer runs and dropped when it ends (inside the layer's remat
    region, so the backward gathers it again), so one layer's whole
    parameters are live at a time; its gradient comes back summed and
    cut (the all-gather's transpose). The optimizer updates the local
    shards.
Deviations (the results are the same): the ViT and the projector stay
whole on every tp rank, and so do the embedding table and the LM head
(the reference cuts their vocabulary over tp); frozen modules are not
sharded over fsdp (they hold no gradient and no optimizer state); the
flat units pad to a multiple of fsdp, so fsdp needs no fall-back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from aurora_tpu_torch.parallel.collectives import (Axis, TensorParallel,
                                                   _axis_of, _gather,
                                                   all_gather, all_reduce_)
from aurora_tpu_torch.parallel.distributed import require_card

AXES = ("dp", "fsdp", "sp", "tp")
# the axes (and products of axes) a train step reduces over, made once
_MESH_AXES = (("dp",), ("fsdp",), ("sp",), ("tp",), ("dp", "fsdp"),
              ("dp", "sp"), ("dp", "fsdp", "sp"), ("fsdp", "tp"))


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.fsdp * self.sp * self.tp

    def size(self, axis: str) -> int:
        return getattr(self, axis)


def parse_mesh(spec: str) -> MeshConfig:
    """"dp=2,fsdp=2,sp=1,tp=2" → MeshConfig (axes left out are 1)."""
    kw = {}
    for kv in spec.split(","):
        if kv:
            k, v = kv.split("=")
            if k not in AXES:
                raise ValueError(f"unknown mesh axis {k!r}: {AXES}")
            kw[k] = int(v)
    return MeshConfig(**kw)


class Mesh:
    """The DeviceMesh over AXES (`device_mesh`) and, for each axis and
    product of axes a step uses, this rank's `Axis` (its group, the global
    ranks along it, its index)."""

    def __init__(self, cfg: MeshConfig, device_type: str):
        from torch.distributed.device_mesh import init_device_mesh
        self.cfg = cfg
        self.device_type = device_type
        self.device_mesh = init_device_mesh(
            device_type, tuple(cfg.size(a) for a in AXES),
            mesh_dim_names=AXES)
        me = dist.get_rank()
        ranks = self.device_mesh.mesh
        self._axes: Dict[Tuple[str, ...], Axis] = {}
        for names in _MESH_AXES:
            dims = [AXES.index(n) for n in names]
            rest = [d for d in range(len(AXES)) if d not in dims]
            lists = ranks.permute(rest + dims).reshape(
                -1, math.prod(cfg.size(n) for n in names)).tolist()
            if len(names) == 1:
                mine = next(g for g in lists if me in g)
                self._axes[names] = Axis(
                    self.device_mesh.get_group(names[0]), mine,
                    mine.index(me), lists)
            else:
                self._axes[names] = _axis_of(lists, me)

    def axis(self, names) -> Axis:
        key = (names,) if isinstance(names, str) else tuple(names)
        return self._axes[key]


def create_mesh(cfg: MeshConfig, device_type: str = "cuda") -> Mesh:
    """The mesh of a process group of cfg.num_devices ranks
    (parallel/distributed.py `init_distributed` first) on device_type's
    devices: "cuda" (the default; raises when no card is visible) or
    "cpu"."""
    require_card(device_type, "create_mesh")
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs torch.distributed initialized "
                           "(parallel.distributed.init_distributed)")
    if dist.get_world_size() != cfg.num_devices:
        raise ValueError(f"need {cfg.num_devices} ranks, have "
                         f"{dist.get_world_size()}")
    return Mesh(cfg, device_type)


# ---------------------------------------------------------------------------
# Batch and sequence
# ---------------------------------------------------------------------------

def local_rows(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch (the reference's
    `batch_sharding`: the batch over ('dp', 'fsdp')); numpy arrays or
    tensors."""
    axis = mesh.axis(("dp", "fsdp"))
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % axis.size:
            raise ValueError(f"{k}: batch {B} does not split over dp x "
                             f"fsdp = {axis.size}")
        b = B // axis.size
        out[k] = v[axis.index * b:(axis.index + 1) * b]
    return out


def seq_shard(mesh: Mesh) -> Tuple[int, int]:
    """(index, size) of this rank's block of the sequence over sp."""
    axis = mesh.axis("sp")
    return axis.index, axis.size


# ---------------------------------------------------------------------------
# Laying a model out for one rank
# ---------------------------------------------------------------------------

_EXPERTS = {"moe_gate", "moe_up", "moe_down"}
_BRANCHES = {"attn": {"q", "k", "v", "o", "q_norm", "k_norm"},
             "mlp": {"gate", "up", "down"}}


def tp_cut(cfg, tp: int) -> frozenset:
    """The branches of the decoder layers cut over tp: "attn" where tp
    divides the query and KV heads, "mlp" where it divides the dense MLP
    width, "experts" where it divides the routed experts; a branch it
    does not divide runs whole on every tp rank (the reference's
    fall-back to replication, at head granularity: the reference may
    still cut a kernel's columns inside a head, which GSPMD gathers)."""
    if tp == 1:
        return frozenset()
    cut = set()
    if cfg.num_attention_heads % tp == 0 and \
            cfg.num_key_value_heads % tp == 0:
        cut.add("attn")
    if cfg.intermediate_size % tp == 0:
        cut.add("mlp")
    if cfg.num_experts and cfg.num_experts % tp == 0:
        cut.add("experts")
    return frozenset(cut)


def tp_split_dim(name: str, t: torch.Tensor, cut) -> Optional[int]:
    """The axis on which LlamaModel tensor `name` is cut over tp in
    training, or None (whole on every rank): serve/tp.py's `split_dim`
    for the branches in `cut` (`tp_cut`), but for the routed experts,
    which are cut on E (their [E, ...] stacks' first axis); the router
    and the shared expert stay whole."""
    from aurora_tpu_torch.serve.tp import split_dim
    parts = name.split(".")
    if len(parts) >= 3 and parts[0] == "layers":
        mod = parts[2]
        if mod in _EXPERTS:
            return 0 if "experts" in cut else None
        base = mod.removesuffix("_bias")
        if not any(base in mods and branch in cut
                   for branch, mods in _BRANCHES.items()):
            return None
    return split_dim(name, t)


class FlatUnit:
    """ZeRO-3 over fsdp for one group of parameters of one dtype (a
    decoder layer's, or the rest of the model's): flattened, padded to a
    multiple of fsdp and cut; this rank keeps `shard` (a leaf, the
    optimizer's parameter). `gather` all-gathers it (an autograd op whose
    backward returns the summed gradient's shard) and sets each module
    attribute to its view of the whole buffer; `release` drops them.

    entries: (module, attribute, name, local tensor, tp split dim);
    tp_partial: the names whose gradient is a partial sum over tp (the
    router of experts cut over tp)."""

    def __init__(self, entries, fsdp: Axis, tp: Axis, tp_partial=()):
        self.fsdp = fsdp
        self.entries = []
        dtypes = {t.dtype for *_, t, _ in entries}
        if len(dtypes) != 1:
            raise TypeError(f"one dtype a unit, got {dtypes}")
        off = 0
        for module, attr, name, t, dim in entries:
            self.entries.append((module, attr, name, tuple(t.shape), off,
                                 t.numel(), dim))
            off += t.numel()
        self.numel = off
        self.n = -(-off // fsdp.size)
        self.shard = self.cut(
            {name: t for _, _, name, t, _ in entries}).requires_grad_(True)
        # the elements this rank counts in the global grad norm (cut over
        # tp, or whole and this rank is tp rank 0) and those whose gradient
        # is a partial sum over tp (the MoE router's)
        self.counted = self._mask(lambda name, dim: dim is not None
                                  or tp.index == 0)
        self.tp_partial = self._mask(lambda name, dim: name in tp_partial)
        for module, attr, *_ in self.entries:
            module._parameters.pop(attr, None)
            setattr(module, attr, None)

    def _mask(self, pred):
        """The shard's elements whose tensors `pred` holds for, as an
        index: None (none), Ellipsis (all) or a bool mask."""
        full = torch.zeros(self.n * self.fsdp.size, dtype=torch.bool)
        for *_, name, shape, off, numel, dim in self.entries:
            if pred(name, dim):
                full[off:off + numel] = True
        mask = full[self.fsdp.index * self.n:(self.fsdp.index + 1) * self.n]
        if not bool(mask.any()):
            return None
        return ... if bool(mask.all()) else mask.to(self.shard.device)

    def cut(self, local: Dict[str, torch.Tensor]) -> torch.Tensor:
        """This rank's shard of the unit's tensors (tp-local, by name)."""
        flat = torch.cat([local[e[2]].detach().reshape(-1)
                          for e in self.entries])
        pad = self.n * self.fsdp.size - self.numel
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat[self.fsdp.index * self.n:
                    (self.fsdp.index + 1) * self.n].clone()

    def views(self, full: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: full[off:off + numel].view(shape)
                for _, _, name, shape, off, numel, _ in self.entries}

    def gather(self) -> None:
        full = all_gather(self.shard, self.fsdp, 0)
        for (module, attr, *_), view in zip(self.entries,
                                            self.views(full).values()):
            setattr(module, attr, view)

    def release(self) -> None:
        for module, attr, *_ in self.entries:
            setattr(module, attr, None)


class ShardedModel:
    """One rank's part of an AuroraModel on a mesh (`shard_model`)."""

    def __init__(self, model, mesh: Mesh, global_cfg, layer_units, root,
                 names: List[str], cut: frozenset):
        self.model = model              # its cfg.llm: the tp-local view
        self.mesh = mesh
        self.global_cfg = global_cfg    # the one-process AuroraConfig
        self.layer_units = layer_units  # one a decoder layer (or None)
        self.root = root                # the rest of the trainable tensors
        self.names = names              # the trainable parameters, in order
        self.cut = cut                  # the branches cut over tp
        self.tp = TensorParallel(mesh.axis("tp"), cut) if cut else None

    @property
    def units(self) -> List[FlatUnit]:
        return [u for u in (*self.layer_units, self.root) if u is not None]

    def params(self) -> List[torch.Tensor]:
        """The optimizer's parameters: each unit's local shard."""
        return [u.shard for u in self.units]

    def gather_root(self) -> None:
        if self.root is not None:
            self.root.gather()

    def release(self) -> None:
        """Drop every unit's gathered views (after a step)."""
        for u in self.units:
            u.release()

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum the shards' gradients over the replicas of this shard (dp
        and sp), in fp32 a unit at a time, and the router's over tp."""
        axis = self.mesh.axis(("dp", "sp"))
        out = []
        for unit, g in zip(self.units, grads):
            if axis.size > 1:
                g = all_reduce_(g.float(), axis).to(g.dtype)
            if unit.tp_partial is not None:
                part = g[unit.tp_partial].float()
                g[unit.tp_partial] = all_reduce_(part, self.tp.axis).to(
                    g.dtype)
            out.append(g)
        return out

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm: each element counted once over fsdp and tp."""
        sq = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        for unit, g in zip(self.units, grads):
            if unit.counted is not None:
                sq = sq + g[unit.counted].float().square().sum()
        return torch.sqrt(all_reduce_(sq, self.mesh.axis(("fsdp", "tp"))))

    def unshard(self, tensors: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Shards laid out as `params()` (the parameters, or optimizer
        moments) → {name: whole tensor} of the one-process model, on every
        rank (collective)."""
        tp = self.mesh.axis("tp")
        out = {}
        for unit, t in zip(self.units, tensors):
            full = _gather(t.detach(), unit.fsdp, 0)
            for _, _, name, shape, off, numel, dim in unit.entries:
                local = full[off:off + numel].view(shape)
                out[name] = (local if dim is None or tp.size == 1
                             else _gather(local.contiguous(), tp, dim))
        return out

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The one-process model's state dict (collective): the trainable
        tensors from the shards, the frozen ones gathered over tp where
        the layers cut them."""
        tp = self.mesh.axis("tp")
        out = {}
        for name, t in self.model.state_dict().items():
            dim = (tp_split_dim(name[len("llm."):], t, self.cut)
                   if name.startswith("llm.layers.") else None)
            out[name] = t if dim is None else _gather(t.contiguous(), tp, dim)
        out.update(self.unshard(self.params()))
        return out

    def shard(self, named: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors of the one-process model by name → this rank's
        shards laid out as `params()`."""
        tp = self.mesh.axis("tp")
        out = []
        for unit in self.units:
            local = {}
            for _, _, name, shape, _, _, dim in unit.entries:
                t = named[name]
                if dim is not None and tp.size > 1:
                    n = t.shape[dim] // tp.size
                    t = t.narrow(dim, tp.index * n, n)
                local[name] = t.to(unit.shard.device, unit.shard.dtype)
            out.append(unit.cut(local))
        return out


def shard_model(model, mesh: Mesh) -> ShardedModel:
    """Lay `model` (an AuroraModel whose frozen modules have
    requires_grad off, train/trainer.py `apply_freeze`) out for this rank
    of `mesh`, in place: the branches of its decoder layers that tp
    divides (`tp_cut`) cut over tp (model.cfg.llm becomes their local
    view), its trainable parameters moved into FlatUnits over fsdp. The
    whole model is needed on every rank first (the same weights: the same
    seed or checkpoint)."""
    from aurora_tpu_torch.serve.tp import local_cfg
    global_cfg = model.cfg
    cfg = model.cfg.llm
    tp, fsdp = mesh.axis("tp"), mesh.axis("fsdp")
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    cut = tp_cut(cfg, tp.size)
    llm_cfg = local_cfg(cfg, tp.size) if "attn" in cut else cfg
    if "mlp" in cut:
        llm_cfg = dataclasses.replace(
            llm_cfg, intermediate_size=cfg.intermediate_size // tp.size)
    with torch.no_grad():
        for name, p in model.llm.named_parameters():
            dim = tp_split_dim(name, p, cut)
            if dim is not None:
                n = p.shape[dim] // tp.size
                p.data = p.data.narrow(dim, tp.index * n, n).clone()

    def entries(module, prefix, skip=None):
        out = []
        for sub, p in module.named_parameters():
            full = prefix + sub
            if not p.requires_grad or (skip and skip(full)):
                continue
            owner, _, attr = sub.rpartition(".")
            dim = (tp_split_dim(full[len("llm."):], p, cut)
                   if full.startswith("llm.layers.") else None)
            out.append((module.get_submodule(owner) if owner else module,
                        attr, full, p, dim))
        return out

    partial = {n for n in names if "experts" in cut
               and n.rsplit(".", 1)[-1] == "moe_router"}
    layer_units = []
    for i, lp in enumerate(model.llm.layers):
        e = entries(lp, f"llm.layers.{i}.")
        layer_units.append(FlatUnit(e, fsdp, tp, partial) if e else None)
    rest = entries(model, "", skip=lambda n: n.startswith("llm.layers."))
    root = FlatUnit(rest, fsdp, tp) if rest else None
    for unit, lp in zip(layer_units, model.llm.layers):
        lp.flat_unit = unit
    model.cfg = dataclasses.replace(global_cfg, llm=llm_cfg)
    return ShardedModel(model, mesh, global_cfg, layer_units, root, names,
                        cut)
