"""The collectives of sequence and tensor parallelism as autograd
functions, over one axis of the mesh.

JAX differentiates its collectives itself (`all_to_all` is its own
transpose, `all_gather`'s is a reduce-scatter, `ppermute`'s the reverse
permutation). torch.distributed's are not differentiable, so each one
here is a `torch.autograd.Function` with its transpose written out:

  * `all_to_all(x, axis, split_dim, concat_dim)` — tiled, as JAX's
    tiled=True: x cut into axis.size chunks along split_dim, chunk j sent
    to the j-th rank of the axis, the received chunks concatenated along
    concat_dim in rank order; backward: the reverse all-to-all;
  * `all_gather(x, axis, dim)` — tiled along dim; backward: the summed
    gradient's chunk of this rank (a reduce-scatter, here an all-reduce
    and this rank's slice);
  * `ring_pass(x, axis)` — JAX's ppermute over the ring i → i + 1,
    n − 1 times: x and the blocks of the ranks 1, 2, ..., n − 1 places
    back (isend / irecv); backward: the reverse ring, all of it;
  * `reduce_sum(x, axis)` — all-reduce (sum) forward, identity backward
    (after a tensor-parallel partial product: Megatron's g);
  * `enter_parallel(x, axis)` — identity forward, all-reduce backward
    (before a tensor-parallel region whose input every rank holds whole:
    Megatron's f).

Transport: a gloo group takes host tensors. For a gloo group and CUDA
tensors, each collective copies its operands to host memory, runs, and
copies the result back to the card (`host_staged` counts those calls).
That is the transport of several ranks sharing one card, not a fallback:
the attention kernels still run on the card, and a failed collective
raises.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


class Axis:
    """One axis of the mesh (or a part of one) as this rank sees it.

    group: the process group of this rank's ranks along the axis;
    ranks: their global ranks in axis order (torch orders a group's ranks
    the same way); index: this rank's position among them; every_group:
    the rank lists of every group along the axis across the whole mesh,
    which `split` needs, since every rank must create every group."""

    def __init__(self, group, ranks: List[int], index: int,
                 every_group: List[List[int]]):
        self.group = group
        self.ranks = list(ranks)
        self.index = index
        self.every_group = [list(g) for g in every_group]
        self._splits = {}

    @property
    def size(self) -> int:
        return len(self.ranks)

    def split(self, inner: int):
        """(blocks, strides): this axis cut into consecutive blocks of
        `inner` ranks and into the `inner` strided groups across those
        blocks (the reference's `_ulysses_groups` / `_inner_groups` and
        `_ring_groups`). Made once, on every rank, for every group along
        the axis."""
        if inner in self._splits:
            return self._splits[inner]
        if self.size % inner:
            raise ValueError(f"{inner} does not divide the axis size "
                             f"{self.size}")
        me = self.ranks[self.index]
        blocks = [g[b:b + inner] for g in self.every_group
                  for b in range(0, len(g), inner)]
        strides = [g[j::inner] for g in self.every_group
                   for j in range(inner)]
        out = tuple(_axis_of(lists, me) for lists in (blocks, strides))
        self._splits[inner] = out
        return out


def _axis_of(lists: List[List[int]], me: int) -> Axis:
    """Create the groups `lists` (on every rank, in one order) and return
    the Axis of the one holding global rank `me`."""
    groups = [dist.new_group(ranks) if len(ranks) > 1 else None
              for ranks in lists]
    for ranks, group in zip(lists, groups):
        if me in ranks:
            return Axis(group, ranks, ranks.index(me), lists)
    raise ValueError(f"rank {me} is in none of {lists}")


host_staged = 0     # collectives that copied CUDA tensors through the host


def _staged(axis: Axis, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(axis.group) == "gloo"


def _run(axis: Axis, fn, out: torch.Tensor, inp: torch.Tensor):
    """fn(out, inp) on the axis' group, through host buffers where the
    group's backend is gloo and the tensors live on a card."""
    global host_staged
    if not _staged(axis, inp):
        fn(out, inp)
        return out
    host_staged += 1
    h_out = torch.empty(out.shape, dtype=out.dtype, device="cpu")
    fn(h_out, inp.cpu())
    out.copy_(h_out)
    return out


def all_reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """In-place sum over the axis (no autograd); t itself is returned."""
    if axis.size == 1:
        return t

    def fn(o, i):
        if o is not i:
            o.copy_(i)
        dist.all_reduce(o, group=axis.group)
    return _run(axis, fn, t, t)


def all_reduce_list(ts: List[torch.Tensor], axis: Axis) -> List[torch.Tensor]:
    """Sum a list of tensors over the axis in one fp32 collective → new
    tensors in their own dtypes (the inputs themselves for size 1)."""
    if axis.size == 1:
        return list(ts)
    flat = all_reduce_(torch.cat([t.float().reshape(-1) for t in ts]), axis)
    return [f.view(t.shape).to(t.dtype) for f, t in
            zip(flat.split([t.numel() for t in ts]), ts)]


def _all_to_all(x, axis, split_dim, concat_dim):
    n = axis.size
    inp = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    _run(axis, lambda o, i: dist.all_to_all_single(o, i, group=axis.group),
         out, inp)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return _all_to_all(g, axis, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    if axis.size == 1:
        return x
    if x.shape[split_dim] % axis.size:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split {axis.size} ways")
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def _gather(x, axis, dim):
    if axis.size == 1:
        return x
    out = torch.empty((axis.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _run(axis, lambda o, i: dist.all_gather_into_tensor(
        o, i, group=axis.group), out, x.contiguous())
    return torch.cat(out.view((axis.size,) + tuple(x.shape)).unbind(0),
                     dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.args = (axis, dim, x.shape[dim])
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim, n = ctx.args
        g = all_reduce_(g.contiguous().clone(), axis)
        # a copy, so that the summed whole gradient is freed now (a view
        # would hold it for as long as the shard's gradient lives)
        return g.narrow(dim, axis.index * n, n).clone(), None, None


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    if axis.size == 1:
        return x
    if not x.requires_grad:
        return _gather(x, axis, dim)
    return _AllGather.apply(x, axis, dim)


def _shift(x, axis, step):
    """x sent to the rank `step` places on along the ring; the tensor
    from the rank `step` places back received."""
    n, i = axis.size, axis.index
    dst, src = axis.ranks[(i + step) % n], axis.ranks[(i - step) % n]
    staged = _staged(axis, x)
    send = x.contiguous().cpu() if staged else x.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst),
                                   dist.P2POp(dist.irecv, recv, src)])
    for r in reqs:
        r.wait()
    if staged:
        global host_staged
        host_staged += 1
        return recv.to(x.device)
    return recv


class _RingPass(torch.autograd.Function):
    """x passed around the whole ring: outputs x (a copy) and the blocks
    of the ranks 1, 2, ..., n − 1 places back. One node whose first
    output every ring step 0 uses, so that its backward (the whole
    reverse ring) runs on every rank even where the other blocks took no
    part in the loss (a causal ring's skipped blocks): a chain of single
    exchanges would run its backward only as far as the gradients reach,
    and leave the other ranks waiting."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        outs = [x.clone()]
        for _ in range(axis.size - 1):
            outs.append(_shift(outs[-1], axis, 1))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        acc = gs[-1]
        for g in reversed(gs[:-1]):
            acc = _shift(acc, ctx.axis, -1) + g
        return acc, None


def ring_pass(x: torch.Tensor, axis: Axis) -> List[torch.Tensor]:
    """[x, the previous rank's x, the one before, ...]: the blocks a ring
    loop takes at its steps 0 .. n − 1 (n − 1 ring shifts forward, the
    reverse ring backward)."""
    if axis.size == 1:
        return [x]
    return list(_RingPass.apply(x, axis))


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


def reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceSum.apply(x, axis)


def enter_parallel(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _EnterParallel.apply(x, axis)


class TensorParallel:
    """The two hooks a decoder layer takes under tensor parallelism
    (models/llama.py `_layer`): `enter` before the column-cut products
    (q/k/v, gate/up, the local experts), `reduce` after the row-cut ones
    (o, down) and before their biases and output norms. cut: the
    branches cut over tp ("attn", "mlp", "experts"); the others run whole
    on every rank."""

    def __init__(self, axis: Axis, cut):
        self.axis = axis
        self.cut = frozenset(cut)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return enter_parallel(x, self.axis)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_sum(x, self.axis)
