"""Per-layer rematerialization (the reference's `jax.checkpoint` around
each scanned layer, models/llama.py and models/vit.py).

`remat` takes the reference's values:
  * False — keep every activation;
  * True or "full" — `torch.utils.checkpoint` (non-reentrant) around the
    layer: the backward recomputes all of it;
  * "dots_with_no_batch_dims_saveable" — a selective-checkpoint policy
    (`create_selective_checkpoint_contexts`) that keeps the outputs of the
    weight matmuls (`aten.mm`/`aten.addmm`, the products without a batch
    dimension) and recomputes the rest;
  * "dots_saveable" — keeps every matmul output, batched ones
    (`aten.bmm`/`aten.baddbmm`, the plain attention's products) included,
    and the flash kernel's (out, lse) (the `aurora_tpu_torch::flash_fwd`
    op): the attention output is not recomputed.
Any other name raises ValueError.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

import aurora_tpu_torch.ops.pallas.flash_attention  # noqa: F401 (the op)


def _saved_ops(policy: str):
    aten = torch.ops.aten
    unbatched = {aten.mm.default, aten.addmm.default}
    if policy == "dots_with_no_batch_dims_saveable":
        return unbatched
    if policy == "dots_saveable":
        return unbatched | {aten.bmm.default, aten.baddbmm.default,
                            torch.ops.aurora_tpu_torch.flash_fwd.default}
    raise ValueError(f"unknown remat policy {policy!r}: True, 'full', "
                     "'dots_with_no_batch_dims_saveable' or 'dots_saveable'")


def _context_fn(policy: str):
    saved = _saved_ops(policy)

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def remat_call(fn, remat, *args):
    """fn(*args), under the checkpoint that `remat` names."""
    if not remat:
        return fn(*args)
    if remat is True or remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_context_fn(remat))
