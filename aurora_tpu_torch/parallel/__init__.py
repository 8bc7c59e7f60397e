"""Sequence parallelism and the training mesh (aurora_tpu/parallel/):
process start-up (`distributed`), the autograd collectives
(`collectives`), Ulysses, ring and hybrid attention (`ulysses`, `ring`,
`hybrid`) and the dp × fsdp × sp × tp layout of a model (`mesh`)."""

from aurora_tpu_torch.parallel.mesh import (AXES, MeshConfig, create_mesh,
                                            local_rows, shard_model)

__all__ = ["AXES", "MeshConfig", "create_mesh", "local_rows", "shard_model"]
