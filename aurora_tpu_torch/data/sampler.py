"""Samplers: length-grouped and data-parallel sharding (a copy of
aurora_tpu/data/sampler.py).

  * LengthGroupedSampler — megabatches sorted by modality-signed length,
    so that batches are homogeneous in modality and length; shuffled with
    the stdlib `random`, so its order equals the reference's;
  * ParallelSampler — a plain shuffled sampler sharded over the DP axis;
  * batched — index lists of batch_size.
"""

from __future__ import annotations

import random
from typing import Iterator, List


class LengthGroupedSampler:
    def __init__(self, lengths: List[int], batch_size: int,
                 mega_batch_mult: int = 50, seed: int = 0,
                 dp_rank: int = 0, dp_size: int = 1):
        self.lengths = lengths
        self.batch_size = batch_size
        self.mega = batch_size * mega_batch_mult
        self.seed = seed
        self.epoch = 0
        self.dp_rank = dp_rank
        self.dp_size = dp_size

    def set_epoch(self, epoch: int) -> None:
        """Deterministic per-epoch reshuffle (torch DistributedSampler
        semantics; enables exact data-order resume via
        data.prefetch.index_stream)."""
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = random.Random(self.seed + self.epoch)
        idx = list(range(len(self.lengths)))
        rng.shuffle(idx)
        out: List[int] = []
        for i in range(0, len(idx), self.mega):
            mb = idx[i:i + self.mega]
            # sort by signed length: multimodal (+) and text (−) separate,
            # similar lengths adjacent
            mb.sort(key=lambda j: self.lengths[j], reverse=True)
            out.extend(mb)
        # shard over DP: strided so each rank sees similar lengths
        yield from out[self.dp_rank::self.dp_size]

    def __len__(self) -> int:
        return len(self.lengths) // self.dp_size


class ParallelSampler:
    """Plain shuffled sampler sharded over the DP axis."""

    def __init__(self, n: int, dp_rank: int = 0, dp_size: int = 1,
                 seed: int = 0, shuffle: bool = True):
        self.n, self.dp_rank, self.dp_size = n, dp_rank, dp_size
        self.seed, self.shuffle = seed, shuffle
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        idx = list(range(self.n))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        yield from idx[self.dp_rank::self.dp_size]

    def __len__(self) -> int:
        return self.n // self.dp_size


def batched(iterator, batch_size: int, drop_last: bool = True):
    buf = []
    for x in iterator:
        buf.append(x)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf and not drop_last:
        yield buf
