"""Host-side async data pipeline: worker-thread decode + batch prefetch
(aurora_tpu/data/prefetch.py).

A bounded pipeline of `depth` in-flight batches: each batch fans its
per-sample `fetch` calls out over a `workers`-thread pool, then a
per-batch assembly thread runs `collate` (pad, pack, stack, copy to the
device). Threads, not processes: decoding (zlib, numpy) releases the GIL,
and threads share the CUDA context. Exceptions surface on `next()`;
`close()` tears the pools down.

On a CUDA device the workers' device work (the frames' host-to-device
copies and geometry, the batch's stack and copies) runs on a side stream
of the prefetcher's, so it overlaps the step running on the consumer's
stream. `next()` then makes the consumer's current stream wait for an
event recorded after the batch was assembled, and marks every tensor of
the batch as used on that stream (`record_stream`), so that the caching
allocator does not hand its memory to the side stream again while the
step still reads it.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class BatchPrefetcher:
    """Async pipeline: index batches → fetched samples → collated batch.

    index_iter : iterator of index lists (finite or infinite)
    fetch      : per-sample loader, runs on the worker pool (idx → sample)
    collate    : batch assembler, runs on the assembly pool
                 (list[sample] → device-ready batch)
    depth      : in-flight batches (2 = double buffering)
    workers    : per-sample decode threads shared by all in-flight batches
    device     : where the batches are consumed; a CUDA device gives the
                 workers a side stream (see the module docstring)
    """

    def __init__(self, index_iter: Iterable[Sequence[int]],
                 fetch: Callable, collate: Callable,
                 depth: int = 2, workers: int = 2, device=None):
        if depth < 1 or workers < 1:
            raise ValueError(f"depth={depth} and workers={workers} must be "
                             ">= 1")
        self._it = iter(index_iter)
        self._fetch = fetch
        self._collate = collate
        device = torch.device(device) if device is not None else None
        self._stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(device) if device is not None
            and device.type == "cuda" else None)
        self._samples = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="aurora-sample")
        self._batches = ThreadPoolExecutor(
            max_workers=depth, thread_name_prefix="aurora-batch")
        self._q: deque = deque()
        self._closed = False
        for _ in range(depth):
            self._enqueue()

    def _on_stream(self, fn, *args):
        if self._stream is None:
            return fn(*args)
        with torch.cuda.stream(self._stream):
            return fn(*args)

    def _assemble(self, idxs):
        samples = list(self._samples.map(
            lambda i: self._on_stream(self._fetch, i), idxs))
        batch = self._on_stream(self._collate, samples)
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return batch, ready

    def _enqueue(self) -> None:
        if self._closed:
            return
        try:
            idxs = next(self._it)
        except StopIteration:
            return
        self._q.append(self._batches.submit(self._assemble, idxs))

    def __iter__(self) -> "BatchPrefetcher":
        return self

    def __next__(self):
        if not self._q:
            raise StopIteration
        fut = self._q.popleft()
        self._enqueue()          # keep the pipeline full
        batch, ready = fut.result()
        if ready is not None:
            stream = torch.cuda.current_stream(self._stream.device)
            stream.wait_event(ready)
            for t in _tensors(batch):
                if t.is_cuda:
                    t.record_stream(stream)
        return batch

    def close(self) -> None:
        self._closed = True
        for f in self._q:
            f.cancel()
        self._q.clear()
        self._samples.shutdown(wait=False)
        self._batches.shutdown(wait=False)

    def __enter__(self) -> "BatchPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def index_stream(sampler, batch_size: int,
                 start_step: int = 0) -> Iterator[List[int]]:
    """Infinite, resumable stream of index batches over epochs.

    Epochs reshuffle deterministically via `sampler.set_epoch(e)`.
    Resuming at `start_step` fast-forwards: epoch = step //
    batches_per_epoch, and the first `step % batches_per_epoch` batches of
    that epoch are skipped, so step N+1 of a resumed run consumes exactly
    the batch an uninterrupted run would have.
    """
    from aurora_tpu_torch.data.sampler import batched
    bpe = len(sampler) // batch_size
    if bpe < 1:
        raise ValueError(
            f"dataset yields {len(sampler)} samples per rank < batch_size "
            f"{batch_size}: no full batch exists (drop_last semantics)")
    epoch, skip = divmod(max(0, start_step), bpe)
    while True:
        if hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)
        for k, idxs in enumerate(batched(iter(sampler), batch_size)):
            if k < skip:
                continue
            yield idxs
        skip = 0
        epoch += 1
