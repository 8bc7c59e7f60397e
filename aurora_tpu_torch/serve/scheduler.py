"""Continuous-batching scheduler (aurora_tpu/serve/scheduler.py).

A JAX-free copy on the port's SamplingParams: requests wait in a queue, a
policy orders them, and a token-budget admission loop moves them into the
running batch. The LPM policy orders them by the prefix the engine's radix
tree holds for each (matched without a lock; the engine matches again and
locks at admission).
"""

from __future__ import annotations

import dataclasses
import enum
import random
import time
from collections import Counter
from typing import Any, List, Optional

import numpy as np

from aurora_tpu_torch.generate.sampler import SamplingParams


class SchedulePolicy(str, enum.Enum):
    FCFS = "fcfs"
    LPM = "lpm"
    LOF = "lof"
    RANDOM = "random"
    DFS_WEIGHT = "dfs-weight"


class FinishReason(str, enum.Enum):
    EOS = "stop"
    LENGTH = "length"
    ABORT = "abort"


@dataclasses.dataclass
class Request:
    rid: str
    input_ids: List[int]
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    max_new_tokens: int = 128
    eos_ids: tuple = (2,)
    stop_strs: tuple = ()
    # serve/constrained.py ChoiceConstraint or serve/fsm.py RegexConstraint
    constraint: Any = None
    stream: bool = False
    logprobs: bool = False
    arrival: float = dataclasses.field(default_factory=time.monotonic)

    # runtime state
    output_ids: List[int] = dataclasses.field(default_factory=list)
    output_logprobs: List[float] = dataclasses.field(default_factory=list)
    output_top_logprobs: List[list] = dataclasses.field(
        default_factory=list)
    prefix_slots: Optional[np.ndarray] = None
    prefix_node: Any = None
    prefix_locked: bool = False    # the LPM pre-match takes no lock
    n_cached: int = 0              # prefix length at admission
    extend_len_pending: int = 0    # new prompt tokens at admission
    # interleaved chunked prefill (a prompt past the largest bucket): its
    # embeddings on the engine's device and the tokens extended so far;
    # prefill_active keeps a partly written row out of the radix cache
    prefill_embeds: Any = None     # torch.Tensor [n_new, D] or None
    prefill_done: int = 0
    prefill_active: bool = False
    batch_row: int = -1
    finished: Optional[FinishReason] = None
    error: Optional[str] = None
    stop_trim: Optional[str] = None   # the stop string that finished it
    # filled by AuroraCapServing.build_request for multimodal requests
    pixel_values: Optional[np.ndarray] = None
    kept_ratio: float = 0.8

    @property
    def seq_len(self) -> int:
        return len(self.input_ids) + len(self.output_ids)

    @property
    def extend_len(self) -> int:
        cached = 0 if self.prefix_slots is None else len(self.prefix_slots)
        return max(1, len(self.input_ids) - cached)

    def check_finished(self) -> None:
        if self.finished is not None:
            return
        if len(self.output_ids) >= self.max_new_tokens:
            self.finished = FinishReason.LENGTH
        elif self.output_ids and self.output_ids[-1] in self.eos_ids:
            self.finished = FinishReason.EOS


class Scheduler:
    """Admission + batch composition over a token budget."""

    def __init__(self, max_batch: int, max_total_tokens: int,
                 policy: SchedulePolicy = SchedulePolicy.LPM,
                 radix_cache=None):
        self.max_batch = max_batch
        self.max_total_tokens = max_total_tokens
        self.policy = policy
        self.radix = radix_cache
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        # admission failures parked here so retire_finished emits them
        self.aborted: List[Request] = []

    def add(self, req: Request) -> None:
        self.waiting.append(req)

    def abort(self, rid: str) -> bool:
        for req in self.waiting:
            if req.rid == rid:
                req.finished = FinishReason.ABORT
                self.waiting.remove(req)
                self.aborted.append(req)
                return True
        for req in self.running:
            if req.rid == rid:
                req.finished = FinishReason.ABORT
                return True
        return False

    def _sort_waiting(self) -> None:
        if self.policy == SchedulePolicy.FCFS:
            self.waiting.sort(key=lambda r: r.arrival)
        elif self.policy == SchedulePolicy.LPM:
            if self.radix is not None:
                for r in self.waiting:
                    r.prefix_slots, r.prefix_node = self.radix.match_prefix(
                        r.input_ids)
            self.waiting.sort(
                key=lambda r: -(0 if r.prefix_slots is None
                                else len(r.prefix_slots)))
        elif self.policy == SchedulePolicy.LOF:
            self.waiting.sort(key=lambda r: -r.max_new_tokens)
        elif self.policy == SchedulePolicy.RANDOM:
            random.shuffle(self.waiting)
        elif self.policy == SchedulePolicy.DFS_WEIGHT:
            def key(r):
                return tuple(r.input_ids[:64])
            sizes = Counter(key(r) for r in self.waiting)
            self.waiting.sort(key=lambda r: (-sizes[key(r)], key(r)))

    def tokens_in_flight(self) -> int:
        return sum(r.seq_len + r.max_new_tokens - len(r.output_ids)
                   for r in self.running)

    def get_prefill_batch(self, free_slots: int) -> List[Request]:
        """Admit waiting requests under the token budget."""
        self._sort_waiting()
        admitted: List[Request] = []
        budget = min(free_slots,
                     self.max_total_tokens - self.tokens_in_flight())
        for req in list(self.waiting):
            if len(self.running) + len(admitted) >= self.max_batch:
                break
            need = req.extend_len + req.max_new_tokens
            if need > budget:
                continue
            budget -= need
            admitted.append(req)
            self.waiting.remove(req)
        return admitted

    def retire_finished(self) -> List[Request]:
        done = [r for r in self.running if r.finished is not None]
        self.running = [r for r in self.running if r.finished is None]
        done.extend(self.aborted)
        self.aborted = []
        return done
