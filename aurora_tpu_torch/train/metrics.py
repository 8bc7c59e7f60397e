"""Training throughput (a copy of aurora_tpu/train/metrics.py): the
Megatron-convention TFLOPs helpers and `Throughput`, the step loop's
tokens/s, TFLOP/s, exposed data wait and eta."""

from __future__ import annotations

import time
from typing import Optional


def megatron_flops_per_token(hidden: int, num_layers: int, vocab: int,
                             seq_len: int, *, mlp_ratio: float = None,
                             intermediate: Optional[int] = None,
                             use_swiglu: bool = True) -> float:
    """FLOPs per token for a dense decoder fwd+bwd (factor 3×2),
    Megatron-LM convention."""
    if intermediate is None:
        intermediate = int(hidden * (mlp_ratio or 4))
    mlp_mults = 3 if use_swiglu else 2
    per_layer = (
        4 * hidden * hidden          # qkvo
        + 2 * hidden * seq_len       # attention scores+values (per token)
        + mlp_mults * hidden * intermediate)
    return 2 * 3 * (num_layers * per_layer + hidden * vocab)


def megatron_tflops_per_device(tokens_per_step: int, step_time_s: float,
                               hidden: int, num_layers: int, vocab: int,
                               seq_len: int, num_devices: int = 1,
                               intermediate: Optional[int] = None) -> float:
    fl = megatron_flops_per_token(hidden, num_layers, vocab, seq_len,
                                  intermediate=intermediate)
    return tokens_per_step * fl / step_time_s / num_devices / 1e12


class Throughput:
    """Step-loop companion: tgs (tokens/device/sec), TFLOPs, data time, eta."""

    def __init__(self, hidden: int, num_layers: int, vocab: int,
                 num_devices: int = 1,
                 intermediate: Optional[int] = None):
        self.hidden, self.num_layers = hidden, num_layers
        self.vocab, self.num_devices = vocab, num_devices
        self.intermediate = intermediate
        self._t = time.perf_counter()
        self._data_t = 0.0       # accumulated data-load seconds in window
        self._tick = None

    def data_tick(self):
        """Mark the START of a data fetch; pair with data_tock()."""
        self._tick = time.perf_counter()

    def data_tock(self):
        """Mark the END of a data fetch — accumulates the fetch
        duration into the current log window (the old formula reported
        'window start → last fetch START', which grows with
        log_interval and says nothing about data-loading cost)."""
        if self._tick is not None:
            self._data_t += time.perf_counter() - self._tick
            self._tick = None

    def step(self, tokens: int, seq_len: int, step: int, max_steps: int,
             window_steps: int = 1):
        """tokens = tokens processed since the LAST call; window_steps =
        train steps that window covers (eta scales dt to per-step)."""
        now = time.perf_counter()
        dt = now - self._t
        self._t = now
        tgs = tokens / dt / self.num_devices
        tflops = megatron_tflops_per_device(
            tokens, dt, self.hidden, self.num_layers, self.vocab, seq_len,
            self.num_devices, self.intermediate)
        eta = dt / max(window_steps, 1) * (max_steps - step)
        data_time = self._data_t
        self._data_t = 0.0
        return {"step_time": dt, "tgs": tgs, "tflops": tflops,
                "eta_s": eta, "data_time": data_time}
