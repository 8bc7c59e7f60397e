"""Training throughput formulas (a copy of aurora_tpu/train/metrics.py's
JAX-free Megatron TFLOPs helpers; the reference's ThroughputHook,
throughput_hook.py:133-142)."""

from __future__ import annotations

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
