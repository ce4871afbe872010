"""Benchmark timing on the card (port of ``fitclip_tpu/utils/benchmarking.py``).

The method is the reference's: warm up, then take the marginal time between a
short and a long run of chained steps, the best of a few trials, so that the
fixed cost of starting and ending a run cancels. On CUDA the runs are timed
with events on the current stream. A stream runs its launches in order and
CUDA never de-duplicates identical launches, so the steps need no perturbed
inputs; work on side streams must rejoin the current stream before a step
returns (the two-stream arm of ``fitclip_torch/bench/block_layer.py`` does).
"""

from typing import Callable

import torch


def _elapsed_seconds(run_steps: Callable[[int], object], steps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run_steps(steps)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def sustained_seconds_per_step(run_steps: Callable[[int], object], short_steps: int = 5,
                               long_steps: int = 25, trials: int = 2) -> float:
    """run_steps(n) enqueues n steps on the current CUDA stream. Returns the
    best marginal seconds per step across trials. Raises without a card: a
    CPU run measures nothing about the device."""
    if not torch.cuda.is_available():
        raise RuntimeError("sustained_seconds_per_step times the CUDA device; none is available")
    run_steps(short_steps)
    run_steps(long_steps)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(trials):
        t_short = _elapsed_seconds(run_steps, short_steps)
        t_long = _elapsed_seconds(run_steps, long_steps)
        marginal = (t_long - t_short) / (long_steps - short_steps)
        if marginal > 0:
            best = min(best, marginal)
    if best == float("inf"):
        raise RuntimeError("no trial gave a positive marginal time per step")
    return best


def flat_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """The cosine of two outputs taken as flat vectors (the ablation scripts'
    cos_vs_full), in float64."""
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))
