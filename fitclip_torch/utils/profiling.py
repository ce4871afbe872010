"""Profiling: device trace capture, host pipeline stage timing, and the
program's own spans and counters (port of ``fitclip_tpu/utils/profiling.py``).

- ``device_trace(log_dir)``: a context manager around ``torch.profiler``
  (CPU and, where there is a card, CUDA activity) that writes a Chrome trace,
  ``trace.json``, into ``log_dir`` (open it in Perfetto or chrome://tracing),
  with the program's spans on while it records. Without a directory it does
  nothing. The CLI takes it as ``+profile_dir=DIR``.
- ``StageTimer``: the summed host time of named pipeline stages (decode,
  transform, collate, copy), so that a loop bound by its input shows beside
  one bound by the device without a full trace; it also holds the counters.
- ``span(name)``, ``count(name, n)``: the program's spans and counters, off
  unless ``tracing(timer)`` (or ``device_trace``) turned them on. Off, a span
  is one module-global check and a shared no-op: nothing allocated, no clock
  read. On, it is a ``torch.profiler.record_function("fitclip/" + name)``,
  so it lands in any active profile on the same clock as the device's
  events, and its host seconds go to the active timer's stage ``name``.

The spans, each where its work is issued:

- ``encode_video``, ``encode_text``: one tower's call on a batch
  (``training/steps.py:make_eval_step``, ``cli/runners.py``'s evaluate and
  predict loops). Which tower sets the pace of an eval pass's host issue,
  and which holds its device time.
- ``retrieval.update``, ``retrieval.compute``: ``RetrievalEvaluator``'s
  calls; ``compute`` is the score over the whole corpus.
- ``train_step``: one call of a train step (contrastive or teacher-student).
- ``student_forward``, ``teacher_forward``, ``loss``: the step's forward of
  the trained encoder's towers, the frozen teacher's under ``no_grad``, and
  the NCE losses with their mix.
- ``backward``, ``grad_average``, ``optimizer``: ``training/steps.py:_update``'s
  ``torch.autograd.grad``, the gradients' average over ranks (or the FSDP
  apply), and AdamW with its clip and the moments' casts.
- ``calibrate``: an int8 encoder's calibration (the CLI's and each encoder's).
- ``kernel_library``: the CUDA kernel library's first load, the build included.

The counters:

- ``operand_folds``: a block refolding its kernel operands (a CLIP block's
  int8 or bf16 operands, a FiT block's int8 ones) because a source tensor
  changed. An int8 refold costs four host syncs a layer, so in a steady loop
  it reads 0; a count there is a fold cache that misses.
- ``kernel_builds``: the kernel library compiled, not loaded from the build
  directory.
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

SPAN_PREFIX = "fitclip/"


class StageTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - start)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1)
                for name in self.totals}

    def report(self) -> str:
        stages = [f"{name}: {avg * 1e3:.1f}ms avg ({self.counts[name]}x)"
                  for name, avg in sorted(self.summary().items())]
        return " | ".join(stages + [f"{name}: {n}" for name, n in sorted(self.counters.items())])


# The timer that spans and counters record into; None while tracing is off.
_ACTIVE: Optional[StageTimer] = None


class _Off:
    """The span of tracing off: enters and leaves doing nothing."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "timer", "record", "start")

    def __init__(self, name: str, timer: StageTimer) -> None:
        self.name, self.timer = name, timer
        self.record = torch.profiler.record_function(SPAN_PREFIX + name)

    def __enter__(self) -> None:
        self.record.__enter__()
        self.start = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        self.timer.add(self.name, time.perf_counter() - self.start)
        self.record.__exit__(*exc)
        return False


def span(name: str):
    """A span of the program (see the module's docstring); a no-op while off."""
    timer = _ACTIVE
    if timer is None:
        return _OFF
    return _Span(name, timer)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the active timer, if tracing is on."""
    timer = _ACTIVE
    if timer is not None:
        timer.counters[name] += n


@contextlib.contextmanager
def tracing(timer: Optional[StageTimer] = None) -> Iterator[StageTimer]:
    """Spans and counters on for the block, recording into ``timer`` (a new
    one if None); the state before is put back when the block ends."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, timer if timer is not None else StageTimer()
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = saved


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing(_ACTIVE), torch.profiler.profile(activities=activities) as profiler:
        yield
    profiler.export_chrome_trace(os.path.join(log_dir, "trace.json"))
