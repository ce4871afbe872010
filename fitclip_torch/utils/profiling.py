"""Profiling: device trace capture and host pipeline stage timing (port of
``fitclip_tpu/utils/profiling.py``).

- ``device_trace(log_dir)``: a context manager around ``torch.profiler``
  (CPU and, where there is a card, CUDA activity) that writes a Chrome trace,
  ``trace.json``, into ``log_dir`` (open it in Perfetto or chrome://tracing).
  Without a directory it does nothing.
- ``StageTimer``: the summed host time of named pipeline stages (decode,
  transform, collate, copy), so that a loop bound by its input shows beside
  one bound by the device without a full trace.
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as profiler:
        yield
    profiler.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - start
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1)
                for name in self.totals}

    def report(self) -> str:
        return " | ".join(f"{name}: {avg * 1e3:.1f}ms avg ({self.counts[name]}x)"
                          for name, avg in sorted(self.summary().items()))
