"""The traced window: ``torch.profiler`` over a few units of work, read into
device intervals (kernels, copies, sets) and the harness's own host spans.

The harness marks its calls into each layer with ``span(name)``, a
``record_function`` whose CPU event lands in the same trace and on the same
clock as the device's events, so an idle gap of the device can be charged to
the span the host was in when it began. Busy time is the union of the device
intervals, so overlapping kernels count once.

``HostLoad`` reads the host's side of a unit of work without the profiler:
what the host did while the wall clock ran, for units that take longer than
the device's work alone.
"""

import contextlib
import dataclasses
import gc
import re
import resource
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "bench/"
WINDOW = SPAN_PREFIX + "window"


def span(name: str):
    """A host span of the harness (a no-op outside a profile)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def short_name(name: str) -> str:
    """``void (anonymous namespace)::int8_gemm_wgmma_kernel<2, float>(...)`` ->
    ``int8_gemm_wgmma_kernel``; a name without a signature is kept (to 80)."""
    base = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", base, maxsplit=1)[0].split("::")[-1].strip()
    return (base or name)[:80]


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]            # seconds, on the trace's clock
    device: List[Tuple[str, float, float]]  # (short name, start, end) within the window
    spans: List[Tuple[str, float, float]]   # the harness's host spans

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, start, end in sorted(self.device, key=lambda e: e[1]):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_seconds(self, names) -> float:
        wanted = set(names)
        return sum(end - start for name, start, end in self.device if name in wanted)

    def device_ops(self, top: int = 10) -> List[List]:
        totals: Dict[str, float] = defaultdict(float)
        for name, start, end in self.device:
            totals[name] += end - start
        return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds of the device by the innermost harness span the host
        was in when each gap began ("none" outside every span)."""
        edges = [self.window[0]]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.window[1])
        totals: Dict[str, float] = defaultdict(float)
        for start, end in zip(edges[0::2], edges[1::2]):
            if end > start:
                totals[self._span_at(start)] += end - start
        return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def _span_at(self, t: float) -> str:
        inside = [(b - a, name) for name, a, b in self.spans
                  if a <= t < b and name != WINDOW]
        return min(inside)[1][len(SPAN_PREFIX):] if inside else "none"


class HostLoad:
    """The calling thread's CPU seconds, the process's CPU seconds, the
    thread's involuntary context switches and the garbage collector's seconds,
    as running totals; ``delta(earlier)`` gives them over a unit of work."""

    FIELDS = ("thread_cpu_s", "process_cpu_s", "preempted", "gc_s")

    def __init__(self):
        self._gc_s, self._gc_start = 0.0, None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, _info):
        if phase == "start":
            self._gc_start = time.perf_counter()
        elif self._gc_start is not None:
            self._gc_s += time.perf_counter() - self._gc_start
            self._gc_start = None

    def now(self) -> Tuple[float, float, int, float]:
        switches = resource.getrusage(resource.RUSAGE_THREAD).ru_nivcsw
        return time.thread_time(), time.process_time(), switches, self._gc_s

    def delta(self, earlier) -> Dict[str, float]:
        return {name: round(b - a, 4)
                for name, a, b in zip(self.FIELDS, earlier, self.now())}

    def close(self) -> None:
        gc.callbacks.remove(self._on_gc)


def _is_device(event) -> bool:
    return str(getattr(event, "device_type", "")).endswith("CUDA")


def read(prof) -> Trace:
    """The profile's window span, device events and harness spans, in seconds."""
    window: Optional[Tuple[float, float]] = None
    device, spans = [], []
    for event in prof.events():
        start, end = event.time_range.start * 1e-6, event.time_range.end * 1e-6
        if event.name.startswith(SPAN_PREFIX):
            if _is_device(event):  # the span's range on the device's timeline: not work
                continue
            spans.append((event.name, start, end))
            if event.name == WINDOW:
                window = (start, end)
        elif _is_device(event):
            device.append((short_name(event.name), start, end))
    if window is None:
        raise RuntimeError("the profile holds no window span: nothing was traced")
    device = [(n, max(a, window[0]), min(b, window[1])) for n, a, b in device
              if b > window[0] and a < window[1]]
    return Trace(window, device, spans)


@contextlib.contextmanager
def profiled():
    """A profile of the CPU and the card; yields a list that receives the Trace."""
    from torch.profiler import ProfilerActivity, profile

    out: List[Trace] = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield out
    out.append(read(prof))
