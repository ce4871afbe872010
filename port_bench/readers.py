"""Arithmetic the metric readers share (``metrics/<name>.py`` each call one
of these with its own arguments). Every reader returns None where the run
gives it nothing to read: no trace, no unit, no kernel of its family."""

from typing import Iterable, Optional

from port_bench.peaks import OPS_PER_S


def idle_share(reading) -> Optional[float]:
    """Per cent of the traced window in which no operation ran on the device."""
    trace = reading.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def mfu(reading) -> Optional[float]:
    """Per cent of the chip's peak: the least time a unit's matmul-class
    operations need at the peak of each one's precision, times the window's
    units, over the window's time (host clock, the device synchronised at its
    end). The untraced window, so the profiler's own cost is not in it."""
    if not reading.units or reading.window_s <= 0:
        return None
    least = sum(c.ops / OPS_PER_S[c.precision] for c in reading.unit_calls)
    return 100.0 * least * reading.units / reading.window_s


def roofline(reading, family: str, kernels: Iterable[str]) -> Optional[float]:
    """Per cent of the family's roofline: the least time of its calls in the
    traced units (``work.Call.least_seconds``) over the device time of the
    kernels that implement it (short names, as ``tracing.short_name`` gives)."""
    if reading.trace is None or not reading.traced_units:
        return None
    calls = [c for c in reading.unit_calls if c.family == family]
    busy = reading.trace.kernel_seconds(kernels)
    if not calls or busy <= 0:
        return None
    return 100.0 * sum(c.least_seconds() for c in calls) * reading.traced_units / busy


def span_ms(reading, name: str) -> Optional[float]:
    """The mean host milliseconds a unit spent in the harness span ``name``."""
    values = reading.span_s.get(name) or []
    return 1e3 * sum(values) / len(values) if values else None
