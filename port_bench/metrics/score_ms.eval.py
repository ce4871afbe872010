"""Host milliseconds of RetrievalEvaluator.compute a pass (the scores and ranks,
on the CPU; it waits for the device first)."""

from port_bench.readers import span_ms


def read(reading):
    return span_ms(reading, "score")
