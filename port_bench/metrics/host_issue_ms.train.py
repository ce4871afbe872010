"""Host milliseconds inside the train step's call, a step."""

from port_bench.readers import span_ms


def read(reading):
    return span_ms(reading, "step")
