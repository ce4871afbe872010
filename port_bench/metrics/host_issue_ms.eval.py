"""Host milliseconds a pass spends issuing its batches (the eval step and the
evaluator's update), the device not waited on."""

from port_bench.readers import span_ms


def read(reading):
    return span_ms(reading, "issue")
