"""The whole unit's share of the chip's peak: its matmul-class operations at
the peak of their stated precision, over its time in the untraced window."""

from port_bench.readers import mfu


def read(reading):
    return mfu(reading)
