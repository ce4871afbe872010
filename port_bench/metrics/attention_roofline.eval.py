"""K1's attention cores' share of their roofline (csrc/attention.cu, int8
mode: the vision rows and the causal text rows)."""

from port_bench.readers import roofline

KERNELS = ("attention_mma_kernel",)


def read(reading):
    return roofline(reading, "attention", KERNELS)
