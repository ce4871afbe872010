"""FiT's attention cores' share of their roofline (csrc/fit_attention.cu:
space, time and the CLS row, int8 output)."""

from port_bench.readers import roofline

KERNELS = ("space_mma_kernel", "time_rows_kernel", "cls_rows_kernel")


def read(reading):
    return roofline(reading, "fit_attention", KERNELS)
