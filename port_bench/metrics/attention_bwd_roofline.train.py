"""The bf16 attention backward's share of its roofline (csrc/attention_bwd.cu, K3b)."""

from port_bench.readers import roofline

KERNELS = ("rows_mma_kernel", "columns_mma_kernel")


def read(reading):
    return roofline(reading, "attention_bwd", KERNELS)
