"""The int8 GEMMs' share of their roofline (csrc/int8_gemm.cu)."""

from port_bench.readers import roofline

KERNELS = ("int8_gemm_wgmma_kernel",)


def read(reading):
    return roofline(reading, "int8_gemm", KERNELS)
