"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity, at the full 700 W power limit). A share of a peak or of a
roofline is stated against these, with the card's power limit beside it."""

# Operations per second by the precision an operation runs in.
OPS_PER_S = {
    "int8": 1979e12,
    "fp8": 1979e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def least_seconds(ops: float, nbytes: float, precision: str) -> float:
    """The least time a call can take: the larger of its operations over the
    peak of its precision and its bytes over the memory's bandwidth."""
    return max(ops / OPS_PER_S[precision], nbytes / HBM_BYTES_PER_S)
