"""Operations and bytes of a call, counted from the model's shapes and the
precisions its configuration states, never from what a kernel does: the count
stays the same whatever kernel implements the call.

A call reads each input byte once and writes each output byte once. Every
count is a floor on what any implementation must move, so a share of the
roofline taken from it cannot pass 100% unless the time leaves out work.
- a dense: 2 * rows * k * n operations; its activation in and its weight in
  their stored precision, its output (and the residual it adds, if any) in
  the model's activation precision; bias and scale vectors in float32.
- an attention core: 4 * heads * d * (query-key pairs) operations (QK^T and
  P.V), a causal one over the lower triangle; qkv in, the output out.
- a backward attention core: 10 * heads * d * (pairs): QK^T again (the
  forward's probabilities are not an input), dV, dP, dQ and dK; qkv and the
  output's gradient in, the gradient of qkv out.
"""

import dataclasses

from port_bench.peaks import least_seconds

BYTES = {"int8": 1, "fp8": 1, "bfloat16": 2, "float16": 2, "float32": 4}


@dataclasses.dataclass(frozen=True)
class Call:
    family: str
    ops: float
    nbytes: float
    precision: str

    def least_seconds(self) -> float:
        return least_seconds(self.ops, self.nbytes, self.precision)


def dense(family: str, rows: int, k: int, n: int, precision: str, act: str,
          residual: bool = False) -> Call:
    """One dense layer: rows x k activations by a (k, n) weight, both stored in
    ``precision``, the output (and a residual) in ``act``."""
    b = BYTES[precision]
    nbytes = rows * k * b + k * n * b + rows * n * BYTES[act] + 2 * n * 4
    if residual:
        nbytes += rows * n * BYTES[act]
    return Call(family, 2.0 * rows * k * n, nbytes, precision)


def attention(family: str, groups: int, heads: int, queries: int, keys: int, head_dim: int,
              precision: str, qkv_rows: int, out_precision: str, causal: bool = False) -> Call:
    """One attention core over ``groups`` independent sequences; ``qkv_rows``
    rows of (3 * heads * head_dim) read, as many output rows written."""
    pairs = queries * (keys + 1) / 2 if causal else queries * keys
    width = heads * head_dim
    nbytes = qkv_rows * 3 * width * BYTES[precision] + qkv_rows * width * BYTES[out_precision]
    return Call(family, 4.0 * groups * heads * head_dim * pairs, nbytes, precision)


def attention_backward(family: str, groups: int, heads: int, length: int, head_dim: int,
                       precision: str, causal: bool = False) -> Call:
    pairs = length * (length + 1) / 2 if causal else length * length
    width = heads * head_dim
    rows = groups * length
    nbytes = rows * (3 * width + width + 3 * width) * BYTES[precision]
    return Call(family, 10.0 * groups * heads * head_dim * pairs, nbytes, precision)


def conv_patches(family: str, images: int, image_size: int, patch: int, width: int,
                 precision: str) -> Call:
    """A stride-patch convolution of 3-channel images: a dense over the patches."""
    patches = (image_size // patch) ** 2
    return dense(family, images * patches, 3 * patch * patch, width, precision, precision)

