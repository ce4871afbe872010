"""Host array helpers (port of ``fitclip_tpu/utils/tensor.py``): right-padding
of numpy arrays for batch collation."""

from typing import Sequence

import numpy as np


def pad_axis_to(x: np.ndarray, size: int, axis: int = 0, value=0) -> np.ndarray:
    """Right-pad ``axis`` of ``x`` up to at least ``size``."""
    current = x.shape[axis]
    if current >= size:
        return x
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, size - current)
    return np.pad(x, pad_width, constant_values=value)


def stack_padded(arrays: Sequence[np.ndarray], value=0) -> np.ndarray:
    """Stack arrays whose first axes differ, right-padding each to the longest
    (``pad_sequence(batch_first=True)``)."""
    max_len = max(a.shape[0] for a in arrays)
    return np.stack([pad_axis_to(a, max_len, axis=0, value=value) for a in arrays])
