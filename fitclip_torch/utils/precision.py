"""Numerical precision settings that the port fixes where the reference does."""

import contextlib

import torch


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN's float32 convolutions in full float32 for the duration, the
    global setting restored after. PyTorch lets cuDNN run them in TF32 by
    default (``torch.backends.cudnn.allow_tf32``), where the reference computes
    its patch embeddings at ``Precision.HIGHEST``."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved
