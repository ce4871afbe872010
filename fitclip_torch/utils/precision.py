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


@contextlib.contextmanager
def training_convolutions():
    """cuDNN for the duration of training, the global settings restored after:
    in full float32, since a convolution's backward runs outside its forward's
    ``fp32_convolutions`` and the reference differentiates its patch
    embeddings at ``Precision.HIGHEST`` too; and on deterministic algorithms,
    since the default algorithm of the float32 weight gradient accumulates in
    an order that varies from run to run, and a resumed run would then part
    from a straight one."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = saved
