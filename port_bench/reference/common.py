"""Plain float32 pieces the references share. The reference imports nothing
of the program and takes nothing the program made: it is handed the
benchmark's weights and inputs."""

import contextlib
import math

import torch


@contextlib.contextmanager
def full_float32():
    """float32 products in full float32 on the card: TF32 off for matmuls and
    cuDNN, the settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight + bias


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor = None) -> torch.Tensor:
    """q (..., Lq, d), k and v (..., Lk, d); mask True where a key is seen."""
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.softmax(logits, dim=-1) @ v


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., L, W) -> (..., heads, L, W / heads)."""
    *lead, length, width = x.shape
    return x.reshape(*lead, length, heads, width // heads).transpose(-3, -2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    *lead, heads, length, d = x.shape
    return x.transpose(-3, -2).reshape(*lead, length, heads * d)


def l2_normalize(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp_min(norm, eps) if eps else x / norm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)
