"""The collectives of data-parallel training, built on ``all_gather`` and
``all_reduce`` only, so that they run on gloo and on NCCL alike.

The train steps compute the JAX step's loss over the global batch on every
rank: each rank encodes its own rows and gathers every rank's embeddings
(``gather_rows``), so the score matrix spans the global batch, as GSPMD's
all-gather does inside the JAX package's jitted step (``fitclip_tpu/training/
steps.py:8-13``) and the reference's ``all_gather(sync_grads=True)``
(``util/tensor_utils.py:48-66``).

The gradient scale, worked out once: every rank holds the same loss L. The
gather's backward all-reduces the gathered gradient (the same dL/dE on every
rank) and keeps this rank's rows, so a rank's encoder gradient is N times the
part of dL/dθ that flows through its own rows; ``all_reduce_sum`` (the synced
BatchNorm's sums) has the same factor N by the same argument. A parameter the
loss reads directly on every rank (``logit_scale``, the prompts' text path)
gets the whole dL/dθ on each rank. ``average_gradients`` sums over the N ranks
and divides by N: the encoder's N · Σ_r (rank r's part) / N and the scale's
N · dL/dθ / N are both exactly the global-batch gradient. On one rank every
collective copies and the division is by 1: no bit changes.
"""

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from fitclip_torch.parallel.multihost import collectives_active, host_array

BUCKET_BYTES = 64 << 20  # the gradient all-reduce's flat buckets


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows (the same count on each) along dim 0, in
    rank order. Backward: the gradient summed over ranks, this rank's rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.rows, ctx.rank, ctx.group = x.shape[0], dist.get_rank(group), group
        return host_array(x, group=group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        summed = grad.contiguous().clone()
        dist.all_reduce(summed, group=ctx.group)
        return summed[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    """Forward and backward: the sum over ranks."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        summed = x.contiguous().clone()
        dist.all_reduce(summed)
        return summed

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        summed = grad.contiguous().clone()
        dist.all_reduce(summed)
        return summed


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of ``x`` over ``group`` (the whole process group by
    default; a grid's data group under tensor parallelism), differentiable
    (see the module docstring); ``x`` itself when no collective runs."""
    return _GatherRows.apply(x, group) if collectives_active() else x


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, differentiable; ``x`` when no collective runs."""
    return _AllReduceSum.apply(x) if collectives_active() else x


def world_size() -> int:
    """The ranks the train collectives span (1 when none runs)."""
    return dist.get_world_size() if collectives_active() else 1


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` grouped by (dtype, device) into flat buckets of
    at most BUCKET_BYTES (a larger tensor goes alone)."""
    groups: Dict[tuple, List[List[int]]] = {}
    sizes: Dict[tuple, int] = {}
    for i, t in enumerate(tensors):
        key = (t.dtype, t.device)
        nbytes = t.numel() * t.element_size()
        if key not in groups or sizes[key] + nbytes > BUCKET_BYTES:
            groups.setdefault(key, []).append([])
            sizes[key] = 0
        groups[key][-1].append(i)
        sizes[key] += nbytes
    return [bucket for buckets in groups.values() for bucket in buckets]


def average_gradients(grads: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The mean over the ranks of ``group`` (the whole process group by
    default) of each gradient, all-reduced in flat buckets (one collective a
    bucket, not one a leaf); the gradients themselves when no collective runs."""
    if not collectives_active():
        return list(grads)
    world = dist.get_world_size(group)
    out: List[torch.Tensor] = list(grads)
    for bucket in _buckets(grads):
        flat = torch.cat([grads[i].reshape(-1) for i in bucket])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        offset = 0
        for i in bucket:
            n = grads[i].numel()
            out[i] = flat[offset:offset + n].view_as(grads[i])
            offset += n
    return out
