"""GPipe pipeline parallelism over a tower of layers (port of
``fitclip_tpu/parallel/pipeline.py``).

Stage s of S holds layers [s·L/S, (s+1)·L/S) and only their weights
(``stage_layers``, the counterpart of ``stage_shardings``). ``pipeline_apply``
streams M microbatches through the stages in M + S − 1 steps: at step t stage
s runs microbatch t − s, taking it from stage s − 1 by a point-to-point
receive (stage 0 from the input) and handing its output to stage s + 1 by a
send; a stage with no microbatch at a step (the fill and drain) idles, where
the JAX schedule runs a clamped microbatch and masks its result. The last
stage's outputs are then broadcast to every stage, which stands in for the
JAX schedule's masked ``psum``. The bubble is GPipe's: a stage is busy M of
the M + S − 1 steps.

The gradient is the transpose of the forward, as autodiff gives it in JAX.
Each send and each receive is a ``torch.autograd.Function`` whose backward
moves the cotangent back one stage, and the broadcast's backward sums the
stages' cotangents onto the last stage. So the gradient is that of the sum
of what the stages compute from the output: where every stage computes the
same loss, back-propagate ``loss / S`` on each (or the loss on one stage and
zero on the others). Every stage must run the backward, since its sends and
receives pair with its neighbours'. Over gloo a tensor on the GPU goes
through host memory for a send or receive (gloo's point-to-point takes CPU
tensors).

``layer_fn(layer, h)`` must keep the shape and dtype of ``h`` (a residual
block does), since a stage allocates what it receives from that shape.
"""

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
from torch import nn


def stage_layers(layers: Sequence[nn.Module], stage: int, stages: int) -> nn.ModuleList:
    """Stage ``stage``'s layers, [stage·L/S, (stage+1)·L/S); the caller keeps
    only these (the counterpart of ``stage_shardings``). A stage's backward
    runs through ``torch.autograd.grad`` of its layers' weights (see
    ``_RecvForward``), so the layers are modules that hold them."""
    if len(layers) % stages:
        raise ValueError(f"{len(layers)} layers not divisible by {stages} stages")
    per = len(layers) // stages
    return nn.ModuleList(list(layers)[stage * per:(stage + 1) * per])


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def _through_host(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


# A message's tag is its microbatch, so that a send meets the receive of the
# same microbatch whatever order the two stages' autograd engines take.
def _send(t: torch.Tensor, dst: int, group, tag: int) -> None:
    t = t.detach().contiguous()
    dist.send(t.cpu() if t.is_cuda and _through_host(group) else t, dst, group=group, tag=tag)


def _recv(like: torch.Tensor, src: int, group, tag: int) -> torch.Tensor:
    if like.is_cuda and _through_host(group):
        buffer = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(buffer, src, group=group, tag=tag)
        return buffer.to(like.device)
    buffer = torch.empty_like(like)
    dist.recv(buffer, src, group=group, tag=tag)
    return buffer


class _SendForward(torch.autograd.Function):
    """Forward: ``h`` to the next stage; returns an empty token that keeps the
    send in the graph. Backward: the next stage's cotangent of ``h``."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, dst: int, group, tag: int) -> torch.Tensor:
        ctx.like, ctx.dst, ctx.group, ctx.tag = torch.empty_like(h), dst, group, tag
        _send(h, dst, group, tag)
        return h.new_empty(0)

    @staticmethod
    def backward(ctx, _token_grad):
        return _recv(ctx.like, ctx.dst, ctx.group, ctx.tag), None, None, None


class _RecvForward(torch.autograd.Function):
    """Forward: the previous stage's activation. Backward: its cotangent sent
    back to that stage. ``anchor`` is an empty slice of one of the stage's
    weights (``_anchor``), so that the receive is in the graph and on the way
    to the weights: ``torch.autograd.grad`` of the weights runs its backward."""

    @staticmethod
    def forward(ctx, anchor: torch.Tensor, like: torch.Tensor, src: int, group,
                tag: int) -> torch.Tensor:
        ctx.src, ctx.group, ctx.tag = src, group, tag
        return _recv(like, src, group, tag)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        _send(grad, ctx.src, ctx.group, ctx.tag)
        return None, None, None, None, None


class _FromLastStage(torch.autograd.Function):
    """Forward: the last stage's ``value`` on every stage (a broadcast; the
    other stages pass their send tokens as ``value``). Backward: the stages'
    cotangents summed, on the last stage; zeros for the others' tokens."""

    @staticmethod
    def forward(ctx, value: torch.Tensor, like: torch.Tensor, last: int, is_last: bool,
                group) -> torch.Tensor:
        ctx.last, ctx.is_last, ctx.group = last, is_last, group
        ctx.token_shape = value.shape
        out = value.detach().clone() if is_last else torch.empty_like(like)
        dist.broadcast(out, last, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        summed = grad.contiguous().clone()
        dist.all_reduce(summed, group=ctx.group)
        out = summed if ctx.is_last else summed.new_zeros(ctx.token_shape)
        return out, None, None, None, None


def _anchor(local_layers: Sequence[nn.Module], x: torch.Tensor) -> torch.Tensor:
    """An empty tensor that requires a gradient: a slice of the stage's first
    trainable weight, or a fresh leaf where the stage trains none."""
    for layer in local_layers:
        for p in layer.parameters():
            if p.requires_grad:
                return p.view(-1)[:0]
    return x.new_empty(0, requires_grad=True)


def pipeline_apply(layer_fn: Callable[[nn.Module, torch.Tensor], torch.Tensor],
                   local_layers: Sequence[nn.Module], x: torch.Tensor,
                   num_microbatches: int, group=None) -> torch.Tensor:
    """Run ``x`` through every stage's layers, pipelined over the ranks of
    ``group`` (the whole process group by default; stage = rank in it).

    ``layer_fn(layer, h)`` applies one layer; ``local_layers`` is this stage's
    (``stage_layers``); ``x`` is the whole batch (B, ...) on every stage, B
    divisible by ``num_microbatches``. Returns the sequential tower's value on
    every stage, differentiable end to end (see the module docstring)."""
    batch = x.shape[0]
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by {num_microbatches} microbatches")
    stages, stage = dist.get_world_size(group), dist.get_rank(group)
    microbatches = x.chunk(num_microbatches)
    first, last = stage == 0, stage == stages - 1
    previous = _global(group, stage - 1) if not first else None
    following = _global(group, stage + 1) if not last else None
    tracked = torch.is_grad_enabled()
    outputs: List[torch.Tensor] = []
    tokens: List[torch.Tensor] = []
    for t in range(num_microbatches + stages - 1):
        index = t - stage
        if not 0 <= index < num_microbatches:
            continue  # the fill or the drain: nothing for this stage
        if first:
            h = microbatches[index]
        else:
            anchor = _anchor(local_layers, x) if tracked else x.new_empty(0)
            h = _RecvForward.apply(anchor, microbatches[index], previous, group, index)
        for layer in local_layers:
            h = layer_fn(layer, h)
        if last:
            outputs.append(h)
        else:
            tokens.append(_SendForward.apply(h, following, group, index))
    value = torch.cat(outputs) if last else torch.cat(tokens)
    return _FromLastStage.apply(value, x, _global(group, stages - 1), last, group)
