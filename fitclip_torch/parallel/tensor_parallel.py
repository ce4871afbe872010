"""Megatron tensor parallelism over a grid's model group (the port of the
layout ``fitclip_tpu/parallel/sharding_rules.py`` annotates and GSPMD runs).

JAX annotates the weights and lets XLA place the collectives; here they are
Megatron's two operators, each a ``torch.autograd.Function`` on the model
group:

- *f* (``copy_to_model``): the identity forward, an all-reduce of the
  gradient backward; it enters a column-parallel product, whose input every
  rank holds whole;
- *g* (``reduce_from_model``): an all-reduce forward, the identity backward;
  it leaves a row-parallel product, whose partial sums it adds.

On them stand the column-parallel dense (each rank its block of the output
features and of the bias), the row-parallel dense (each rank its block of
the input features; the partial products all-reduced, then the whole bias
added once) and the vocab-parallel embedding (each rank its block of the
table's rows; ids outside it are masked to zero rows, then all-reduced).

``parallelize_clip_model`` switches a ``CLIPModel`` whose parameters hold the
rank's parts (``sharding_rules.shard_params``) to these operators by giving
each split module its subclass here (``ColumnParallelDense``,
``RowParallelDense``, ``VocabParallelTextTransformer``): each block's
``attn.in_proj`` and ``mlp_fc`` are column-parallel, ``attn.out_proj`` and
``mlp_proj`` row-parallel, the text's ``token_embedding`` vocab-parallel,
and the attention runs ``heads / model`` heads a rank through
``ops/attention.py:fused_attention_qkv`` (K3f, and K3b in the backward) on the
rank's packed QKV. The residual adds follow the row-parallel products, whose
outputs are whole on every rank, so each is added once. Everything else (the
patch embedding, the LayerNorms, the projections) is replicated: each rank
computes it, and its gradient, whole.
"""

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fitclip_torch.models.clip.model import Dense, TextTransformer


class _CopyToModel(torch.autograd.Function):
    """f: the identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        summed = grad.contiguous().clone()
        dist.all_reduce(summed, group=ctx.group)
        return summed, None


class _ReduceFromModel(torch.autograd.Function):
    """g: the sum over the group forward; the identity backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        summed = x.contiguous().clone()
        dist.all_reduce(summed, group=group)
        return summed

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def column_parallel_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           group) -> torch.Tensor:
    """x whole on every rank; weight (out / model, in) and bias (out / model)
    the rank's rows -> the rank's block of the output features."""
    return F.linear(copy_to_model(x, group), weight, bias)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        group) -> torch.Tensor:
    """x the rank's block of the input features; weight (out, in / model) its
    columns; bias whole -> the whole output on every rank, the bias added once
    after the sum."""
    return reduce_from_model(F.linear(x, weight), group) + bias


def vocab_parallel_embedding(table: torch.Tensor, ids: torch.Tensor, start: int,
                             group) -> torch.Tensor:
    """table: the rank's rows [start, start + rows) of the embedding; ids the
    whole batch's -> every id's row, on every rank."""
    local = ids - start
    outside = (local < 0) | (local >= table.shape[0])
    rows = table[local.masked_fill(outside, 0)]
    return reduce_from_model(rows.masked_fill(outside.unsqueeze(-1), 0.0), group)


def refuse_fused_paths(encoder) -> None:
    """Tensor parallelism runs the float module path. The fused int8 and bf16
    layers and the static int8 QKV attention take whole weights in one launch
    chain; no TP of them is ported (nor tested in JAX over its Pallas layers)."""
    model = getattr(encoder, "model", encoder)
    if getattr(model, "quantized", False):
        raise ValueError("tensor parallelism runs the float module path: an int8 encoder "
                         "(the fused int8 layer K1, ops/block.py:fused_int8_layer, and the "
                         "static int8 QKV attention K8, ops/attention.py:"
                         "fused_int8_qkv_attention) is not split")
    if getattr(encoder, "fused_block", False):
        raise ValueError("tensor parallelism runs the float module path: fused_block=True "
                         "(the fused bf16 layer K2, ops/block.py:fused_bf16_layer) is not split")


class ColumnParallelDense(Dense):
    """A ``Dense`` whose weight and bias are this rank's block of the output
    features; ``group`` is the model group."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return column_parallel_linear(x.to(self.dtype), self.weight.to(self.dtype),
                                      self.bias.to(self.dtype), self.group)


class RowParallelDense(Dense):
    """A ``Dense`` whose weight is this rank's block of the input features;
    the bias is whole."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_parallel_linear(x.to(self.dtype), self.weight.to(self.dtype),
                                   self.bias.to(self.dtype), self.group)


class VocabParallelTextTransformer(TextTransformer):
    """A ``TextTransformer`` whose ``token_embedding`` is this rank's rows,
    from ``vocab_start`` on."""

    vocab_start, group = 0, None

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = vocab_parallel_embedding(self.token_embedding, input_ids, self.vocab_start,
                                     self.group).to(self.dtype)
        return x + self.positional_embedding[:x.shape[1]].to(self.dtype)


_PARALLEL_DENSE = {"column": ColumnParallelDense, "row": RowParallelDense}


def parallelize_clip_model(model, grid) -> None:
    """Switch a CLIPModel, whose parameters already hold this rank's parts, to
    the tensor-parallel operators on ``grid.model_group``, in place: each
    dense layer that ``sharding_rules._RULES`` splits becomes its column- or
    row-parallel subclass, the text tower the vocab-parallel one (the modules
    keep their parameters; only their class changes)."""
    from fitclip_torch.parallel.sharding_rules import dense_kind

    group, size = grid.model_group, grid.model
    for name, module in model.named_modules():
        kind = dense_kind(f"{name}.weight")
        if kind is None:
            continue
        if type(module) is not Dense:
            raise ValueError(f"tensor parallelism splits float dense layers, and {name} is "
                             f"a {type(module).__name__}")
        module.__class__, module.group = _PARALLEL_DENSE[kind], group
    for tower in (model.visual, model.text):
        for block in tower.transformer.blocks:
            block.attn.heads //= size
    text = model.text
    text.__class__, text.group = VocabParallelTextTransformer, group
    text.vocab_start = grid.model_index * text.token_embedding.shape[0]
    model.tp_grid = grid


def grid_of(encoder) -> Optional[object]:
    """The grid a tensor-parallel encoder (or model) runs on, or None."""
    return getattr(getattr(encoder, "model", encoder), "tp_grid", None)
