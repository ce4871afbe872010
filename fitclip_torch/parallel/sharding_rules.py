"""Tensor parallelism's layout and FSDP over the data ranks (port of
``fitclip_tpu/parallel/sharding_rules.py``: ``_RULES``, ``_spec_for``,
``tensor_parallel_shardings``, ``shard_params`` and ``fsdp_shardings``).

Tensor parallelism: ``_RULES`` is JAX's Megatron layout, read on each port
parameter's JAX path and leaf layout (below): column-parallel ``in_proj`` and
``mlp_fc`` with their biases, row-parallel ``out_proj`` and ``mlp_proj``,
vocab-parallel ``token_embedding``. ``tensor_parallel_shardings`` gives each
split parameter's port dim; ``shard_params`` keeps each rank's part of them on
a grid (``mesh.create_grid``) and switches the model to the operators of
``tensor_parallel.py``. One part differs from JAX's: GSPMD keeps a contiguous
slab of the packed (3W) QKV output and re-lays the activations itself, while
the attention kernels here need whole heads of Q, K and V, so each rank keeps
its heads' slice of each third (``qkv_part``). Compare gathered weights, not
parts.

The rule is the JAX package's, read on the JAX layout of each leaf: a leaf of
at least ``min_leaf_size`` elements is split over the N ranks on its largest
dim that N divides (the first of equals); a smaller leaf, or one with no such
dim, replicates. The port keeps a transformer's layers apart and its dense
weights as (out, in), so each port parameter is named by its JAX path
(``training/state.py:jax_param_path``) and laid out as JAX's leaf: the layers
of a stack counted on a leading dim, a dense ``kernel`` transposed, a conv
kernel HWIO, the ViT patch embedding's (p·p·3, width) kernel flattened from
the port's (width, 3, p, p) conv. The dim the rule picks maps back to a port
dim, along which the rank keeps its contiguous 1/N.

``ShardedTrainState`` holds a TrainState so: each rank keeps its part of
every split parameter and of both its AdamW moments (a frozen leaf's moment
is a 0-dim placeholder, and replicates). The module's split parameters are
empty between steps. A step gathers them whole (``gathered``), runs the
forward and backward as without FSDP, all-reduces the gradients (gloo has no
reduce-scatter; a rank keeps its part of each split one), and AdamW updates
each rank's parts, the global-norm clip summing the parts' squares over
ranks. A checkpoint is written whole (``full_tensors``); ``unshard`` gives
back a replicated state.

FSDP composes with tensor parallelism as ``fsdp_shardings`` does on a mesh
with a model axis: a leaf takes its TP split first, and the data split goes
on the largest remaining dim of the whole leaf that the data ranks divide
(the Megatron + ZeRO 2-D layout). A sharded state on a grid gathers and
all-reduces over the grid's data group, and the clip's norm sums each leaf's
squares over the ranks that split it: the model group, the data group, or
all ranks for a leaf split on both axes.
"""

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from fitclip_torch.parallel.collectives import average_gradients
from fitclip_torch.parallel.multihost import host_array

MIN_LEAF_SIZE = 4096
MODEL_AXIS = "model"

# (path suffix, the spec of the trailing dims of the JAX leaf): first match
# wins; leading (layer) dims stay whole. fitclip_tpu/parallel/sharding_rules.py:22.
_RULES = [
    ("attn/in_proj/kernel", ("replicated", MODEL_AXIS)),   # column parallel
    ("attn/in_proj/bias", (MODEL_AXIS,)),
    ("attn/out_proj/kernel", (MODEL_AXIS, "replicated")),  # row parallel
    ("mlp_fc/kernel", ("replicated", MODEL_AXIS)),
    ("mlp_fc/bias", (MODEL_AXIS,)),
    ("mlp_proj/kernel", (MODEL_AXIS, "replicated")),
    ("token_embedding", (MODEL_AXIS, "replicated")),       # vocab parallel
]
# The packed QKV projection's leaves: a rank keeps its heads' slice of each of
# the Q, K and V thirds of the split dim (``qkv_part``), not one contiguous
# block of it.
_PACKED_QKV = ("attn/in_proj/kernel", "attn/in_proj/bias")


def _spec_for(path_str: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The JAX leaf's partition spec, one axis name or None per dim."""
    for suffix, trailing in _RULES:
        if path_str.endswith(suffix):
            axes = [None if axis == "replicated" else axis for axis in trailing]
            if len(axes) > ndim:
                break
            return tuple([None] * (ndim - len(axes)) + axes)
    return (None,) * ndim


def _jax_path(name: str) -> str:
    from fitclip_torch.training.state import jax_param_path

    return jax_param_path(name)


def dense_kind(name: str) -> Optional[str]:
    """"column" or "row" for a dense layer's weight that ``_RULES`` splits on
    its output or its input features (the JAX kernel is (in, out)), else None."""
    spec = _spec_for(_jax_path(name), 2)
    if spec[1] == MODEL_AXIS:
        return "column"
    return "row" if spec[0] == MODEL_AXIS else None


def jax_layout(name: str, shape: Sequence[int]) -> Tuple[Tuple[int, ...], List[Optional[int]]]:
    """(the JAX leaf's shape for one layer, and for each of its dims the port
    dim it maps to) of a port parameter. The ViT patch embedding's flattened
    input dim maps to the conv's kernel rows (kh), its outermost factor."""
    shape = tuple(int(s) for s in shape)
    path = _jax_path(name)
    if not path.endswith("/kernel") or len(shape) not in (2, 4):
        return shape, list(range(len(shape)))
    if len(shape) == 2:
        return (shape[1], shape[0]), [1, 0]
    if path.endswith("patch_embed/kernel"):  # (width, 3, p, p) -> (p * p * 3, width)
        return (shape[2] * shape[3] * shape[1], shape[0]), [2, 0]
    return (shape[2], shape[3], shape[1], shape[0]), [2, 3, 1, 0]  # OIHW -> HWIO


def tensor_parallel_shardings(named: Mapping[str, torch.Tensor]) -> Dict[str, Optional[int]]:
    """{port parameter name: the port dim its model-axis split runs along, or
    None where it replicates} (JAX's NamedShardings of the CLIP tree)."""
    out: Dict[str, Optional[int]] = {}
    for name, tensor in named.items():
        shape, to_port = jax_layout(name, tensor.shape)
        spec = _spec_for(_jax_path(name), len(shape))
        out[name] = next((to_port[d] for d, axis in enumerate(spec) if axis == MODEL_AXIS),
                         None)
    return out


def qkv_part(tensor: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """The rank's heads of a packed (3W, ...) in_proj weight or bias: its
    slice of each of the Q, K and V thirds, concatenated."""
    return torch.cat([third.chunk(size, 0)[rank] for third in tensor.chunk(3, 0)])


def tensor_parallel_part(name: str, tensor: torch.Tensor, dim: int, rank: int,
                         size: int) -> torch.Tensor:
    """The rank's part of a whole parameter under its TP split."""
    if _jax_path(name).endswith(_PACKED_QKV):
        return qkv_part(tensor, rank, size).contiguous()
    return tensor.chunk(size, dim)[rank].contiguous()


def tensor_parallel_whole(name: str, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The whole parameter from every rank's part, in rank order (the inverse
    of ``tensor_parallel_part``)."""
    if _jax_path(name).endswith(_PACKED_QKV):
        thirds = [part.chunk(3, 0) for part in parts]
        return torch.cat([torch.cat([t[i] for t in thirds]) for i in range(3)])
    return torch.cat(list(parts), dim)


def shard_params(encoder, grid) -> Dict[str, Optional[int]]:
    """Tensor parallelism on ``grid``, in place: the encoder's (or CLIPModel's)
    split parameters keep this rank's part and the model runs the operators of
    ``tensor_parallel.py``. Returns ``tensor_parallel_shardings`` of the
    model's parameters. Heads, the vocabulary and the MLP width must divide by
    the model size (ValueError); the fused int8 and bf16 paths are refused."""
    from fitclip_torch.parallel.tensor_parallel import parallelize_clip_model, refuse_fused_paths

    refuse_fused_paths(encoder)
    model = getattr(encoder, "model", encoder)
    size = grid.model
    if getattr(model, "tp_grid", None) is not None:
        raise ValueError("the model is tensor-parallel already")
    for tower in (model.visual, model.text):
        heads = tower.config.heads
        if heads % size:
            raise ValueError(f"{heads} attention heads are not divisible by the model size {size}")
    vocab = model.text.config.vocab_size
    if vocab % size:
        raise ValueError(f"a vocabulary of {vocab} is not divisible by the model size {size}")
    named = dict(model.named_parameters())
    layout = tensor_parallel_shardings(named)
    with torch.no_grad():
        for name, dim in layout.items():
            if dim is not None:
                if named[name].shape[dim] % size:
                    raise ValueError(f"{name} {tuple(named[name].shape)} is not divisible "
                                     f"by the model size {size} along dim {dim}")
                named[name].data = tensor_parallel_part(name, named[name].detach(), dim,
                                                        grid.model_index, size)
    parallelize_clip_model(model, grid)
    return layout


def gathered_params(model, parts: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """A tensor-parallel model's parameters whole, on every rank of its model
    group (a collective); or ``parts``, tensors named and laid out as the
    rank's parameters (their gradients), whole."""
    grid = model.tp_grid
    out = {}
    named = dict(model.named_parameters()) if parts is None else parts
    for name, tensor in named.items():
        dim = tensor_parallel_shardings({name: tensor})[name]
        if dim is None:
            out[name] = tensor.detach()
        else:
            parts = [torch.empty_like(tensor) for _ in range(grid.model)]
            dist.all_gather(parts, tensor.detach().contiguous(), group=grid.model_group)
            out[name] = tensor_parallel_whole(name, parts, dim)
    return out


def _split_dim(shape: Sequence[int], n: int, min_leaf_size: int,
               taken: Sequence[bool] = ()) -> Optional[int]:
    """fsdp_shardings' choice on one leaf: the largest dim n divides (the
    first of equals) among those not ``taken`` by the TP split, or None to
    replicate."""
    if (math.prod(shape) if shape else 1) < min_leaf_size:
        return None
    best = None
    for dim, extent in enumerate(shape):
        if dim < len(taken) and taken[dim]:
            continue
        if extent % n == 0 and (best is None or extent > shape[best]):
            best = dim
    return best


@dataclasses.dataclass(frozen=True)
class LeafSplit:
    jax_path: str
    jax_dim: int   # the split dim of the JAX leaf (a stacked leaf's layer axis is 0)
    dim: int       # the port parameter's split dim


def fsdp_layout(named: Mapping[str, torch.Tensor], n: int,
                min_leaf_size: int = MIN_LEAF_SIZE,
                model_size: int = 1) -> Dict[str, Optional[LeafSplit]]:
    """{port parameter name: its LeafSplit, or None where it replicates}, the
    rule applied to each JAX leaf (the port's parameters of one stack together).
    With ``model_size`` > 1 the parameters are a tensor-parallel rank's parts:
    the rule reads each whole leaf and skips its TP dim."""
    if n <= 1:
        raise ValueError(f"FSDP needs more than one rank, got {n}")
    groups: Dict[str, List[str]] = {}
    for name in named:
        groups.setdefault(_jax_path(name), []).append(name)
    tp = tensor_parallel_shardings(named) if model_size > 1 else {}
    layout: Dict[str, Optional[LeafSplit]] = {}
    for path, names in groups.items():
        shape, to_port = jax_layout(names[0], named[names[0]].shape)
        tp_dim = tp.get(names[0])
        taken = [to_port[d] == tp_dim for d in range(len(shape))] if tp_dim is not None \
            else [False] * len(shape)
        shape = tuple(extent * model_size if hit else extent for extent, hit in zip(shape, taken))
        stacked = ".blocks." in names[0]  # a transformer's layers, one JAX leaf
        leaf_shape = ((len(names),) + shape) if stacked else shape
        taken = ([False] if stacked else []) + taken
        dim = _split_dim(leaf_shape, n, min_leaf_size, taken)
        if dim is not None and stacked and dim == 0:
            raise NotImplementedError(f"the FSDP rule splits {path} on its layer axis")
        port_dim = None if dim is None else to_port[dim - stacked]
        if port_dim is not None and names[0].endswith("patch_embed.weight") \
                and named[names[0]].shape[2] % n:
            raise NotImplementedError(f"{path}: {n} ranks do not divide the patch size")
        for name in names:
            layout[name] = None if dim is None else LeafSplit(path, dim, port_dim)
    return layout


def _chunk(tensor: torch.Tensor, split: LeafSplit, rank: int, world: int) -> torch.Tensor:
    return tensor.detach().chunk(world, split.dim)[rank].contiguous()


class ShardedTrainState:
    """The FSDP side of a TrainState (``state.fsdp``); see the module docstring."""

    def __init__(self, state, optimizer, min_leaf_size: int = MIN_LEAF_SIZE, grid=None):
        # On a tensor-parallel grid the data group splits; else every rank.
        self.grid = grid
        self.group = None if grid is None else grid.data_group
        self.world, self.rank = dist.get_world_size(self.group), dist.get_rank(self.group)
        named = state.named_parameters()
        self.optimizer = optimizer
        self.tp = ({n: d for n, d in tensor_parallel_shardings(named).items() if d is not None}
                   if grid is not None else {})
        self.layout = {name: split for name, split in fsdp_layout(
            named, self.world, min_leaf_size, grid.model if grid else 1).items() if split}
        self.parts: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for name, split in self.layout.items():
                self.parts[name] = _chunk(named[name], split, self.rank, self.world)
                for key in ("mu", "nu"):
                    moment = state.opt_state[key][name]
                    if moment.dim():
                        state.opt_state[key][name] = _chunk(moment, split, self.rank,
                                                            self.world)
        self._release(state)

    def _release(self, state) -> None:
        named = state.named_parameters()
        for name in self.layout:
            named[name].data = torch.empty(0, dtype=named[name].dtype,
                                           device=named[name].device)

    @contextlib.contextmanager
    def gathered(self, state) -> Iterator[None]:
        """The split parameters whole in the module inside; on exit a parameter
        the optimizer does not update (a BatchNorm's running statistic, a
        frozen leaf) keeps its part of what the step wrote, and the module's
        copies are released."""
        named = state.named_parameters()
        with torch.no_grad():
            for name, split in self.layout.items():
                named[name].data = host_array(self.parts[name], split.dim, self.group)
        try:
            yield
        finally:
            with torch.no_grad():
                for name, split in self.layout.items():
                    if not self.optimizer.trainable(name):
                        self.parts[name].copy_(_chunk(named[name], split, self.rank,
                                                      self.world))
            self._release(state)

    def _global_norm(self, names: Sequence[str], grads: Sequence[torch.Tensor]):
        """The norm of the whole gradient: each leaf's squares summed over the
        ranks that split it (data, model or both axes), a replicated leaf's once."""
        return split_global_norm(names, grads, lambda n: (n in self.layout, n in self.tp),
                                 self.grid)

    def apply(self, state, grads: Mapping[str, torch.Tensor], optimizer):
        """The optimizer step on each rank's parts (gradients averaged over
        ranks first), then the temperature clamp."""
        from fitclip_torch.training.state import apply_updates_with_clamp

        names = list(grads)
        averaged = dict(zip(names, average_gradients([grads[n] for n in names], self.group)))
        named = dict(state.named_parameters())
        for name, split in self.layout.items():
            if name in averaged:
                averaged[name] = _chunk(averaged[name], split, self.rank, self.world)
            named[name] = self.parts[name]
        return apply_updates_with_clamp(state, averaged, optimizer, named=named,
                                        norm_fn=self._global_norm)

    def held_bytes(self, state) -> Dict[str, int]:
        """The bytes this rank holds of the parameters and of both moments."""
        named = state.named_parameters()
        params = sum((self.parts[n] if n in self.layout else p).numel()
                     * p.element_size() for n, p in named.items())
        moments = sum(m.numel() * m.element_size() for key in ("mu", "nu")
                      for m in state.opt_state[key].values())
        return {"params": params, "moments": moments}

    def full_tensors(self, state) -> Tuple[Dict[str, torch.Tensor], Dict[str, Dict]]:
        """(params, {"mu", "nu"}) whole, gathered on every rank (a collective)."""
        named = state.named_parameters()
        params = {n: (host_array(self.parts[n], self.layout[n].dim, self.group)
                      if n in self.layout else p.detach()) for n, p in named.items()}
        moments = {}
        for key in ("mu", "nu"):
            moments[key] = {n: (host_array(m, self.layout[n].dim, self.group)
                                if n in self.layout and m.dim() else m)
                            for n, m in state.opt_state[key].items()}
        return params, moments

    def unshard(self, state):
        """The state replicated again: whole parameters in the module and whole
        moments; ``state.fsdp`` cleared."""
        params, moments = self.full_tensors(state)
        named = state.named_parameters()
        with torch.no_grad():
            for name in self.layout:
                named[name].data = params[name]
        for key in ("mu", "nu"):
            state.opt_state[key].update(moments[key])
        state.fsdp = None
        return state


def split_global_norm(names: Sequence[str], grads: Sequence[torch.Tensor], split_of,
                      grid=None) -> torch.Tensor:
    """The global norm of gradients that are parts: ``split_of(name)`` gives
    (split over the data ranks, split over the model ranks) of a leaf, whose
    squares are then summed over those ranks (a leaf split on both axes over
    all of them); a replicated leaf counts once. Without a grid a data split
    spans the whole process group."""
    sums: Dict[Tuple[bool, bool], torch.Tensor] = {}
    for name, g in zip(names, grads):
        key = tuple(split_of(name))
        square = g.float().square().sum()
        sums[key] = sums[key] + square if key in sums else square
    total = grads[0].new_zeros((), dtype=torch.float32)
    for key in sorted(sums):  # one order on every rank
        by_data, by_model = key
        if by_data and (by_model or grid is None):
            dist.all_reduce(sums[key])
        elif by_data:
            dist.all_reduce(sums[key], group=grid.data_group)
        elif by_model:
            dist.all_reduce(sums[key], group=grid.model_group)
        total = total + sums[key]
    return torch.sqrt(total)


def shard_train_state(state, optimizer, min_leaf_size: int = MIN_LEAF_SIZE, grid=None):
    """Shard ``state`` in place by the FSDP rule over the ranks of the process
    group, or over the data group of a tensor-parallel ``grid``."""
    state.fsdp = ShardedTrainState(state, optimizer, min_leaf_size, grid)
    return state


__all__ = ["MIN_LEAF_SIZE", "LeafSplit", "ShardedTrainState", "dense_kind", "fsdp_layout",
           "jax_layout", "gathered_params", "shard_params", "shard_train_state", "split_global_norm",
           "tensor_parallel_shardings"]
