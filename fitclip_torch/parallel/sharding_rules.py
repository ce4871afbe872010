"""FSDP over the data ranks (port of ``fitclip_tpu/parallel/sharding_rules.py:
fsdp_shardings`` and the ``_spec_for`` it uses on a mesh without a model axis).

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
back a replicated state. Tensor parallelism (``tensor_parallel_shardings``,
``shard_params``) is not ported.
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


def _jax_path(name: str) -> str:
    from fitclip_torch.training.state import jax_param_path

    return jax_param_path(name)


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


def _split_dim(shape: Sequence[int], n: int, min_leaf_size: int) -> Optional[int]:
    """fsdp_shardings' choice on one leaf: the largest dim n divides (the
    first of equals), or None to replicate."""
    if (math.prod(shape) if shape else 1) < min_leaf_size:
        return None
    best = None
    for dim, extent in enumerate(shape):
        if extent % n == 0 and (best is None or extent > shape[best]):
            best = dim
    return best


@dataclasses.dataclass(frozen=True)
class LeafSplit:
    jax_path: str
    jax_dim: int   # the split dim of the JAX leaf (a stacked leaf's layer axis is 0)
    dim: int       # the port parameter's split dim


def fsdp_layout(named: Mapping[str, torch.Tensor], n: int,
                min_leaf_size: int = MIN_LEAF_SIZE) -> Dict[str, Optional[LeafSplit]]:
    """{port parameter name: its LeafSplit, or None where it replicates}, the
    rule applied to each JAX leaf (the port's parameters of one stack together)."""
    if n <= 1:
        raise ValueError(f"FSDP needs more than one rank, got {n}")
    groups: Dict[str, List[str]] = {}
    for name in named:
        groups.setdefault(_jax_path(name), []).append(name)
    layout: Dict[str, Optional[LeafSplit]] = {}
    for path, names in groups.items():
        shape, to_port = jax_layout(names[0], named[names[0]].shape)
        stacked = ".blocks." in names[0]  # a transformer's layers, one JAX leaf
        leaf_shape = ((len(names),) + shape) if stacked else shape
        dim = _split_dim(leaf_shape, n, min_leaf_size)
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

    def __init__(self, state, optimizer, min_leaf_size: int = MIN_LEAF_SIZE):
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        named = state.named_parameters()
        self.optimizer = optimizer
        self.layout = {name: split for name, split in
                       fsdp_layout(named, self.world, min_leaf_size).items() if split}
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
                named[name].data = host_array(self.parts[name], split.dim)
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
        """The norm of the whole gradient: replicated leaves once, the split
        ones' parts summed over ranks."""
        zero = grads[0].new_zeros((), dtype=torch.float32)
        whole, split = zero.clone(), zero.clone()
        for name, g in zip(names, grads):
            square = g.float().square().sum()
            if name in self.layout:
                split += square
            else:
                whole += square
        dist.all_reduce(split)
        return torch.sqrt(whole + split)

    def apply(self, state, grads: Mapping[str, torch.Tensor], optimizer):
        """The optimizer step on each rank's parts (gradients averaged over
        ranks first), then the temperature clamp."""
        from fitclip_torch.training.state import apply_updates_with_clamp

        names = list(grads)
        averaged = dict(zip(names, average_gradients([grads[n] for n in names])))
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
        params = {n: (host_array(self.parts[n], self.layout[n].dim) if n in self.layout
                      else p.detach()) for n, p in named.items()}
        moments = {}
        for key in ("mu", "nu"):
            moments[key] = {n: (host_array(m, self.layout[n].dim)
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


def shard_train_state(state, optimizer, min_leaf_size: int = MIN_LEAF_SIZE):
    """Shard ``state`` in place over the ranks of the process group by the FSDP rule."""
    state.fsdp = ShardedTrainState(state, optimizer, min_leaf_size)
    return state


__all__ = ["MIN_LEAF_SIZE", "LeafSplit", "ShardedTrainState", "fsdp_layout", "jax_layout",
           "shard_train_state"]
