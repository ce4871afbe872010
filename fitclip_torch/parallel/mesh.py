"""The eval batch's pad, the rank's device and the (data, model) grid of
ranks (port of ``fitclip_tpu/parallel/mesh.py``).

The JAX package places one global batch on a device mesh; here each process
runs one device, so ``sharded_along``, ``replicated``, ``shard_batch`` and
``shard_map_compat`` have no counterpart: a rank takes its row block of the
padded batch (``multihost.process_local_rows``) and the collectives are
explicit (``parallel/collectives.py``). The 2-D ``create_mesh(devices.reshape(
data, model), ("data", "model"))`` of tensor parallelism is ``create_grid``:
one process group for each data row (the ranks that split one model) and one
for each model column (the ranks that split the batch).
"""

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


def pad_batch_to_divisible(batch: Any, num_shards: int) -> Tuple[Any, int]:
    """Right-pad every leading dim with zeros to a multiple of ``num_shards``;
    returns the padded tree and the original length of its first leaf (for
    dropping the pad rows)."""
    def pad(x):
        n = x.shape[0]
        target = -(-n // num_shards) * num_shards
        if target == n:
            return x
        widths = [(0, target - n)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), widths)

    first = next(leaf for leaf in pytree.tree_leaves(batch) if leaf is not None)
    return pytree.tree_map(lambda x: None if x is None else pad(x), batch), first.shape[0]


def rank_device(cpu: bool = False) -> torch.device:
    """This rank's device: the CPU when asked, else the current CUDA device,
    which ``maybe_initialize_distributed`` sets to ``cuda:LOCAL_RANK``."""
    return torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place on a (data, model) grid of the process group's ranks,
    laid out row-major as JAX's ``devices.reshape(data, model)``: rank
    ``d * model + m`` holds data row ``d`` and model column ``m``."""
    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Any    # the ranks of this model column: they split the batch
    model_group: Any   # the ranks of this data row: they split one model
    data_ranks: Tuple[int, ...]
    model_ranks: Tuple[int, ...]


def create_grid(data: int, model: int) -> Grid:
    """The (data, model) grid over the ranks of the process group; every rank
    calls it (it makes every row's and column's group, in one order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if data < 1 or model < 1 or data * model != world:
        raise ValueError(f"a ({data}, {model}) grid needs {data * model} ranks, "
                         f"the process group has {world}")
    rows: List[Tuple[int, ...]] = [tuple(d * model + m for m in range(model))
                                   for d in range(data)]
    columns: List[Tuple[int, ...]] = [tuple(d * model + m for d in range(data))
                                      for m in range(model)]
    row_groups = [dist.new_group(list(r)) for r in rows]
    column_groups = [dist.new_group(list(c)) for c in columns]
    d, m = divmod(rank, model)
    return Grid(data, model, d, m, column_groups[m], row_groups[d], columns[m], rows[d])
