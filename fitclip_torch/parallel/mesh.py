"""The eval batch's pad and the rank's device (port of
``fitclip_tpu/parallel/mesh.py``).

The JAX package places one global batch on a device mesh; here each process
runs one device, so ``create_mesh``, ``sharded_along``, ``replicated``,
``shard_batch`` and ``shard_map_compat`` have no counterpart: a rank takes
its row block of the padded batch (``multihost.process_local_rows``) and the
collectives are explicit (``parallel/collectives.py``).
"""

from typing import Any, Tuple

import numpy as np
import torch
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
