"""Distribution over several processes, one per GPU (port of
``fitclip_tpu/parallel/``): the process group, the per-rank row blocks, the
gathers the global-batch loss differentiates through, the FSDP rule, tensor
parallelism and the GPipe pipeline.

The JAX package partitions one global program over a mesh (GSPMD); here each
process runs its own rows on its own device and the collectives are explicit:
``multihost`` (init, row blocks, gathers, host-side agreement), ``mesh`` (the
pad of an eval batch, the rank's device, the (data, model) grid of ranks),
``collectives`` (the differentiable gather and all-reduce of the train steps
and the synced BatchNorm, the gradient average), ``sharding_rules`` (the
Megatron layout, the FSDP rule and the sharded train state),
``tensor_parallel`` (Megatron's operators and the CLIP model's switch to
them) and ``pipeline`` (GPipe over stages of layers).
"""

from fitclip_torch.parallel.mesh import pad_batch_to_divisible, rank_device
from fitclip_torch.parallel.multihost import (host_array, is_main_process,
                                              maybe_initialize_distributed,
                                              process_count, process_index,
                                              process_local_rows)

__all__ = ["host_array", "is_main_process", "maybe_initialize_distributed",
           "pad_batch_to_divisible", "process_count", "process_index",
           "process_local_rows", "rank_device"]
