"""Multi-process entry points (port of ``fitclip_tpu/parallel/multihost.py``).

One process per GPU, each running its own rows on its own device, as the
reference's PyTorch Lightning DDP does (SURVEY §2.8). This module holds:

- ``maybe_initialize_distributed``: ``torch.distributed.init_process_group``
  when the run is multi-process, from ``cfg["distributed"]`` or torchrun's
  environment, before any model or loader is built (``cli/main.py:run``);
- ``process_local_rows``: which rows of a global batch this process loads
  (the train loaders feed only their block, so the global batch is the one
  process's batch);
- ``host_array``: every rank's rows of a tensor, gathered to every rank in
  rank order (the eval runners gather the embeddings with it);
- ``is_main_process``: the gate for logging and checkpoint writes;
- ``agree_any``, ``barrier``, ``all_reduce_max``: host-side agreement over a
  gloo group of the same ranks (a flag, a wait, the calibration's abs-max),
  which never touches the device;
- ``local_only``: a context in which the train steps run no collective
  (``command=tune`` runs on every rank as on one device).

``global_batch_from_local`` has no counterpart: a rank holds only its own
rows, and the collectives that span ranks (``parallel/collectives.py``) are
explicit where the JAX package's GSPMD inserts them.
"""

import contextlib
import contextvars
import datetime
import logging
import os
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from fitclip_torch.parallel.mesh import rank_device

LOGGER = logging.getLogger(__name__)

_OWNED = False  # this module initialized the default group (and destroys it)
_HOST_GROUP: Optional[Any] = None  # gloo group of the same ranks, for host-side agreement
# The process's rendezvous store per (host, port) and how many groups it has
# made: each group takes fresh keys under a prefix, so that a later ``run`` in
# the same processes (a sweep's trials) meets no key of an earlier group and
# rebinds no port.
_STORES: Dict[tuple, list] = {}
_LOCAL_ONLY = contextvars.ContextVar("fitclip_local_only", default=False)
INIT_TIMEOUT = datetime.timedelta(minutes=30)  # torch.distributed's default for a group


def _requests_cpu(cfg: Optional[Mapping[str, Any]]) -> bool:
    """True when the run asks for the CPU: ``encoder.device=cpu``, or a
    {student, teacher} slot whose student is on the CPU."""
    encoder = (cfg or {}).get("encoder") or {}
    if isinstance(encoder, Mapping) and "_target_" not in encoder and "student" in encoder:
        encoder = encoder["student"]
    return isinstance(encoder, Mapping) and str(encoder.get("device", "")).startswith("cpu")


def maybe_initialize_distributed(cfg: Optional[Mapping[str, Any]] = None) -> bool:
    """Bring up the process group when configured; True when running on more
    than one process.

    Sources, in priority order:
    1. ``cfg["distributed"] = {coordinator_address, num_processes, process_id}``
       (optional ``local_device_ids``): the rendezvous at
       ``coordinator_address`` (host:port);
    2. torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
       ``MASTER_ADDR``, ``MASTER_PORT``);
    3. a process group the caller already initialized, used as it is.

    The backend is NCCL when the rank's device is CUDA (``cuda:LOCAL_RANK``,
    or ``local_device_ids[0]``, made the current device) and gloo when the
    run asks for the CPU; a caller that wants another backend makes the
    group itself (source 3). A configured init that fails raises: the run
    never goes on as one process."""
    global _OWNED, _HOST_GROUP
    if dist.is_initialized():
        if _HOST_GROUP is None and dist.get_backend() != "gloo":
            _HOST_GROUP = dist.new_group(backend="gloo")
        return dist.get_world_size() > 1
    options = dict((cfg or {}).get("distributed") or {})
    explicit = "coordinator_address" in options
    if not explicit and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return False
    cpu = _requests_cpu(cfg)
    if explicit:
        world, rank = int(options["num_processes"]), int(options["process_id"])
        host, port = str(options["coordinator_address"]).rsplit(":", 1)
        local_ids = options.get("local_device_ids")
        local = (int(local_ids[0]) if local_ids
                 else rank % max(1, torch.cuda.device_count()) if not cpu else 0)
    else:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        host, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
        local = int(os.environ.get("LOCAL_RANK", "0"))
    backend = "gloo" if cpu else "nccl"
    if not cpu:
        torch.cuda.set_device(local)  # raises without the card: no CPU fallback
    dist.init_process_group(backend, store=_rendezvous(host, int(port), world, rank),
                            world_size=world, rank=rank, timeout=INIT_TIMEOUT)
    _OWNED = True
    _HOST_GROUP = None if cpu else dist.new_group(backend="gloo")
    LOGGER.info("Distributed runtime up: process %d/%d on %s (%s)", rank, world,
                rank_device(cpu), backend)
    return world > 1


def _rendezvous(host: str, port: int, world: int, rank: int):
    """A fresh prefix of this process's TCP store at host:port (rank 0 serves
    it, unless torchrun's agent does)."""
    entry = _STORES.get((host, port))
    if entry is None:
        serves = rank == 0 and os.environ.get("TORCHELASTIC_USE_AGENT_STORE") != "True"
        entry = _STORES[(host, port)] = [dist.TCPStore(host, port, world, serves,
                                                       timeout=INIT_TIMEOUT,
                                                       multi_tenant=True), 0]
    entry[1] += 1
    return dist.PrefixStore(f"fitclip/{entry[1]}", entry[0])


def shutdown_distributed() -> None:
    """Destroy the process group if ``maybe_initialize_distributed`` made it
    (a group the caller made stays)."""
    global _OWNED, _HOST_GROUP
    if _OWNED and dist.is_initialized():
        dist.destroy_process_group()
    _OWNED, _HOST_GROUP = False, None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


_rank, _world = process_index, process_count  # process_local_rows' arguments shadow them


def is_main_process() -> bool:
    return process_index() == 0


def collectives_active() -> bool:
    """Whether the train steps and the synced BatchNorm run their collectives:
    a group is up and no ``local_only`` context is open."""
    return dist.is_initialized() and not _LOCAL_ONLY.get()


@contextlib.contextmanager
def local_only() -> Iterator[None]:
    """The train steps and the BatchNorm run as on one device inside."""
    token = _LOCAL_ONLY.set(True)
    try:
        yield
    finally:
        _LOCAL_ONLY.reset(token)


def process_local_rows(n_rows: int, process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> slice:
    """The contiguous row block of a global batch this process loads: global
    batches are laid out [proc0 rows | proc1 rows | ...], the gathers' rank
    order."""
    p = _rank() if process_index is None else process_index
    n = _world() if process_count is None else process_count
    if n_rows % n:
        raise ValueError(f"global batch of {n_rows} rows is not divisible by "
                         f"{n} processes")
    per = n_rows // n
    return slice(p * per, (p + 1) * per)


def host_array(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's part of ``x`` (the same shape on each), concatenated along
    ``dim`` in rank order on every rank of ``group`` (the whole process group
    by default), on ``x``'s device; ``x`` itself without a group."""
    if not dist.is_initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def agree_any(flag: bool) -> bool:
    """True on every rank when any rank passes True (a host-side all-reduce)."""
    if not dist.is_initialized():
        return bool(flag)
    value = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(value, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(value.item())


def barrier() -> None:
    """Every rank waits here for the others (host side); nothing without a group."""
    if dist.is_initialized():
        dist.barrier(group=_HOST_GROUP)


def all_reduce_max(arrays: Optional[Dict[str, np.ndarray]]) -> Optional[Dict[str, np.ndarray]]:
    """The elementwise max over ranks of a dict of float arrays (each rank's
    keys and shapes the same), on the host; the dict itself without a group."""
    if arrays is None or not dist.is_initialized():
        return arrays
    out = {}
    for key in sorted(arrays):
        value = torch.from_numpy(np.ascontiguousarray(arrays[key], np.float32)).clone()
        dist.all_reduce(value, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
        out[key] = value.numpy()
    return out
