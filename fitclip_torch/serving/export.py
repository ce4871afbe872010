"""Deployment artifacts for the embed service: each tower of an encoder as a
``torch.export`` program (port of ``fitclip_tpu/serving/export.py``).

``export_encode_fn`` writes one ``{name}.pt2`` per tower, whose batch axis is
a ``torch.export.Dim`` bounded by the largest bucket, and a ``{name}.json``
that lists the bucket sizes; ``load_exported`` loads them back. The artifact
pins the program a deployment serves: its graph holds the ``fitclip::``
operators (``_build.define_op``), never the plain versions traced through, and
loading it needs only those operators (``import fitclip_torch.ops``), no model
code.

Weights: the JAX package writes its parameter tree once per directory, beside
weight-free programs. Here the folded int8 operands and their scalars are
constants of the program: the encode runs once eagerly on the real weights
(so that every layer folds its operands, ``.item()`` included, as
``serving/graphs.py:BucketGraphs.warm`` does), then the trace lifts each
tensor the encode reads, and only those, into the program. A tower's weights
are stored once, whatever the number of buckets; the other tower's are not in
its file.

``enable_compilation_cache`` and ``disable_compilation_cache`` have no
counterpart: the CUDA kernels build once into ``build/fitclip_torch/<hash>/``
(``_build.py``), and a later process loads the library built there.
"""

import json
import os
from typing import Callable, Dict, Sequence, Tuple

import torch

from fitclip_torch.utils.precision import fp32_convolutions


class _Tower(torch.nn.Module):
    """A tower's encode as the root of the trace. It registers no module of the
    encoder, so the tensors the encode reads are lifted as constants, not the
    encoder's whole state (the other tower's weights, the unfolded ones)."""

    def __init__(self, encode_fn: Callable[[torch.Tensor], torch.Tensor]):
        super().__init__()
        self._encode = (encode_fn,)

    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        return self._encode[0](batch)


def _paths(directory: str, name: str) -> Tuple[str, str]:
    return os.path.join(directory, f"{name}.pt2"), os.path.join(directory, f"{name}.json")


def export_encode_fn(encode_fn: Callable[[torch.Tensor], torch.Tensor],
                     example_item: torch.Tensor, bucket_sizes: Sequence[int],
                     directory: str, name: str) -> Dict[int, str]:
    """Export ``encode_fn`` (a batch ``(B,) + item_shape`` on the encoder's
    device -> rows) for batch sizes 1 to the largest bucket, as
    ``{directory}/{name}.pt2`` with ``{name}.json`` listing ``bucket_sizes``.
    ``example_item`` is one input row (no batch axis) on that device, fixing
    shape and dtype. Returns {bucket_size: artifact_path}."""
    buckets = sorted({int(b) for b in bucket_sizes})
    if not buckets or buckets[0] < 1:
        raise ValueError(f"bucket sizes must be positive, got {list(bucket_sizes)}")
    largest = buckets[-1]
    example = example_item.unsqueeze(0).expand(largest, *example_item.shape).contiguous()
    dynamic = ({0: torch.export.Dim("batch", min=1, max=largest)},) if largest > 1 else None
    with torch.no_grad():
        encode_fn(example)  # fold every operand on the real weights before the trace
        program = torch.export.export(_Tower(encode_fn), (example,), dynamic_shapes=dynamic,
                                      strict=False)
    os.makedirs(directory, exist_ok=True)
    path, manifest = _paths(directory, name)
    torch.export.save(program, path)
    with open(manifest, "w") as f:
        json.dump({"buckets": buckets, "item_shape": list(example_item.shape),
                   "dtype": str(example_item.dtype).replace("torch.", "")}, f)
    return {b: path for b in buckets}


def load_exported(directory: str, name: str) -> Tuple[Callable, Dict[int, Callable]]:
    """Load ``{name}.pt2`` and its bucket list from ``directory``.

    Returns (encode_fn, per_bucket): ``per_bucket`` holds exactly the exported
    sizes, each served by the one program; ``encode_fn(batch)`` checks
    ``batch.shape[0]`` against them and raises ValueError for a size that was
    not exported. Raises FileNotFoundError when the directory holds no
    artifact of ``name``."""
    path, manifest = _paths(directory, name)
    if not (os.path.isfile(path) and os.path.isfile(manifest)):
        raise FileNotFoundError(f"no {name}.pt2 and {name}.json artifacts in {directory}")
    import fitclip_torch.ops  # noqa: F401  registers the fitclip:: operators

    with open(manifest) as f:
        buckets = [int(b) for b in json.load(f)["buckets"]]
    program = torch.export.load(path).module()

    def encode_fn(batch: torch.Tensor) -> torch.Tensor:
        if int(batch.shape[0]) not in buckets:
            raise ValueError(f"no exported program for batch size {batch.shape[0]}; "
                             f"available buckets: {buckets}")
        # The eager towers run their float32 convolutions in full float32
        # (fp32_convolutions); a program records no such setting.
        with torch.no_grad(), fp32_convolutions():
            return program(batch)

    return encode_fn, {b: encode_fn for b in buckets}
