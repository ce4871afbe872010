"""One captured CUDA graph per bucket of a tower's encode: the port's
counterpart of the JAX package's one compiled program per bucket
(``fitclip_tpu/serving/batcher.py:5-11``).

``BucketGraphs(encode_fn, item_shape, dtype, bucket_sizes, device)`` holds,
for each bucket, a static input, the graph of ``encode_fn`` on it and its
static output. ``warm()`` runs every bucket eagerly once on the capture
stream, so that what an encode does on its first call (the layers' folded
operands and their ``.item()`` reads, cached constants, library handles and
workspaces) is done before any capture. ``capture()`` records each bucket's
graph in its own memory pool, so that no bucket's intermediates can land on
another's output. A call copies the batch into the bucket's static input and
replays the graph on the caller's stream; the returned static output is
overwritten by the bucket's next replay, so the caller copies what it needs
out on the same stream first (``batcher.py`` does).

A capture that fails raises: there is no eager fallback. Capture runs in
"global" mode, so no other thread may issue CUDA work meanwhile; the embed
service captures every bucket of both towers before it starts any
dispatcher.
"""

import logging
import time
from typing import Callable, Dict, Sequence, Tuple

import torch

LOGGER = logging.getLogger(__name__)


class BucketGraphs:
    def __init__(self, encode_fn: Callable[[torch.Tensor], torch.Tensor],
                 item_shape: Tuple[int, ...], dtype: torch.dtype, bucket_sizes: Sequence[int],
                 device, name: str = "encode"):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}")
        self.encode_fn, self.name = encode_fn, name
        self.bucket_sizes = tuple(int(b) for b in bucket_sizes)
        self._inputs = {b: torch.zeros((b, *item_shape), dtype=dtype, device=self.device)
                        for b in self.bucket_sizes}
        self._graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, torch.Tensor]] = {}
        self.capture_ms: Dict[int, float] = {}
        self._stream = torch.cuda.Stream(self.device)

    @torch.no_grad()
    def warm(self) -> "BucketGraphs":
        """Each bucket's encode once, eagerly, on the capture stream."""
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            for b in self.bucket_sizes:
                self.encode_fn(self._inputs[b])
        self._stream.synchronize()
        return self

    @torch.no_grad()
    def capture(self) -> "BucketGraphs":
        """Capture each bucket not captured yet (after ``warm``)."""
        for b in self.bucket_sizes:
            if b in self._graphs:
                continue
            torch.cuda.synchronize(self.device)
            start = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._stream):
                out = self.encode_fn(self._inputs[b])
            torch.cuda.synchronize(self.device)
            self.capture_ms[b] = 1e3 * (time.perf_counter() - start)
            self._graphs[b] = (graph, out)
            LOGGER.info("captured %s at batch %d in %.1f ms", self.name, b, self.capture_ms[b])
        return self

    def replay(self, bucket: int) -> torch.Tensor:
        """Replay one bucket's graph on the current stream; its static output."""
        graph, out = self._graphs[bucket]
        graph.replay()
        return out

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        """(bucket, *item_shape) on any device -> the bucket's static output,
        valid until the bucket's next replay."""
        bucket = batch.shape[0]
        if bucket not in self._graphs:
            raise KeyError(f"{self.name}: no graph captured for batch {bucket} "
                           f"(buckets {self.bucket_sizes}, captured {sorted(self._graphs)})")
        self._inputs[bucket].copy_(batch, non_blocking=True)
        return self.replay(bucket)
