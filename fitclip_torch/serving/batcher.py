"""Dynamic-batching server for encode functions (port of
``fitclip_tpu/serving/batcher.py``).

- **Static shape buckets.** The batcher never calls the encode function at an
  arbitrary batch size: it pads every coalesced batch up to the next size in
  ``bucket_sizes``, so the encode function sees ``len(bucket_sizes)`` shapes
  for the server's lifetime. On the card each shape is one captured CUDA
  graph (``graphs.py``), as the JAX package compiles one program per bucket.
- **One dispatcher thread.** Callers enqueue (item, Future) pairs; the
  dispatcher drains the queue, stacks up to the largest bucket of items,
  waiting at most ``max_wait_ms`` for stragglers once it holds the first one,
  runs ONE encode call, and resolves each Future with its row. Padding rows
  are never copied back, so callers never observe them.
- **Fetch/dispatch overlap.** The dispatcher only *issues* the batch. On a
  CUDA device it runs on a stream of its own: the batch is staged in pinned
  memory, and the real rows of the result are copied back on that stream into
  pinned memory, with an event, before the next encode call is issued (so an
  encode function may return a buffer that its next call overwrites, as a
  graph's static output is). The fetcher pool waits on the event and fans the
  rows out while the next batch runs.
- **Bounded queue = backpressure.** When the queue is full, ``submit``
  raises ``ServerOverloaded`` instead of buffering unboundedly; a serving
  frontend maps that to HTTP 503.

The server is generic over the encode function: a tensor (bucket, *item_shape)
in, a tensor (bucket, ...) out, on the server's device.
"""
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


class ServerOverloaded(RuntimeError):
    """Raised by submit() when the request queue is full (backpressure)."""


class ServerClosed(RuntimeError):
    """Raised by submit() after stop() has begun."""


@dataclass
class ServerStats:
    """Counters the dispatcher maintains; read them for monitoring."""
    requests: int = 0
    batches: int = 0
    rows_padded: int = 0
    rejected: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    @property
    def mean_batch_fill(self) -> float:
        """Real rows / (real + padding rows) across all dispatched batches."""
        real = self.requests - self.rejected
        total = real + self.rows_padded
        return real / total if total else 0.0


class BatchServer:
    """Coalesce single-item encode requests into bucket-padded encode calls.

    encode_fn: tensor (batch, *item_shape) -> tensor whose leading dim matches.
    item_shape: shape of ONE request item (e.g. (77,) for CLIP token ids).
    dtype: the items' numpy dtype.
    bucket_sizes: ascending batch sizes the encode function may see. The
        largest is the max batch per call.
    max_wait_ms: after the first item of a batch arrives, how long the
        dispatcher waits for more before dispatching a partial batch.
        0 disables coalescing-by-time (still coalesces whatever is queued).
    queue_size: max undispatched requests before submit() rejects.
    pad_value: fill for padding rows (harmless: they are never copied back).
    device: where encode_fn runs; a CUDA device gives the dispatcher its own
        stream and the pinned staging described above.
    """

    def __init__(self, encode_fn: Callable, item_shape: Tuple[int, ...], dtype=np.float32,
                 bucket_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 max_wait_ms: float = 2.0, queue_size: int = 1024,
                 pad_value=0, fetch_workers: int = 2, device="cpu"):
        if list(bucket_sizes) != sorted(set(bucket_sizes)) or not bucket_sizes:
            raise ValueError("bucket_sizes must be ascending and non-empty")
        self._encode = encode_fn
        self._item_shape = tuple(item_shape)
        self._dtype = np.dtype(dtype)
        self._buckets = tuple(int(b) for b in bucket_sizes)
        self._max_wait = max_wait_ms / 1e3
        self._pad_value = pad_value
        self._fetch_workers = max(1, int(fetch_workers))
        self._device = torch.device(device)
        # Bounds batches in flight on the device (dispatched, not yet
        # fetched) so the dispatcher can't run away with device memory.
        self._inflight = threading.BoundedSemaphore(self._fetch_workers * 2)
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fetch_pool = None
        self.stats = ServerStats()

    # -- lifecycle ---------------------------------------------------------
    def start(self, warmup: bool = True) -> "BatchServer":
        """Start the dispatcher; optionally run every bucket once first so no
        live request pays a first call's set-up."""
        if self._thread is not None:
            raise RuntimeError("already started")
        if warmup:
            for b in self._buckets:
                zeros = np.full((b,) + self._item_shape, self._pad_value, self._dtype)
                self._encode(torch.from_numpy(zeros)).cpu()
        self._fetch_pool = ThreadPoolExecutor(max_workers=self._fetch_workers,
                                              thread_name_prefix="batch-fetch")
        self._thread = threading.Thread(target=self._run, name="batch-server", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Reject new submits; by default finish everything queued."""
        self._closed.set()
        if self._thread is None:
            return
        if not drain:
            try:
                while True:
                    _, fut = self._queue.get_nowait()
                    fut.set_exception(ServerClosed("server stopped"))
            except queue.Empty:
                pass
        self._queue.put(None)  # sentinel wakes the dispatcher to exit
        self._thread.join()
        self._thread = None
        if self._fetch_pool is not None:
            self._fetch_pool.shutdown(wait=True)  # flush in-flight fetches
            self._fetch_pool = None

    def __enter__(self) -> "BatchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path ------------------------------------------------------
    def submit(self, item) -> Future:
        """Enqueue one item; returns a Future resolving to its output row."""
        if self._closed.is_set():
            raise ServerClosed("server stopped")
        arr = np.asarray(item, self._dtype)
        if arr.shape != self._item_shape:
            raise ValueError(f"item shape {arr.shape} != server shape {self._item_shape}")
        fut: Future = Future()
        try:
            self._queue.put_nowait((arr, fut))
        except queue.Full:
            with self.stats._lock:
                self.stats.rejected += 1
                self.stats.requests += 1
            raise ServerOverloaded(f"queue full ({self._queue.maxsize} pending)") from None
        with self.stats._lock:
            self.stats.requests += 1
        return fut

    def embed(self, item):
        """Blocking convenience: submit + wait."""
        return self.submit(item).result()

    # -- dispatcher --------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _collect(self):
        """Block for the first request, then soak stragglers for at most
        max_wait_ms (or until the max bucket is full). None = shutdown."""
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        t_end = time.monotonic() + self._max_wait
        while len(batch) < self._buckets[-1]:
            remaining = t_end - time.monotonic()
            try:
                nxt = (self._queue.get_nowait() if remaining <= 0
                       else self._queue.get(timeout=remaining))
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-post for the outer loop
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        cuda = self._device.type == "cuda"
        if cuda:
            torch.cuda.set_stream(torch.cuda.Stream(self._device))
        while True:
            batch = self._collect()
            if batch is None:
                return
            n = len(batch)
            bucket = self._bucket_for(n)
            items = np.full((bucket,) + self._item_shape, self._pad_value, self._dtype)
            items[:n] = np.stack([arr for arr, _ in batch])
            items = torch.from_numpy(items)
            self._inflight.acquire()
            try:
                if cuda:
                    items = items.pin_memory()
                out = self._encode(items)
                ready = None
                if out.device.type == "cuda":
                    # The real rows only, copied back on this stream before the
                    # next encode call may overwrite ``out``.
                    host = torch.empty(out[:n].shape, dtype=out.dtype, pin_memory=True)
                    host.copy_(out[:n], non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record()
                    out = host
            except Exception as exc:  # fan the failure out, keep serving
                self._inflight.release()
                for _, fut in batch:
                    fut.set_exception(exc)
                continue
            self._fetch_pool.submit(self._fetch_and_resolve, out, ready, batch, bucket - n)

    def _fetch_and_resolve(self, out, ready, batch, padded: int) -> None:
        try:
            if ready is not None:
                ready.synchronize()
            rows = out[:len(batch)].numpy()
        except Exception as exc:  # deferred device error surfaces here
            for _, fut in batch:
                fut.set_exception(exc)
            return
        finally:
            self._inflight.release()
        with self.stats._lock:
            self.stats.batches += 1
            self.stats.rows_padded += padded
        for i, (_, fut) in enumerate(batch):
            fut.set_result(rows[i])
