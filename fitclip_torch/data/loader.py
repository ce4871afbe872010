"""Host data loader (port of ``fitclip_tpu/data/loader.py``): threaded decode and
prefetch feeding the device.

Replaces torch DataLoader worker processes (the reference's process boundary,
SURVEY §3.1) with a thread pool — cv2/FFmpeg decoding releases the GIL — and a
bounded prefetch queue so decode overlaps device compute. Determinism comes
from per-item RNGs keyed on (seed, epoch, index), not worker scheduling.
"""

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from fitclip_torch.data.video_dataset import Collator, VideoDataset


def item_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, epoch, index]))


_DONE = object()


def prefetched_batches(specs: Iterable[Any], make_batch: Callable,
                       num_threads: int, prefetch: int) -> Iterator[Any]:
    """Shared producer-thread prefetch: a worker drains `specs`, builds each
    batch with ``make_batch(pool, spec)`` on a GIL-releasing thread pool, and
    feeds a bounded queue so decode overlaps the consumer's device work.
    Worker exceptions re-raise in the consumer."""
    from concurrent.futures import ThreadPoolExecutor

    output: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()

    def produce():
        try:
            with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
                for spec in specs:
                    if stop.is_set():
                        break
                    output.put(make_batch(pool, spec))
            output.put(_DONE)
        except BaseException as exc:  # surface decode errors to the consumer
            output.put(exc)

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    try:
        while True:
            batch = output.get()
            if batch is _DONE:
                return
            if isinstance(batch, BaseException):
                raise batch
            yield batch
    finally:
        stop.set()
        # Drain so the producer can exit if blocked on put().
        while producer.is_alive():
            try:
                output.get_nowait()
            except queue.Empty:
                producer.join(timeout=0.1)


class DataLoader:
    def __init__(self, dataset: VideoDataset,
                 batch_size: int = 1,
                 shuffle: bool = False,
                 drop_last: bool = False,
                 collate: Optional[Callable] = None,
                 batch_sampler: Optional[Iterable[Sequence[int]]] = None,
                 num_threads: int = 8,
                 prefetch_batches: int = 2,
                 seed: int = 42,
                 process_index: int = 0,
                 process_count: int = 1) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate = collate or Collator(pad_batch=getattr(dataset, "pad_batch", True))
        self.batch_sampler = batch_sampler
        self.num_threads = max(1, num_threads)
        self.prefetch_batches = prefetch_batches
        self.seed = seed
        self.epoch = 0
        # Several processes: batch_size is the global batch; every process
        # derives the same global index order (seeded shuffle) and loads only
        # its contiguous row block of each batch, so a batch is composed as on
        # one process.
        self.process_index = process_index
        self.process_count = max(1, process_count)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffles per epoch (DistributedSampler.set_epoch semantics,
        data_module_group.py:163-167)."""
        self.epoch = epoch

    def _batches_of_indices(self) -> Iterator[List[int]]:
        if self.batch_sampler is not None:
            yield from (list(b) for b in self.batch_sampler)
            return
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch])).permutation(order)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start: start + self.batch_size].tolist()
            if len(chunk) < self.batch_size and self.drop_last:
                return
            if self.process_count > 1:
                if len(chunk) % self.process_count:
                    # Shrinking (or emptying) the global batch would desync the
                    # processes' steps.
                    raise ValueError(
                        f"global batch of {len(chunk)} rows is not divisible "
                        f"by {self.process_count} processes — set batch_size "
                        "to a multiple of the process count (and drop_last "
                        "for the trailing batch)")
                per = len(chunk) // self.process_count
                chunk = chunk[self.process_index * per:(self.process_index + 1) * per]
            yield chunk

    def __len__(self) -> int:
        if self.batch_sampler is not None:
            return sum(1 for _ in self.batch_sampler)
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_item(self, index: int) -> Any:
        return self.dataset.__getitem__(index, rng=item_rng(self.seed, self.epoch, index))

    def __iter__(self) -> Iterator[Any]:
        def make_batch(pool, indices):
            return self.collate(list(pool.map(self._load_item, indices)))

        yield from prefetched_batches(self._batches_of_indices(), make_batch,
                                      self.num_threads, self.prefetch_batches)
