"""Round-robin multi-source sampling for mixed labeled/unlabeled batches (port
of ``fitclip_tpu/data/multi_source_sampler.py``, pure Python, copied).

Sub-samplers yield local indices; the round robin interleaves fixed-size runs
and maps them into the concatenated dataset's global indices. ``min_size``
stops at the first exhausted source (even mid-run); ``max_size_cycle`` wraps
every source except the one with the most runs. The golden sequences are the
reference's (aligner/tests/data/multi_source_sampler_test.py:18-33).
"""

import itertools
import math
import sys
from typing import Iterable, Iterator, List, Literal, Sequence, Union


class CycleSampler:
    """Restarts its source forever (up to `length` total elements)."""

    def __init__(self, data_source: Iterable, length: int = sys.maxsize) -> None:
        self.length = length
        self.data_source = data_source

    def __iter__(self) -> Iterator:
        if not self.length:
            return
        counter = 0
        while True:
            for elem in self.data_source:
                yield elem
                counter += 1
                if counter >= self.length:
                    return

    def __len__(self) -> int:
        return self.length


class RoundRobinMultiSourceSampler:
    """Interleaves sub-samplers in fixed `sequence_sizes` runs over a
    concatenated dataset."""

    def __init__(self, sub_samplers: Iterable[Iterable[int]],
                 sequence_sizes: Union[int, Iterable[int]] = 1,
                 mode: Literal["min_size", "max_size_cycle"] = "min_size") -> None:
        sub_samplers = list(sub_samplers)
        if isinstance(sequence_sizes, Iterable):
            sequence_sizes = list(sequence_sizes)
        else:
            sequence_sizes = [sequence_sizes] * len(sub_samplers)

        assert len(sub_samplers) == len(sequence_sizes)
        assert all(len(sampler) for sampler in sub_samplers), \
            "every sub-sampler must be sized (len()) and non-empty"
        assert all(s > 0 for s in sequence_sizes)

        self.sub_samplers: List = sub_samplers
        self.sequence_sizes = sequence_sizes
        self.mode = mode
        self._original_lens = [len(sampler) for sampler in sub_samplers]

        if mode == "max_size_cycle":
            max_cycle, neg_i = max((math.floor(cycle), -i)
                                   for i, cycle in enumerate(self._cycles()))
            max_i = -neg_i  # first sampler index among those with max cycle count
            self.sub_samplers = [sampler if i == max_i else CycleSampler(sampler)
                                 for i, sampler in enumerate(self.sub_samplers)]
            # _original_lens already holds the underlying lengths.

    def _cycles(self) -> Iterator[float]:
        # Uses the *current* sampler lengths: after max_size_cycle wrapping,
        # cycled samplers report a huge length, so min() in __len__ lands on
        # the single non-cycled (longest-running) source — reference behavior.
        for sampler, seq_size in zip(self.sub_samplers, self.sequence_sizes):
            yield len(sampler) / seq_size

    def __iter__(self) -> Iterator[int]:
        iterators = [iter(sampler) for sampler in self.sub_samplers]
        while True:
            offset = 0
            for it, size, original_len in zip(iterators, self.sequence_sizes,
                                              self._original_lens):
                i = -1
                for i, local_index in enumerate(itertools.islice(it, size)):
                    yield offset + local_index
                if i < size - 1:
                    return
                offset += original_len

    def __len__(self) -> int:
        min_cycle, min_i = min((math.floor(cycle), i)
                               for i, cycle in enumerate(self._cycles()))
        return (sum(seq_size * (min_cycle + int(i < min_i))
                    for i, seq_size in enumerate(self.sequence_sizes))
                + self._original_lens[min_i] % self.sequence_sizes[min_i])
