"""Combinators of data modules: eval groups, structured groups, mixed batches
and train-and-eval (port of ``fitclip_tpu/data/data_module_group.py``;
data_module_group.py:61-208 of the reference).

As in the JAX package, the mixed labeled/unlabeled training batch is a
structured batch {"labeled": sub, "unlabeled": sub} rather than one flat
batch with a per-row "dataset" key: the sample stream is the reference's
(per-source random order, round-robin max_size_cycle composition,
drop_last), and the teacher-student step sees fixed shapes. The port runs one
process, so a mixed loader decodes every row of the plan.
"""

import zlib
from typing import Dict, Iterator, List, Mapping, Union

import numpy as np

from fitclip_torch.data.loader import DataLoader, item_rng, prefetched_batches


class EvalDataModuleGroup:
    """Sequences the val/test/predict loaders of several data modules. The
    runners suffix each member's metrics with its name."""

    def __init__(self, data_modules: Union[Mapping[str, object], List[object]]) -> None:
        if isinstance(data_modules, Mapping):
            self.names = list(data_modules.keys())
            self.data_modules = list(data_modules.values())
        else:
            self.names = [str(i) for i in range(len(data_modules))]
            self.data_modules = list(data_modules)

    def val_dataloader(self) -> List[DataLoader]:
        return [dm.val_dataloader() for dm in self.data_modules]

    def test_dataloader(self) -> List[DataLoader]:
        return [dm.test_dataloader() for dm in self.data_modules]

    def predict_dataloader(self) -> List[DataLoader]:
        return [dm.predict_dataloader() for dm in self.data_modules]


class DataModuleStructuredGroup(EvalDataModuleGroup):
    """Adds a mapping of each member's train loader (data_module_group.py:75-78);
    ``structured_batch.merge_datasets_batch`` merges their batches. The train
    command does not iterate such a mapping (``training/train_runner.py``)."""

    def train_dataloader(self) -> Dict[str, DataLoader]:
        return {name: dm.train_dataloader() for name, dm in zip(self.names, self.data_modules)}


def _stable_source_key(name: str) -> int:
    """A process-independent integer for a source name (``hash`` of a str
    changes with PYTHONHASHSEED, and so would the data order)."""
    return zlib.crc32(name.encode("utf-8"))


class MixedBatchLoader:
    """Fixed-composition mixed batches: each batch holds exactly
    ``sequence_sizes[k]`` items of source k in its own random order; the
    source with the most runs goes through once and every other cycles,
    drawing a fresh permutation each cycle (the reference's RandomSampler per
    cycle, multi_source_sampler.py:25-29); drop_last. The plan is seeded by
    SeedSequence([seed, epoch, crc32(name)]) per source; an item is
    ``dataset.__getitem__(i, rng=item_rng(seed, epoch, i))``, collated by its
    source's loader, decoded on a thread pool with a bounded prefetch queue."""

    def __init__(self, loaders: Mapping[str, DataLoader], sequence_sizes: Mapping[str, int],
                 seed: int = 42, num_threads: int = 8, prefetch_batches: int = 2) -> None:
        self.loaders = dict(loaders)
        self.sequence_sizes = {k: int(sequence_sizes[k]) for k in self.loaders}
        self.seed = seed
        self.epoch = 0
        self.num_threads = max(1, num_threads)
        self.prefetch_batches = prefetch_batches

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        for loader in self.loaders.values():
            loader.set_epoch(epoch)

    def _runs(self) -> Dict[str, int]:
        return {name: len(loader.dataset) // self.sequence_sizes[name]
                for name, loader in self.loaders.items()}

    def __len__(self) -> int:
        return max(self._runs().values())

    def _orders(self) -> Dict[str, Iterator[int]]:
        runs = self._runs()
        longest = max(runs, key=lambda name: runs[name])

        def cycling(n: int, rng: np.random.Generator) -> Iterator[int]:
            while True:
                yield from rng.permutation(n).tolist()

        orders = {}
        for name, loader in self.loaders.items():
            rng = np.random.default_rng(np.random.SeedSequence(
                [self.seed, self.epoch, _stable_source_key(name)]))
            n = len(loader.dataset)
            orders[name] = (iter(rng.permutation(n).tolist()) if name == longest
                            else cycling(n, rng))
        return orders

    def _iter_specs(self) -> Iterator[Dict[str, List[int]]]:
        """One batch's per-source index lists at a time: an epoch's plan is
        never held whole."""
        orders = self._orders()
        for _ in range(len(self)):
            yield {name: [next(orders[name]) for _ in range(self.sequence_sizes[name])]
                   for name in self.loaders}

    def _index_plan(self) -> List[Dict[str, List[int]]]:
        return list(self._iter_specs())

    def __iter__(self) -> Iterator[Dict[str, dict]]:
        def load(name: str, index: int):
            return self.loaders[name].dataset.__getitem__(
                index, rng=item_rng(self.seed, self.epoch, index))

        def make_batch(pool, spec):
            pairs = [(name, i) for name, indices in spec.items() for i in indices]
            items = list(pool.map(lambda pair: load(*pair), pairs))
            batch, cursor = {}, 0
            for name, indices in spec.items():
                batch[name] = self.loaders[name].collate(items[cursor:cursor + len(indices)])
                cursor += len(indices)
            return batch

        yield from prefetched_batches(self._iter_specs(), make_batch, self.num_threads,
                                      self.prefetch_batches)


class MixedBatchDataModule(EvalDataModuleGroup):
    """Training mixes the members into fixed-composition batches; evaluation
    runs each member apart (data_module_group.py:105-169)."""

    def __init__(self, data_modules: Mapping[str, object],
                 train_sequence_sizes: Union[int, Mapping[str, int]] = 1,
                 seed: int = 42) -> None:
        super().__init__(data_modules)
        if isinstance(train_sequence_sizes, Mapping):
            self.train_sequence_sizes = {k: int(v) for k, v in train_sequence_sizes.items()}
        else:
            self.train_sequence_sizes = {name: int(train_sequence_sizes) for name in self.names}
        self.seed = seed

    def train_dataloader(self) -> MixedBatchLoader:
        loaders = {name: dm.train_dataloader() for name, dm in zip(self.names, self.data_modules)}
        return MixedBatchLoader(loaders, self.train_sequence_sizes, seed=self.seed)


class TrainAndEvalDataModules:
    """Train on one data module, evaluate on another (data_module_group.py:190-208).
    The runners name the eval module's members as its own group does."""

    def __init__(self, train_data_module, eval_data_module) -> None:
        self.train_data_module = train_data_module
        self.eval_data_module = eval_data_module

    def train_dataloader(self):
        return self.train_data_module.train_dataloader()

    def val_dataloader(self):
        return self.eval_data_module.val_dataloader()

    def test_dataloader(self):
        return self.eval_data_module.test_dataloader()

    def predict_dataloader(self):
        return self.eval_data_module.predict_dataloader()
