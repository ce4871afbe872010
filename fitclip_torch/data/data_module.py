"""Data modules (port of ``fitclip_tpu/data/data_module.py``): glue between
encoders (the preprocessing truth) and datasets.

Preserves the reference inversion (video_data_module.py:40-55): the data
module queries the encoder(s) for frame samplers / geometry / tokenizers at
loader-construction time, so swapping ``encoder=`` on the CLI changes
decoding/augmentation for every dataset. Encoder maps ({"student": ..,
"teacher": ..}) yield per-key pipelines and tokenizer maps for dual
preprocessing.
"""

import os
from abc import ABC, abstractmethod
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np

from fitclip_torch.data.loader import DataLoader
from fitclip_torch.data.transforms import eval_transform, pad_to_min_frames, train_transform
from fitclip_torch.data.video_dataset import Collator, FramePipeline, VideoDataset
from fitclip_torch.parallel import multihost

# An encoder (anything with ``preprocess`` and ``get_tokenizer``, e.g. a
# LoadedEncoder), or a {"student": ..., "teacher": ...} map of them.
EncoderOrMap = Union[Any, Mapping[str, Any]]

VIDEO_FILE_EXTENSIONS = (".3g2", ".3gp", ".amv", ".asf", ".avi", ".drc", ".f4a", ".f4b",
                         ".f4p", ".f4v", ".flv", ".gif", ".gifv", ".m2ts", ".m2v", ".m4p",
                         ".m4v", ".mkv", ".mng", ".mov", ".mp2", ".mp4", ".mpe", ".mpeg",
                         ".mpg", ".mpv", ".mts", ".mxf", ".nsv", ".ogg", ".ogv", ".qt",
                         ".rm", ".rmvb", ".roq", ".svi", ".ts", ".viv", ".vob", ".webm",
                         ".wmv", ".yuv")


def get_videos_in_folder(path, extensions=VIDEO_FILE_EXTENSIONS):
    for folder, _, filenames in os.walk(path, followlinks=True):
        for filename in filenames:
            full_path = os.path.join(folder, filename)
            if os.path.isfile(full_path) and (not extensions or
                                              filename.lower().endswith(tuple(extensions))):
                yield full_path


def get_sorted_videos_in_folder(path, extensions=VIDEO_FILE_EXTENSIONS):
    """Sorted for determinism under distributed sharding
    (util/video_utils.py:28-36 rationale)."""
    return sorted(get_videos_in_folder(path, extensions))


def build_pipeline(encoder, train: bool) -> FramePipeline:
    spec = encoder.preprocess
    sampler = spec.train_frame_sampler if train else spec.eval_frame_sampler

    if train:
        def transform(frames: np.ndarray, rng: np.random.Generator) -> np.ndarray:
            out = train_transform(frames, spec.image_size, rng, scale=spec.train_crop_scale)
            if spec.pad_to_min_frames:
                out = pad_to_min_frames(out, spec.pad_to_min_frames)
            return out
    else:
        def transform(frames: np.ndarray, rng: np.random.Generator) -> np.ndarray:
            out = eval_transform(frames, spec.image_size, spec.resize_mode)
            if spec.pad_to_min_frames:
                out = pad_to_min_frames(out, spec.pad_to_min_frames)
            return out

    return FramePipeline(sampler=sampler, transform=transform)


def _map_over_encoders(encoder: EncoderOrMap, fn):
    if isinstance(encoder, Mapping):
        return {key: fn(enc) for key, enc in encoder.items()}
    return fn(encoder)


class VideoDataModule(ABC):
    def __init__(self, encoder: EncoderOrMap, batch_size: Optional[int] = 1,
                 eval_batch_size: Optional[int] = 32, num_threads: int = 8,
                 seed: int = 42,
                 decode_short_side: Optional[int] = None,
                 eval_frame_cache_dir: Optional[str] = None) -> None:
        self.encoder = encoder
        self.batch_size = batch_size
        self.eval_batch_size = eval_batch_size
        self.num_threads = num_threads
        self.seed = seed
        # Decode-time aspect-preserving downscale (++data.decode_short_side=N);
        # see VideoReader.from_path for the parity note.
        self.decode_short_side = decode_short_side
        # Opt-in cache of transformed frames for repeated eval sweeps
        # (++data.eval_frame_cache_dir=DIR); eval loaders only, since train
        # pipelines draw anew every epoch.
        self.eval_frame_cache_dir = eval_frame_cache_dir

    def _pipelines(self, train: bool):
        return _map_over_encoders(self.encoder, lambda e: build_pipeline(e, train))

    def _pad_batch(self) -> bool:
        pads = _map_over_encoders(self.encoder, lambda e: e.preprocess.should_pad_batch)
        if isinstance(pads, Mapping):
            return all(pads.values())
        return pads

    def _dataset_kwargs(self, train: bool) -> Dict[str, Any]:
        return {"pipelines": self._pipelines(train),
                "pad_batch": self._pad_batch(),
                "decode_short_side": self.decode_short_side,
                "frame_cache_dir": None if train else self.eval_frame_cache_dir}

    def _collator(self) -> Collator:
        return Collator(tokenizers=None, pad_batch=self._pad_batch())

    def _create_dataloader(self, dataset: VideoDataset, train: bool, **kwargs) -> DataLoader:
        # Several processes: a train loader feeds only this process's row block
        # of each global batch. Eval loaders stay whole; the runners take each
        # rank's block of a padded batch.
        if train and "process_count" not in kwargs:
            kwargs.update(process_index=multihost.process_index(),
                          process_count=multihost.process_count())
        return DataLoader(dataset,
                          batch_size=self.batch_size if train else self.eval_batch_size,
                          shuffle=train, drop_last=train, collate=self._collator(),
                          num_threads=self.num_threads, seed=self.seed, **kwargs)

    def train_dataloader(self) -> DataLoader:
        raise NotImplementedError(f"{type(self).__name__} has no train split")

    @abstractmethod
    def val_dataloader(self) -> DataLoader:
        raise NotImplementedError

    def test_dataloader(self) -> DataLoader:
        # Reference routes command=test to the test split (__main__.py:69);
        # modules without one fall back to val, but loudly, so a silent
        # val-split "test" result can't masquerade as a test-split number.
        import logging

        logging.getLogger(__name__).warning(
            "%s defines no test split; falling back to the val split",
            type(self).__name__)
        return self.val_dataloader()

    def predict_dataloader(self) -> DataLoader:
        return self.val_dataloader()


class VideoTextDataModule(VideoDataModule, ABC):
    def _collator(self) -> Collator:
        tokenizers = _map_over_encoders(self.encoder, lambda e: e.get_tokenizer())
        return Collator(tokenizers=tokenizers, pad_batch=self._pad_batch())


class VideoClassificationDataModule(VideoDataModule, ABC):
    """Targets are (category_name, class_index); the CLI swaps the task module
    to zero-shot classification and injects categories/templates
    (cli.py:110-115 semantics)."""

    @property
    @abstractmethod
    def categories(self) -> Mapping[str, int]:
        raise NotImplementedError

    @property
    def templates(self) -> Optional[Sequence[str]]:
        return None

    def _collator(self) -> Collator:
        return ClassificationCollator(pad_batch=self._pad_batch())


class ClassificationCollator(Collator):
    """Splits (category, index) targets into 'category'/'label' batch keys."""

    def __call__(self, items):
        items = [dict(item) for item in items]
        for item in items:
            category, label = item.pop(self.target_key_name)
            item["category"] = category
            item["label"] = int(label)
        return super().__call__(items)
