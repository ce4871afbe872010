"""Map-style video datasets and batch collation (port of
``fitclip_tpu/data/video_dataset.py``), numpy end to end.

Reference semantics preserved (aligner/data/video_dataset.py:29-117):
- per-key frame-sampler/transform maps enable dual student/teacher
  preprocessing of the same clip (keys like ``video_student``);
- `__getitem__` = open reader -> clip times -> per-key frame indices ->
  decode -> transform;
- collate right-pads variable-frame videos (only for video keys) and
  batch-tokenizes text targets, including tokenizer maps producing
  ``text_student`` / ``text_teacher`` (tokenizer_collate.py:82-89).

Differences by design: items are numpy uint8 (device normalization comes
later), and randomness is an explicit per-item `np.random.Generator` derived
from (seed, epoch, index) so results are reproducible independent of worker
count — stronger than the reference's seeded-worker approach.
"""

import dataclasses
import hashlib
import logging
import os
import threading
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from fitclip_torch.data.frame_sampler import FrameSampler
from fitclip_torch.data.video_reader import VideoReader
from fitclip_torch.utils.tensor import stack_padded

LOGGER = logging.getLogger(__name__)

Transform = Callable[[np.ndarray, np.random.Generator], np.ndarray]
Tokenizer = Callable[[Sequence[str]], np.ndarray]


def filename_without_extension(path) -> str:
    return os.path.basename(str(path)).split(".", maxsplit=1)[0]


@dataclasses.dataclass
class FramePipeline:
    """One video key's decode recipe: which frames, then host geometry."""
    sampler: FrameSampler
    transform: Transform


class VideoDataset(ABC):
    def __init__(self, video_paths: Sequence,
                 pipelines: Union[FramePipeline, Mapping[str, FramePipeline]],
                 video_key_name: str = "video", target_key_name: str = "target",
                 pad_batch: bool = True,
                 decode_short_side: Optional[int] = None,
                 frame_cache_dir: Optional[str] = None) -> None:
        self.video_paths = list(video_paths)
        self.target_key_name = target_key_name
        self.pad_batch = pad_batch
        self.decode_short_side = decode_short_side
        # Opt-in cache of transformed frames for repeated deterministic eval
        # sweeps (the per-epoch loop over many checkpoints): one .npy per
        # (video file, pipeline key, row), so later sweeps skip decode and
        # transform. The key covers file identity (path, mtime, size) and
        # decode geometry, not the transform's settings: use one cache
        # directory per eval configuration. The key is the JAX package's, so
        # either package reads a cache the other filled.
        self.frame_cache_dir = frame_cache_dir
        if isinstance(pipelines, Mapping):
            self.pipelines = {f"{video_key_name}_{k}": v for k, v in pipelines.items()}
        else:
            self.pipelines = {video_key_name: pipelines}

    @abstractmethod
    def _get_target(self, video_idx: int) -> Any:
        raise NotImplementedError

    def _get_video_id(self, video_idx: int) -> str:
        return filename_without_extension(self.video_paths[video_idx])

    def _get_times(self, video_idx: int) -> Tuple[Optional[float], Optional[float]]:
        """Clip start/end times (YouCook2-style segment datasets override)."""
        return None, None

    def _cache_path(self, path, key: str, video_idx: int) -> str:
        try:
            stat = os.stat(path)
            identity = f"{os.path.abspath(path)}|{stat.st_mtime_ns}|{stat.st_size}"
        except OSError:
            identity = os.path.abspath(str(path))
        # Segment datasets (YouCook2, DiDeMo) repeat one video file over many
        # rows with different clip times: the row and the times are part of
        # the key, or every segment would share one entry.
        times = self._get_times(video_idx)
        digest = hashlib.sha1(
            f"{identity}|{key}|{self.decode_short_side}|{video_idx}|{times}"
            .encode()).hexdigest()
        return os.path.join(self.frame_cache_dir, f"{digest}.npy")

    def __getitem__(self, video_idx: int,
                    rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
        rng = rng or np.random.default_rng()
        path = self.video_paths[video_idx]

        # The reader opens lazily: an item that hits the cache for every
        # pipeline never opens the video (the open indexes the file's frames).
        reader: Optional[VideoReader] = None
        frame_range: Optional[Tuple[int, int]] = None

        def get_reader() -> VideoReader:
            nonlocal reader, frame_range
            if reader is None:
                reader = VideoReader.from_path(path, short_side=self.decode_short_side)
                start_time, end_time = self._get_times(video_idx)
                start = 0 if start_time is None else int(reader.time_to_indices(start_time))
                end = (len(reader) - 1 if end_time is None
                       else int(reader.time_to_indices(end_time)))
                frame_range = (start, end)
            return reader

        item: Dict[str, Any] = {
            self.target_key_name: self._get_target(video_idx, rng=rng)
            if _accepts_rng(self._get_target) else self._get_target(video_idx),
            "video_id": self._get_video_id(video_idx),
        }
        for key, pipeline in self.pipelines.items():
            cache_file = (self._cache_path(path, key, video_idx)
                          if self.frame_cache_dir else None)
            if cache_file and os.path.exists(cache_file):
                item[key] = np.load(cache_file)
                continue
            r = get_reader()
            start_frame, end_frame = frame_range
            indices = pipeline.sampler(start_frame, end_frame, fps=r.get_avg_fps(), rng=rng)
            item[key] = pipeline.transform(r(indices), rng)
            if cache_file:
                os.makedirs(self.frame_cache_dir, exist_ok=True)
                # Atomic publish: the loader's threads, and the ranks of a
                # group that all decode the unsliced eval set, may write the
                # same clip at once.
                tmp = f"{cache_file}.{os.getpid()}.{threading.get_ident()}.tmp.npy"
                np.save(tmp, item[key])
                os.replace(tmp, cache_file)
        return item

    def __len__(self) -> int:
        return len(self.video_paths)


def _accepts_rng(fn) -> bool:
    import inspect

    try:
        return "rng" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class Collator:
    """Batch assembly: stack/pad video keys, tokenize string targets,
    default-stack the rest.

    ``tokenizers`` may be a single callable (-> "text" key) or a mapping
    {"student": tok_a, "teacher": tok_b} (-> "text_student"/"text_teacher"),
    mirroring MappingTokenizerCollate.
    """

    def __init__(self, tokenizers: Union[None, Tokenizer, Mapping[str, Tokenizer]] = None,
                 pad_batch: bool = True, target_key_name: str = "target",
                 text_key_name: str = "text") -> None:
        self.tokenizers = tokenizers
        self.pad_batch = pad_batch
        self.target_key_name = target_key_name
        self.text_key_name = text_key_name

    def __call__(self, items: Sequence[Mapping[str, Any]]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        for key in items[0]:
            values = [item[key] for item in items]
            if key == self.target_key_name and self.tokenizers is not None:
                if isinstance(self.tokenizers, Mapping):
                    for suffix, tokenizer in self.tokenizers.items():
                        batch[f"{self.text_key_name}_{suffix}"] = tokenizer(values)
                else:
                    batch[self.text_key_name] = self.tokenizers(values)
            elif isinstance(values[0], np.ndarray) and values[0].ndim >= 3:
                batch[key] = (stack_padded(values) if self.pad_batch
                              else np.stack(values))
            elif isinstance(values[0], (int, np.integer, float, np.floating)):
                batch[key] = np.asarray(values)
            elif isinstance(values[0], np.ndarray):
                batch[key] = np.stack(values)
            else:
                batch[key] = list(values)
        return batch
