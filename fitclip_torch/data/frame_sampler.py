"""Frame samplers (port of ``fitclip_tpu/data/frame_sampler.py``): clip
(start, end, fps) -> frame indices to decode.

Host-side, numpy-only (they run in the input pipeline, not on device). The
index math is bit-compatible with the reference samplers
(``aligner/data/frame_sampler.py:20-76``), including torch.linspace's
truncating int cast and torch.round's half-to-even rounding, because retrieval
parity depends on decoding exactly the same frames.
"""

from abc import ABC, abstractmethod
from typing import Optional, Sequence

import numpy as np


def _int_linspace(start: int, end: int, steps: int) -> np.ndarray:
    """torch.linspace(start, end, steps, dtype=torch.int) equivalent.

    torch computes in float then casts, truncating toward zero.
    """
    if steps == 1:
        return np.array([start], dtype=np.int64)
    step = (end - start) / (steps - 1)
    values = start + np.arange(steps, dtype=np.float64) * step
    return np.trunc(values).astype(np.int64)


def _pairwise(values: np.ndarray):
    return zip(values[:-1], values[1:])


def resample_indices(num_frames: int, original_fps: float, new_fps: float) -> Sequence[int]:
    """fps-resampled frame offsets, matching torchvision's
    ``VideoClips._resample_video_idx`` as wrapped by the reference
    (``util/video_utils.py:40-48``): integer steps become a range; fractional
    steps floor an arange."""
    step = original_fps / new_fps
    if step.is_integer():
        step = int(step)
        return range(0, num_frames * step, step)
    idxs = np.floor(np.arange(num_frames, dtype=np.float32) * step).astype(np.int64)
    return idxs.tolist()


class FrameSampler(ABC):
    """Returns frame indices to seek for a clip's start/end frame indices."""

    @abstractmethod
    def __call__(self, start_frame: int, end_frame: int, fps: float,
                 rng: Optional[np.random.Generator] = None) -> Sequence[int]:
        raise NotImplementedError


class RandomFromUniformIntervalsFrameSampler(FrameSampler):
    """One uniformly-random frame from each of ``max_frames`` uniform intervals
    (training augmentation; reference frame_sampler.py:20-28)."""

    def __init__(self, max_frames: int) -> None:
        self.max_frames = max_frames

    def __call__(self, start_frame: int, end_frame: int, fps: float,
                 rng: Optional[np.random.Generator] = None) -> Sequence[int]:
        rng = rng or np.random.default_rng()
        num_frames = min(self.max_frames, end_frame - start_frame + 1)
        ticks = _int_linspace(start_frame, end_frame, num_frames + 1)
        return [int(rng.integers(a, b + 1)) for a, b in _pairwise(ticks)]


class UniformFrameSampler(FrameSampler):
    """Midpoint of each uniform interval (eval default; frame_sampler.py:31-40).

    Midpoints use round-half-to-even to match torch.round.
    """

    def __init__(self, max_frames: int) -> None:
        self.max_frames = max_frames

    def __call__(self, start_frame: int, end_frame: int, fps: float,
                 rng: Optional[np.random.Generator] = None) -> Sequence[int]:
        num_frames = min(self.max_frames, end_frame - start_frame + 1)
        ticks = _int_linspace(start_frame, end_frame, num_frames + 1)
        return [int(np.round((a + b) / 2)) for a, b in _pairwise(ticks)]


class FixedFrameFromUniformIntervalsFrameSampler(FrameSampler):
    """Fixed offset from each interval start (frame_sampler.py:43-53)."""

    def __init__(self, max_frames: int, frame_index_from_interval_start: int) -> None:
        self.max_frames = max_frames
        self.frame_index_from_interval_start = frame_index_from_interval_start

    def __call__(self, start_frame: int, end_frame: int, fps: float,
                 rng: Optional[np.random.Generator] = None) -> Sequence[int]:
        num_frames = min(self.max_frames, end_frame - start_frame + 1)
        ticks = _int_linspace(start_frame, end_frame + 1, num_frames + 1)
        return (ticks[:-1] + self.frame_index_from_interval_start).tolist()


class ConsecutiveFrameSampler(FrameSampler):
    """A centered consecutive (optionally fps-resampled) window
    (frame_sampler.py:56-76); used by MIL-NCE (16 @ 5fps) and VideoCLIP
    (32 @ 30fps)."""

    def __init__(self, max_frames: int, fps: Optional[int] = None) -> None:
        self.max_frames = max_frames
        self.fps = fps

    def __call__(self, start_frame: int, end_frame: int, fps: float,
                 rng: Optional[np.random.Generator] = None) -> Sequence[int]:
        if self.fps:
            indices = resample_indices(num_frames=self.max_frames, original_fps=fps, new_fps=self.fps)
        else:
            indices = range(self.max_frames)
        indices = list(indices)

        smallest_possible_end = min(end_frame, start_frame + indices[-1])
        start = start_frame + (end_frame - smallest_possible_end) // 2

        result = []
        for i in indices:
            if start + i > end_frame:
                break
            result.append(start + i)
        return result
