"""The preprocessing contract between an encoder and the data layer (port of
``fitclip_tpu/models/api.py:PreprocessSpec``).

Every encoder exposes ``encoder.preprocess``: the frame counts, geometry,
normalization constants and pad policy that the host input pipeline reads to
build its samplers and transforms (``data/data_module.py:build_pipeline``), so
that ``encoder=`` on the CLI changes decoding for every dataset.
"""

import dataclasses
from typing import Callable, Optional, Tuple

from fitclip_torch.data.frame_sampler import FrameSampler


@dataclasses.dataclass(frozen=True)
class PreprocessSpec:
    num_frames: int
    image_size: int
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    train_frame_sampler: Callable
    eval_frame_sampler: FrameSampler
    resize_mode: str = "bicubic"  # eval resize: short side to image_size, center crop
    train_crop_scale: Tuple[float, float] = (0.5, 1.0)  # RandomResizedCrop range
    should_pad_batch: bool = True  # pad variable-frame videos in collate
    pad_to_min_frames: Optional[int] = None  # MIL-NCE / VideoCLIP PadToMinFrames
    max_tokens: int = 77
