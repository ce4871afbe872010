"""Host-side frame geometry transforms (port of ``fitclip_tpu/data/transforms.py``):
numpy + OpenCV, uint8 in and out.

Geometry (resize, crop, flip) runs on the host in cv2 at uint8; the
normalization runs on the device (``prepare_frames``, or folded into the patch
embedding), so the host-to-device copy stays uint8, a quarter of fp32's bytes.

cv2.INTER_CUBIC matches torch's non-antialiased bicubic (both Catmull-Rom
family) to within ~1/255 per pixel, which is inside the embedding parity
tolerance.
"""

from typing import Optional, Sequence, Tuple

import numpy as np


def resize_short_side(frames: np.ndarray, size: int, interpolation: str = "bicubic") -> np.ndarray:
    """Resize (T, H, W, C) so the short side equals `size`, preserving aspect
    (torchvision T.Resize(size) semantics)."""
    import cv2

    interp = {"bicubic": cv2.INTER_CUBIC, "bilinear": cv2.INTER_LINEAR}[interpolation]
    t, h, w, c = frames.shape
    if h <= w:
        new_h, new_w = size, max(1, int(round(w * size / h)))
    else:
        new_h, new_w = max(1, int(round(h * size / w))), size
    if (new_h, new_w) == (h, w):
        return frames
    return np.stack([cv2.resize(frame, (new_w, new_h), interpolation=interp)
                     for frame in frames])


def center_crop(frames: np.ndarray, size: int) -> np.ndarray:
    """(T, H, W, C) -> (T, size, size, C) center crop, zero-padding if the
    frame is smaller (torchvision CenterCrop semantics)."""
    t, h, w, c = frames.shape
    if h < size or w < size:
        pad_h, pad_w = max(size - h, 0), max(size - w, 0)
        frames = np.pad(frames, ((0, 0),
                                 (pad_h // 2, pad_h - pad_h // 2),
                                 (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
        t, h, w, c = frames.shape
    top = (h - size) // 2
    left = (w - size) // 2
    return frames[:, top: top + size, left: left + size]


def eval_transform(frames: np.ndarray, size: int, interpolation: str = "bicubic") -> np.ndarray:
    """Bicubic short-side resize + center crop: the CLIP eval path
    (clip_video_text_encoder.py:125-133) minus normalization (device-side)."""
    return center_crop(resize_short_side(frames, size, interpolation), size)


def random_resized_crop_params(height: int, width: int, rng: np.random.Generator,
                               scale: Tuple[float, float] = (0.5, 1.0),
                               ratio: Tuple[float, float] = (3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop.get_params: 10 attempts at a random area
    and log-uniform aspect, falling back to a max center crop."""
    area = height * width
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect_ratio = float(np.exp(rng.uniform(log_ratio[0], log_ratio[1])))
        w = int(round(np.sqrt(target_area * aspect_ratio)))
        h = int(round(np.sqrt(target_area / aspect_ratio)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    # Fallback: center crop at the closest valid ratio.
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = height, int(round(height * ratio[1]))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def train_transform(frames: np.ndarray, size: int, rng: np.random.Generator,
                    scale: Tuple[float, float] = (0.5, 1.0),
                    horizontal_flip: bool = True) -> np.ndarray:
    """RandomResizedCrop (one crop per clip, as the reference applies the
    transform to the whole video tensor) with random bilinear/bicubic
    interpolation + random horizontal flip
    (clip_video_text_encoder.py:114-122)."""
    import cv2

    t, h, w, c = frames.shape
    top, left, ch, cw = random_resized_crop_params(h, w, rng, scale)
    cropped = frames[:, top: top + ch, left: left + cw]
    interp = cv2.INTER_LINEAR if rng.integers(0, 2) == 0 else cv2.INTER_CUBIC
    resized = np.stack([cv2.resize(frame, (size, size), interpolation=interp)
                        for frame in cropped])
    if horizontal_flip and rng.integers(0, 2) == 1:
        resized = resized[:, :, ::-1]
    return np.ascontiguousarray(resized)


def pad_to_min_frames(frames: np.ndarray, min_frames: int) -> np.ndarray:
    """Zero-pad the time axis up to min_frames (reference PadToMinFrames,
    transforms.py:37-44)."""
    if frames.shape[0] >= min_frames:
        return frames
    pad = np.zeros((min_frames - frames.shape[0], *frames.shape[1:]), frames.dtype)
    return np.concatenate([frames, pad])


def max_frames(frames: np.ndarray, limit: int) -> np.ndarray:
    """Truncate the time axis (reference MaxFrames, transforms.py:47-53)."""
    return frames[:limit]
