"""Batch eyeballing (port of ``fitclip_tpu/utils/viz.py``): denormalize a
video batch back to uint8 and lay its frames out as one image grid.

``debug_batch`` is the one-call debugging tool: give it a batch the loader
produced and the encoder that drove its preprocessing, get a PNG on disk
(written with OpenCV) and the captions, decoded by the encoder's own
``decode_text``, on stdout.
"""

import math
from typing import Optional, Sequence

import numpy as np


def denormalize_video(video: np.ndarray, mean: Sequence[float],
                      std: Sequence[float]) -> np.ndarray:
    """(..., H, W, C) float normalized -> uint8 (float_standard_denormalize,
    reference video_encoder.py:55-63). Already-uint8 input passes through."""
    video = np.asarray(video)
    if video.dtype == np.uint8:
        return video
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    pixels = video.astype(np.float32) * std + mean
    # Normalized pixels may be in [0, 1] or [0, 255] scale, as the transform
    # divided by 255 before normalizing or not; tell them apart by range.
    if pixels.max() <= 1.5:
        pixels = pixels * 255.0
    return np.clip(np.rint(pixels), 0, 255).astype(np.uint8)


def make_image_grid(images: np.ndarray, num_columns: Optional[int] = None,
                    padding: int = 2) -> np.ndarray:
    """(N, H, W, C) uint8 -> one (rows*H', cols*W', C) uint8 grid image
    (torchvision make_grid's layout: row-major, gray padding)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    cols = num_columns or min(8, n)
    rows = math.ceil(n / cols)
    cell_h, cell_w = h + padding, w + padding
    grid = np.full((rows * cell_h + padding, cols * cell_w + padding, c), 114, np.uint8)
    for i in range(n):
        r, col = divmod(i, cols)
        y, x = padding + r * cell_h, padding + col * cell_w
        grid[y:y + h, x:x + w] = images[i]
    return grid


def debug_batch(video, text, encoder, output_path: str = "debug_batch.png") -> np.ndarray:
    """Denormalize a (B, T, H, W, C) video batch (numpy or a tensor) with the
    encoder's own normalization constants, save an image grid (one row per
    clip) and print the decoded captions. Returns the grid array."""
    video = np.asarray(video.cpu() if hasattr(video, "cpu") else video)
    spec = encoder.preprocess
    frames = denormalize_video(video, spec.mean, spec.std)
    batch, time = frames.shape[0], frames.shape[1]
    grid = make_image_grid(frames.reshape(batch * time, *frames.shape[2:]), num_columns=time)
    if output_path:
        import cv2

        cv2.imwrite(output_path, grid[..., ::-1])  # RGB -> BGR for OpenCV
    if text is not None:
        for decoded in encoder.decode_text(np.asarray(text.cpu() if hasattr(text, "cpu")
                                                      else text)):
            print(decoded)
    return grid
