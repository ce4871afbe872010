"""Video/image readers (port of ``fitclip_tpu/data/video_reader.py``): path ->
indexed uint8 frames.

Protocol mirrors the reference reader surface (aligner/data/video_reader.py:
18-117): indexed ``get_batch``-style reads, ``time_to_indices`` seek math,
average fps, and error tolerance — unreadable media decodes to zero frames of
shape (len(indices), 256, 256, 3) instead of raising, so training never dies
on a corrupt sample.

Backends, in dispatch order:
1. the native C++ FFmpeg decoder (``native/video_decoder.cpp``, bound by
   ``fitclip_torch.data.native``) when it builds against the system's libav;
2. OpenCV ``VideoCapture``;
3. an OpenCV still-image reader (images are 1-frame videos, e.g. CC3M).

The zero-fill tolerance covers a file that a backend cannot decode. A missing
backend is not a corrupt file: with neither the native decoder nor ``cv2``,
``from_path`` raises.

Frames are numpy uint8 HWC; the device sees them only after collation.
"""

import logging
import os
from abc import ABC, abstractmethod
from typing import Optional, Sequence, Union

import numpy as np

LOGGER = logging.getLogger(__name__)

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                    ".tiff", ".webp")

_FALLBACK_SHAPE = (256, 256, 3)


class VideoReader(ABC):
    def __init__(self, path) -> None:
        self.path = str(path)

    @abstractmethod
    def __call__(self, indices: Sequence[int]) -> np.ndarray:
        """Decode the given frame indices -> (len(indices), H, W, 3) uint8."""
        raise NotImplementedError

    @abstractmethod
    def __len__(self) -> int:
        raise NotImplementedError

    @abstractmethod
    def time_to_indices(self, time: Union[float, Sequence[float]]) -> np.ndarray:
        raise NotImplementedError

    @property
    def ok(self) -> bool:
        """Whether the container opened and is decodable. Failed opens stay
        usable (zero-fill failure tolerance, the decord-parity batch-eval
        semantics) — online callers that would rather REJECT a bad video
        than embed zeros (demo/embed_service.py) check this instead."""
        return True

    @abstractmethod
    def get_avg_fps(self) -> float:
        raise NotImplementedError

    @staticmethod
    def from_path(path, short_side: Optional[int] = None) -> "VideoReader":
        """short_side: decode-time aspect-preserving downscale to this short
        side, only for frames whose short side is at least twice it (swscale
        in the native decoder, ``cv2.resize`` bicubic in OpenCV's). An opt-in
        speed option (``++data.decode_short_side=N``): its bicubic differs
        from the transform's at the last bit, so bit-parity paths leave it
        unset. Never upscales."""
        if str(path).lower().endswith(IMAGE_EXTENSIONS):
            return ImageVideoReader(path)
        native = _native_reader()
        if native is not None:
            return native(path, short_side=short_side)
        _require_cv2(path)
        return OpenCVVideoReader(path, short_side=short_side)


def scaled_size(height: int, width: int, short_side: int):
    """Aspect-preserving (h, w) with min side == short_side; never upscales."""
    if height <= 0 or width <= 0 or min(height, width) <= short_side:
        return height, width
    if height <= width:
        return short_side, max(1, round(width * short_side / height))
    return max(1, round(height * short_side / width)), short_side


def _native_reader():
    """The native decoder's reader class, or None if the library does not build."""
    from fitclip_torch.data.native import NativeVideoReader, load_decoder

    try:
        load_decoder()
    except ImportError:
        return None
    return NativeVideoReader


def _require_cv2(path):
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"no video decoder for {path}: the native decoder does not build here "
            "(it needs libav's headers and libraries) and cv2 is not installed") from e


def _nearest_indices(times: np.ndarray, time) -> np.ndarray:
    """decord-compatible nearest-frame search (video_reader.py:76-81 math):
    searchsorted, then step back unless the right neighbour is closer."""
    indices = np.searchsorted(times, time)
    indices = np.minimum(indices, len(times) - 1)
    return np.where(np.bitwise_or(indices == 0,
                                  times[indices] - time <= time - times[np.maximum(indices - 1, 0)]),
                    indices, indices - 1)


class OpenCVVideoReader(VideoReader):
    """cv2.VideoCapture-backed reader. Frame timestamps are synthesized as
    (i + 0.5) / fps (frame midpoints), matching decord's mean of per-frame
    (start, end) timestamps for constant-frame-rate streams."""

    def __init__(self, path, short_side: Optional[int] = None) -> None:
        super().__init__(path)
        import cv2

        self._cv2 = cv2
        self.short_side = short_side
        self.capture = None
        try:
            capture = cv2.VideoCapture(self.path)
            if capture.isOpened() and capture.get(cv2.CAP_PROP_FRAME_COUNT) > 0:
                self.capture = capture
            else:
                capture.release()
                LOGGER.error("An error occurred when trying to load the video "
                             "with path %s.", self.path)
        except Exception:
            LOGGER.error("An error occurred when trying to load the video "
                         "with path %s.", self.path)

    @property
    def ok(self) -> bool:
        return self.capture is not None

    def __call__(self, indices: Sequence[int]) -> np.ndarray:
        if self.capture is not None:
            try:
                return self._read(indices)
            except Exception:
                LOGGER.error("An error occurred when trying to read the video with "
                             "path %s and indices %s.", self.path, indices)
        return np.zeros((len(indices), *_FALLBACK_SHAPE), dtype=np.uint8)

    def _read(self, indices: Sequence[int]) -> np.ndarray:
        cv2 = self._cv2
        frames = {}
        unique = sorted(set(int(i) for i in indices))
        position = int(self.capture.get(cv2.CAP_PROP_POS_FRAMES))
        for index in unique:
            # Sequential grabs when close; seek for far jumps.
            if index < position or index - position > 64:
                self.capture.set(cv2.CAP_PROP_POS_FRAMES, index)
                position = index
            while position <= index:
                grabbed = self.capture.grab()
                if not grabbed:
                    break
                position += 1
            ok, frame = self.capture.retrieve()
            if not ok or frame is None:
                raise IOError(f"failed to decode frame {index}")
            # The native reader's rule (>= 2x the target short side), so a
            # run has the same geometry whichever backend decodes.
            if self.short_side and min(frame.shape[:2]) >= 2 * self.short_side:
                new_h, new_w = scaled_size(frame.shape[0], frame.shape[1],
                                           self.short_side)
                frame = cv2.resize(frame, (new_w, new_h),
                                   interpolation=cv2.INTER_CUBIC)
            frames[index] = frame[:, :, ::-1]  # BGR -> RGB
        return np.stack([frames[int(i)] for i in indices]).astype(np.uint8)

    def __len__(self) -> int:
        if self.capture is None:
            return 1
        return int(self.capture.get(self._cv2.CAP_PROP_FRAME_COUNT))

    def time_to_indices(self, time) -> np.ndarray:
        if self.capture is None:
            return np.zeros_like(np.asarray(time), dtype=int)
        fps = self.get_avg_fps()
        times = (np.arange(len(self)) + 0.5) / fps
        return _nearest_indices(times, time)

    def get_avg_fps(self) -> float:
        if self.capture is None:
            return 1.0
        fps = self.capture.get(self._cv2.CAP_PROP_FPS)
        return float(fps) if fps and fps > 0 else 1.0

    def __del__(self):
        if getattr(self, "capture", None) is not None:
            self.capture.release()


class ImageVideoReader(VideoReader):
    """A still image as a 1-frame video (reference AccImageVideoReader
    semantics, video_reader.py:91-117)."""

    def __call__(self, indices: Sequence[int]) -> np.ndarray:
        _require_cv2(self.path)
        import cv2

        try:
            image = cv2.imread(self.path, cv2.IMREAD_COLOR)
            if image is None:
                raise IOError(f"cannot read image {self.path}")
            return image[None, :, :, ::-1].astype(np.uint8)
        except Exception:
            LOGGER.error("An error occurred when trying to read the image with "
                         "path %s.", self.path)
            return np.zeros((len(indices), *_FALLBACK_SHAPE), dtype=np.uint8)

    def __len__(self) -> int:
        return 1

    def time_to_indices(self, time) -> np.ndarray:
        return np.zeros_like(np.asarray(time), dtype=int)

    def get_avg_fps(self) -> float:
        return 1.0
