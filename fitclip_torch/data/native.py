"""ctypes bindings for the native C++ FFmpeg decoder (port of
``fitclip_tpu/data/native.py``).

The library is built on first use, never at import, from
``native/video_decoder.cpp`` at the root of the checkout into
``build/fitclip_torch/decoder/<hash>/`` (the hash covers the source and the
flags), with the system's C++ compiler against libav. ``load_decoder`` raises
ImportError when it does not build (no compiler, no libav headers or
libraries); ``VideoReader.from_path`` then takes the OpenCV reader.
"""

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from fitclip_torch.data.video_reader import VideoReader, _nearest_indices, scaled_size

LOGGER = logging.getLogger(__name__)

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "native" / "video_decoder.cpp"
BUILD_ROOT = ROOT / "build" / "fitclip_torch" / "decoder"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")


def build_decoder() -> Path:
    """Compile the decoder (if not built already) and return the library's path."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or not SOURCE.is_file():
        raise ImportError(f"native decoder unavailable: no C++ compiler or no {SOURCE}")
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode() + SOURCE.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    library = out_dir / "libfitclip_decoder.so"
    if library.is_file():
        return library
    out_dir.mkdir(parents=True, exist_ok=True)
    # Unique per process and thread; os.replace publishes it atomically, so
    # another builder never loads a half-written library.
    partial = out_dir / f"libfitclip_decoder.so.{os.getpid()}.{threading.get_ident()}.partial"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(partial), str(SOURCE), *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise ImportError(f"native decoder did not build (exit {proc.returncode}):\n"
                          f"{proc.stderr[-2000:]}")
    os.replace(partial, library)
    return library


_LOCK = threading.Lock()
_OUTCOME = []  # [(library or None, error or None)] once the first build ends


def _decoder_or_error():
    # The loader's threads reach this together on the first batch: the lock
    # makes one of them build and bind, and the rest take its outcome.
    with _LOCK:
        if not _OUTCOME:
            try:
                _OUTCOME.append((_bind(ctypes.CDLL(str(build_decoder()))), None))
            except (ImportError, OSError) as e:
                _OUTCOME.append((None, str(e)))
        return _OUTCOME[0]


def load_decoder() -> ctypes.CDLL:
    """The bound library; ImportError if it does not build or load (the
    outcome is kept, so a failed build is not retried in this process)."""
    lib, error = _decoder_or_error()
    if lib is None:
        raise ImportError(f"native decoder library unavailable: {error}")
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p]
    lib.vd_open_threaded.restype = ctypes.c_void_p
    lib.vd_open_threaded.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.vd_num_frames.restype = ctypes.c_int
    lib.vd_num_frames.argtypes = [ctypes.c_void_p]
    lib.vd_avg_fps.restype = ctypes.c_double
    lib.vd_avg_fps.argtypes = [ctypes.c_void_p]
    lib.vd_frame_size.restype = None
    lib.vd_frame_size.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.vd_timestamps.restype = None
    lib.vd_timestamps.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_double)]
    lib.vd_get_frames.restype = ctypes.c_int
    lib.vd_get_frames.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                                  ctypes.c_int]
    lib.vd_close.restype = None
    lib.vd_close.argtypes = [ctypes.c_void_p]
    return lib


_FALLBACK_SHAPE = (256, 256, 3)


class NativeVideoReader(VideoReader):
    """Indexed reads through the C++ decoder; decord-compatible error
    tolerance (zeros instead of raising) and timestamp-based seeks."""

    def __init__(self, path, short_side: Optional[int] = None) -> None:
        super().__init__(path)
        self._lib = load_decoder()
        # short_side: aspect-preserving downscale at decode (swscale, and
        # lowres DCT decoding where the codec has it); one decode thread.
        self.short_side = short_side
        self._handle = self._lib.vd_open_threaded(str(path).encode(),
                                                  int(short_side or 0), 1)
        if not self._handle:
            LOGGER.error("An error occurred when trying to load the video "
                         "with path %s.", self.path)
        self._timestamps = None

    def __call__(self, indices: Sequence[int]) -> np.ndarray:
        if self._handle:
            indices_arr = np.asarray(list(indices), dtype=np.int64)
            h = ctypes.c_int()
            w = ctypes.c_int()
            self._lib.vd_frame_size(self._handle, ctypes.byref(h), ctypes.byref(w))
            height, width = h.value, w.value
            # Scale at decode only from >= 2x the target short side; below
            # that a 1:1 conversion and the transform's resize are faster.
            if self.short_side and min(height, width) >= 2 * self.short_side:
                height, width = scaled_size(height, width, self.short_side)
            out = np.empty((len(indices_arr), height, width, 3), dtype=np.uint8)
            code = self._lib.vd_get_frames(
                self._handle,
                indices_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(indices_arr),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                height, width)
            if code == 0:
                return out
            LOGGER.error("An error occurred when trying to read the video with "
                         "path %s and indices %s.", self.path, list(indices))
        return np.zeros((len(list(indices)), *_FALLBACK_SHAPE), dtype=np.uint8)

    @property
    def ok(self) -> bool:
        return bool(self._handle)

    def __len__(self) -> int:
        return self._lib.vd_num_frames(self._handle) if self._handle else 1

    def time_to_indices(self, time: Union[float, Sequence[float]]) -> np.ndarray:
        if not self._handle:
            return np.zeros_like(np.asarray(time), dtype=int)
        if self._timestamps is None:
            n = len(self)
            self._timestamps = np.empty(n, dtype=np.float64)
            self._lib.vd_timestamps(
                self._handle,
                self._timestamps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return _nearest_indices(self._timestamps, time)

    def get_avg_fps(self) -> float:
        return self._lib.vd_avg_fps(self._handle) if self._handle else 1.0

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.vd_close(self._handle)
            self._handle = None
