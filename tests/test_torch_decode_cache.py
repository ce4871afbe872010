"""The port's decode-time short side and eval frame cache
(fitclip_torch/data/{video_reader,native,video_dataset,data_module}.py)
against the JAX package's, on the CPU: the cases of
tests/test_decode_fast_path.py, and the two packages' caches of one tree.

- ``scaled_size`` is JAX's; the OpenCV reader's short side is JAX's bit for
  bit and engages only at twice the target; without one it is the reader as
  before; the native reader (built here against libav) scales at decode;
  ``from_path`` passes the short side through;
- a cache hit is bit-equal to the decoded item and to JAX's item, a full hit
  opens no video, and segments of one file keep their own entries;
- the JAX package and the port fill one MSR-VTT tree's cache with the same
  file names and bit-equal arrays (short side unset and set), and YouCook2's
  clip times reach the key;
- a second eval through the data module opens no video, and train loaders
  take no cache.

The parity tests decode with OpenCV in both packages (``opencv_only``), as the
other data tests do; the native reader is tested on its own.
"""

import os

import numpy as np
import pytest

from fitclip_tpu.data.datasets import msrvtt as jax_msrvtt
from fitclip_tpu.data.datasets import youcook2 as jax_youcook2
from fitclip_tpu.data.frame_sampler import UniformFrameSampler as JaxUniformFrameSampler
from fitclip_tpu.data.video_dataset import FramePipeline as JaxFramePipeline
from fitclip_tpu.data.video_dataset import VideoDataset as JaxVideoDataset
from fitclip_tpu.data.video_reader import OpenCVVideoReader as JaxOpenCVVideoReader
from fitclip_tpu.data.video_reader import scaled_size as jax_scaled_size
from fitclip_tpu.models.clip import load as jax_load
from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab
from fitclip_torch.data import native, video_reader
from fitclip_torch.data.datasets import msrvtt, youcook2
from fitclip_torch.data.frame_sampler import UniformFrameSampler
from fitclip_torch.data.video_dataset import FramePipeline, VideoDataset
from fitclip_torch.data.video_reader import OpenCVVideoReader, VideoReader, scaled_size
from fitclip_torch.models.clip import load

from tests.test_datasets import _write_video
from tests.test_torch_cli import WORDS, _msrvtt_tree
from tests.test_torch_data import _write_textured_video
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def opencv_only(monkeypatch):
    monkeypatch.setattr(video_reader, "_native_reader", lambda: None)


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    """tests/test_decode_fast_path.py's clip: flat frames, 48 x 64."""
    path = str(tmp_path_factory.mktemp("clips") / "clip.avi")
    _write_video(path, num_frames=10, size=(64, 48))
    return path


@pytest.fixture(scope="module")
def textured_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("textured") / "clip.avi"
    _write_textured_video(path, num_frames=10, size=(64, 48), seed=3)
    return str(path)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_tiny_test_vocab(str(tmp_path_factory.mktemp("vocab")), WORDS)


@pytest.fixture(scope="module")
def encoders(vocab):
    merges, vocab_json = vocab
    return (load.load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab_json, device="cpu"),
            jax_load.load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab_json))


@pytest.fixture(scope="module")
def msrvtt_root(tmp_path_factory):
    return _msrvtt_tree(tmp_path_factory.mktemp("msrvtt"), 5)


def test_scaled_size_math():
    assert scaled_size(480, 640, 256) == (256, 341)
    assert scaled_size(640, 480, 256) == (341, 256)
    assert scaled_size(200, 300, 256) == (200, 300)  # never upscales
    assert scaled_size(256, 512, 256) == (256, 512)
    for h, w, side in [(480, 640, 224), (1080, 1920, 224), (720, 1280, 256), (49, 97, 24),
                       (97, 49, 24), (0, 10, 4), (3, 1000, 1)]:
        assert scaled_size(h, w, side) == jax_scaled_size(h, w, side)


def test_opencv_reader_short_side(video_path):
    full = OpenCVVideoReader(video_path)([0, 3])
    small = OpenCVVideoReader(video_path, short_side=24)([0, 3])
    assert full.shape[1:] == (48, 64, 3)
    assert small.shape[1:] == (24, 32, 3)
    import cv2

    resized = np.stack([cv2.resize(f, (32, 24), interpolation=cv2.INTER_CUBIC) for f in full])
    assert np.abs(resized.astype(np.int16) - small.astype(np.int16)).mean() < 2


def test_opencv_reader_is_jax_s_bit_for_bit(textured_path):
    for side in (None, 24):
        np.testing.assert_array_equal(
            OpenCVVideoReader(textured_path, short_side=side)([0, 3, 3, 7]),
            JaxOpenCVVideoReader(textured_path, short_side=side)([0, 3, 3, 7]))
    # Without a short side the reader is as before the option: full-size frames.
    np.testing.assert_array_equal(OpenCVVideoReader(textured_path)([0, 3, 3, 7]),
                                  OpenCVVideoReader(textured_path, short_side=None)([0, 3, 3, 7]))


def test_short_side_engages_only_from_twice_the_target(textured_path):
    full = OpenCVVideoReader(textured_path)([1])
    for side in (25, 40, 48, 100):  # 48 < 2 * side: no resize
        np.testing.assert_array_equal(OpenCVVideoReader(textured_path, short_side=side)([1]),
                                      full)
    assert OpenCVVideoReader(textured_path, short_side=24)([1]).shape[1:] == (24, 32, 3)


def test_native_reader_short_side(video_path):
    try:
        native.load_decoder()
    except ImportError as e:
        pytest.skip(f"the native decoder does not build here: {e}")
    full = native.NativeVideoReader(video_path)([0, 3])
    small = native.NativeVideoReader(video_path, short_side=24)([0, 3])
    kept = native.NativeVideoReader(video_path, short_side=25)([0, 3])
    assert full.shape[1:] == (48, 64, 3)
    assert small.shape[1:] == (24, 32, 3)
    np.testing.assert_array_equal(kept, full)
    import cv2

    resized = np.stack([cv2.resize(f, (32, 24), interpolation=cv2.INTER_CUBIC) for f in full])
    # swscale's bicubic against cv2's: the same image, the last bits differ.
    assert np.abs(resized.astype(np.int16) - small.astype(np.int16)).mean() < 4


@pytest.mark.parametrize("backend", ["opencv", "native"])
def test_from_path_passes_short_side(video_path, backend, monkeypatch):
    if backend == "opencv":
        monkeypatch.setattr(video_reader, "_native_reader", lambda: None)
    else:
        try:
            native.load_decoder()
        except ImportError as e:
            pytest.skip(f"the native decoder does not build here: {e}")
    reader = VideoReader.from_path(video_path, short_side=24)
    assert type(reader).__name__ == ("OpenCVVideoReader" if backend == "opencv"
                                     else "NativeVideoReader")
    assert reader([0]).shape[1:] == (24, 32, 3)


class _Dataset(VideoDataset):
    def _get_target(self, video_idx):
        return "t"


class _JaxDataset(JaxVideoDataset):
    def _get_target(self, video_idx):
        return "t"


def _identity(frames, rng):
    return frames


def test_cache_skips_decode(tmp_path, opencv_only, monkeypatch):
    path = tmp_path / "v.avi"
    _write_textured_video(path, num_frames=8, size=(32, 32), seed=5)

    def make():
        return _Dataset(video_paths=[str(path)],
                        pipelines=FramePipeline(UniformFrameSampler(2), _identity),
                        frame_cache_dir=str(tmp_path / "cache"))

    first = make()[0]
    assert os.listdir(tmp_path / "cache")

    def boom(*args, **kwargs):
        raise AssertionError("decode happened despite a warm cache")

    monkeypatch.setattr(VideoReader, "from_path", staticmethod(boom))
    np.testing.assert_array_equal(make()[0]["video"], first["video"])


def test_cache_keeps_segments_apart(tmp_path, opencv_only):
    """Segment datasets repeat one video file over rows with other clip times;
    each row gets its own entry."""
    path = str(tmp_path / "v.avi")
    _write_textured_video(tmp_path / "v.avi", num_frames=12, size=(32, 32), seed=6)

    class Segments(VideoDataset):
        def __init__(self, **kwargs):
            super().__init__(video_paths=[path, path], **kwargs)

        def _get_target(self, video_idx):
            return "t"

        def _get_times(self, video_idx):
            return (0.0, 0.4) if video_idx == 0 else (0.9, 1.4)

    dataset = Segments(pipelines=FramePipeline(UniformFrameSampler(2), _identity),
                       frame_cache_dir=str(tmp_path / "cache"))
    first, second = dataset[0], dataset[1]
    assert len(os.listdir(tmp_path / "cache")) == 2
    assert not np.array_equal(first["video"], second["video"])
    np.testing.assert_array_equal(dataset[0]["video"], first["video"])
    np.testing.assert_array_equal(dataset[1]["video"], second["video"])


@pytest.mark.parametrize("short_side", [None, 24])
def test_cache_hit_is_the_decoded_item_and_jax_s(tmp_path, opencv_only, textured_path,
                                                 short_side):
    video_path = textured_path

    def transform(frames, rng):
        return frames[:, ::2, ::2]

    port = _Dataset(video_paths=[video_path], pipelines=FramePipeline(UniformFrameSampler(3),
                                                                       transform),
                    decode_short_side=short_side, frame_cache_dir=str(tmp_path / "port"))
    jax = _JaxDataset(video_paths=[video_path],
                      pipelines=JaxFramePipeline(JaxUniformFrameSampler(3), transform),
                      decode_short_side=short_side, frame_cache_dir=str(tmp_path / "jax"))
    decoded = port[0]["video"]
    hit = port[0]["video"]
    uncached = _Dataset(video_paths=[video_path],
                        pipelines=FramePipeline(UniformFrameSampler(3), transform),
                        decode_short_side=short_side)[0]["video"]
    assert hit.dtype == decoded.dtype == np.uint8
    np.testing.assert_array_equal(hit, decoded)
    np.testing.assert_array_equal(hit, uncached)
    np.testing.assert_array_equal(hit, jax[0]["video"])
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax")


def _cache(directory):
    return {name: np.load(os.path.join(directory, name)) for name in sorted(os.listdir(directory))}


def _drain(loader):
    return [batch for batch in loader]


@pytest.mark.parametrize("short_side", [None, 24])
def test_both_packages_fill_one_cache(tmp_path, opencv_only, encoders, msrvtt_root, short_side):
    common = dict(base_path=msrvtt_root, eval_batch_size=2, num_threads=2,
                  decode_short_side=short_side)
    port = msrvtt.MsrVttDataModule(encoder=encoders[0],
                                   eval_frame_cache_dir=str(tmp_path / "port"), **common)
    jax = jax_msrvtt.MsrVttDataModule(encoder=encoders[1],
                                      eval_frame_cache_dir=str(tmp_path / "jax"), **common)
    port_batches, jax_batches = _drain(port.val_dataloader()), _drain(jax.val_dataloader())
    port_cache, jax_cache = _cache(tmp_path / "port"), _cache(tmp_path / "jax")
    assert len(port_cache) == 5 and list(port_cache) == list(jax_cache)
    for name in port_cache:
        np.testing.assert_array_equal(port_cache[name], jax_cache[name])
    for a, b in zip(port_batches, jax_batches):
        np.testing.assert_array_equal(a["video"], b["video"])
    # Each short side keys its own entries.
    other = msrvtt.MsrVttDataModule(encoder=encoders[0], base_path=msrvtt_root,
                                    eval_frame_cache_dir=str(tmp_path / "port"),
                                    decode_short_side=12 if short_side else 24)
    _drain(other.val_dataloader())
    assert len(os.listdir(tmp_path / "port")) == 10


def test_second_eval_opens_no_video(tmp_path, opencv_only, encoders, msrvtt_root, monkeypatch):
    module = msrvtt.MsrVttDataModule(encoder=encoders[0], base_path=msrvtt_root,
                                     eval_batch_size=2, num_threads=2,
                                     eval_frame_cache_dir=str(tmp_path / "cache"),
                                     decode_short_side=None)
    opens = []
    from_path = VideoReader.from_path

    def counted(path, short_side=None):
        opens.append(path)
        return from_path(path, short_side=short_side)

    monkeypatch.setattr(VideoReader, "from_path", staticmethod(counted))
    cold = _drain(module.val_dataloader())
    assert len(opens) == 5

    def boom(*args, **kwargs):
        raise AssertionError("a video was opened on a warm cache")

    monkeypatch.setattr(VideoReader, "from_path", staticmethod(boom))
    warm = _drain(module.val_dataloader())
    for a, b in zip(cold, warm):
        np.testing.assert_array_equal(a["video"], b["video"])
        np.testing.assert_array_equal(a["text"], b["text"])
    assert module._dataset_kwargs(train=True)["frame_cache_dir"] is None
    assert module._dataset_kwargs(train=False)["frame_cache_dir"] == str(tmp_path / "cache")


def test_youcook2_clip_times_reach_the_key(tmp_path, opencv_only, encoders):
    root = tmp_path / "youcook2"
    rows = ["task,video_id,start,end,text"]
    _write_textured_video(root / "videos" / "0101" / "7.avi", num_frames=30, fps=10.0, seed=9)
    rows += ["0101,7,0.5,1.5,a person cooking", "0101,7,1.5,2.5,a person cooking"]
    (root / "val.csv").write_text("\n".join(rows) + "\n")
    common = dict(val_video_info_file_path=str(root / "val.csv"),
                  val_videos_folder=str(root / "videos"), eval_batch_size=2, num_threads=1)
    port = youcook2.YouCook2DataModule(encoder=encoders[0], **common,
                                       eval_frame_cache_dir=str(tmp_path / "port"))
    jax = jax_youcook2.YouCook2DataModule(encoder=encoders[1], **common,
                                          eval_frame_cache_dir=str(tmp_path / "jax"))
    _drain(port.val_dataloader())
    _drain(jax.val_dataloader())
    port_cache, jax_cache = _cache(tmp_path / "port"), _cache(tmp_path / "jax")
    assert len(port_cache) == 2 and list(port_cache) == list(jax_cache)
    names = list(port_cache)
    assert not np.array_equal(port_cache[names[0]], port_cache[names[1]])
    for name in names:
        np.testing.assert_array_equal(port_cache[name], jax_cache[name])
