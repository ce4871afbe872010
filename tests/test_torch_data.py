"""fitclip_torch/data/ against the JAX package's data layer, on videos the
tests write: frame indices of every sampler, decoded and eval-transformed
frames bit for bit, dataset items and loader batches (order, padding, the
short last batch), the msrvtt, ucf and kinetics modules on fixture trees,
every encoder's PreprocessSpec, and a reader whose backend is missing.

Both packages decode with OpenCV here: the JAX package's native decoder is
not built in this checkout, so the port's is switched off for the parity
tests (``opencv_only``)."""

import dataclasses
import json
import sys

import numpy as np
import pytest

from fitclip_tpu.data import frame_sampler as jax_fs
from fitclip_tpu.data import loader as jax_loader
from fitclip_tpu.data import transforms as jax_tf
from fitclip_tpu.data import video_reader as jax_vr
from fitclip_tpu.data.datasets import kinetics as jax_kinetics
from fitclip_tpu.data.datasets import msrvtt as jax_msrvtt
from fitclip_tpu.data.datasets import ucf as jax_ucf
from fitclip_tpu.models.clip import load as jax_load
from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab
from fitclip_torch.data import frame_sampler as fs
from fitclip_torch.data import loader
from fitclip_torch.data import transforms as tf
from fitclip_torch.data import video_reader as vr
from fitclip_torch.data.datasets import kinetics, msrvtt, ucf
from fitclip_torch.models.clip import load
from fitclip_torch.utils.tensor import pad_axis_to, stack_padded

from tests.test_datasets import _write_video


def _write_textured_video(path, num_frames=20, size=(64, 48), seed=0, fps=10.0):
    """Seeded random content (a low-resolution image upscaled, drifting), MJPG AVI."""
    import cv2

    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8), size,
                      interpolation=cv2.INTER_LINEAR)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, size)
    assert writer.isOpened()
    for t in range(num_frames):
        writer.write(np.roll(base, (t, 2 * t), axis=(0, 1)))
    writer.release()


_NATIVE_READER = vr._native_reader


@pytest.fixture(scope="module", autouse=True)
def opencv_only():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vr, "_native_reader", lambda: None)
        yield


def test_samplers_match_jax():
    rng = np.random.default_rng(0)
    pairs = [(fs.UniformFrameSampler(4), jax_fs.UniformFrameSampler(4)),
             (fs.UniformFrameSampler(8), jax_fs.UniformFrameSampler(8)),
             (fs.FixedFrameFromUniformIntervalsFrameSampler(4, 1),
              jax_fs.FixedFrameFromUniformIntervalsFrameSampler(4, 1)),
             (fs.ConsecutiveFrameSampler(16, fps=5), jax_fs.ConsecutiveFrameSampler(16, fps=5)),
             (fs.ConsecutiveFrameSampler(32, fps=30), jax_fs.ConsecutiveFrameSampler(32, fps=30)),
             (fs.ConsecutiveFrameSampler(8), jax_fs.ConsecutiveFrameSampler(8)),
             (fs.RandomFromUniformIntervalsFrameSampler(4),
              jax_fs.RandomFromUniformIntervalsFrameSampler(4))]
    for _ in range(200):
        start = int(rng.integers(0, 50))
        end = start + int(rng.integers(0, 400))
        fps = float(rng.choice([5.0, 8.0, 23.976, 25.0, 29.97, 30.0, 60.0]))
        seed = int(rng.integers(0, 2 ** 31))
        for port, ref in pairs:
            got = port(start, end, fps, rng=np.random.default_rng(seed))
            want = ref(start, end, fps, rng=np.random.default_rng(seed))
            assert list(got) == list(want), (type(port).__name__, start, end, fps)
        for new_fps in (1, 5, 7.5, 30):
            assert list(fs.resample_indices(16, fps, new_fps)) == \
                list(jax_fs.resample_indices(16, fps, new_fps))


def test_tensor_helpers():
    a, b = np.ones((2, 3), np.uint8), np.ones((4, 3), np.uint8)
    np.testing.assert_array_equal(pad_axis_to(a, 4, value=7)[2:], np.full((2, 3), 7))
    assert pad_axis_to(b, 2) is b
    stacked = stack_padded([a, b])
    assert stacked.shape == (2, 4, 3) and stacked[0, 2:].sum() == 0


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    paths = {"gray": root / "gray.avi", "mp4": root / "gray.mp4",
             "textured": root / "textured.avi", "tall": root / "tall.avi"}
    _write_video(str(paths["gray"]))
    _write_video(str(paths["mp4"]))
    _write_textured_video(paths["textured"], seed=1)
    _write_textured_video(paths["tall"], size=(40, 72), seed=2)
    (root / "corrupt.avi").write_bytes(b"RIFF\x00\x00\x00\x00AVI garbage" * 10)
    paths["corrupt"] = root / "corrupt.avi"
    return paths


def test_readers_decode_as_jax(videos):
    for name, path in videos.items():
        port, ref = vr.VideoReader.from_path(path), jax_vr.VideoReader.from_path(path)
        assert type(port).__name__ == type(ref).__name__ == "OpenCVVideoReader"
        assert len(port) == len(ref) and port.get_avg_fps() == ref.get_avg_fps()
        assert port.ok == ref.ok == (name != "corrupt")
        indices = [0, 3, 1, 3, len(ref) - 1]
        np.testing.assert_array_equal(port(indices), ref(indices))
        times = [0.0, 0.05, 0.4, 100.0]
        np.testing.assert_array_equal(port.time_to_indices(times), ref.time_to_indices(times))
    assert not vr.VideoReader.from_path(videos["corrupt"])([0, 1]).any()


@pytest.mark.parametrize("mode", ["bicubic", "bilinear"])
def test_transforms_match_jax_bit_for_bit(videos, mode):
    for name in ("textured", "tall"):
        frames = vr.VideoReader.from_path(videos[name])([0, 5, 9, 13])
        for size in (32, 24, 224):
            np.testing.assert_array_equal(tf.eval_transform(frames, size, mode),
                                          jax_tf.eval_transform(frames, size, mode))
        for seed in range(5):
            np.testing.assert_array_equal(
                tf.train_transform(frames, 32, np.random.default_rng(seed)),
                jax_tf.train_transform(frames, 32, np.random.default_rng(seed)))
    short = frames[:2]
    np.testing.assert_array_equal(tf.pad_to_min_frames(short, 5),
                                  jax_tf.pad_to_min_frames(short, 5))
    assert tf.max_frames(frames, 3).shape[0] == 3


def test_a_missing_backend_raises(videos, monkeypatch):
    """No native decoder and no cv2 is not a corrupt file: from_path raises."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="no video decoder"):
        vr.VideoReader.from_path(videos["textured"])
    with pytest.raises(RuntimeError, match="no video decoder"):
        vr.VideoReader.from_path(videos["textured"].with_suffix(".jpg"))([0])


def test_the_native_decoder_reads_what_opencv_reads(videos):
    """Where the native decoder builds (libav present), it reads the frame
    count and geometry OpenCV reads, and a corrupt file as zeros."""
    from fitclip_torch.data import native

    try:
        native.load_decoder()
    except ImportError as e:
        pytest.skip(f"the native decoder does not build here: {str(e).splitlines()[0]}")
    reader = native.NativeVideoReader(videos["textured"])
    cv = vr.OpenCVVideoReader(videos["textured"])
    assert reader.ok and len(reader) == len(cv)
    frames, want = reader([0, 4, 9]), cv([0, 4, 9])
    assert frames.shape == want.shape
    assert np.abs(frames.astype(int) - want.astype(int)).mean() < 8
    corrupt = native.NativeVideoReader(videos["corrupt"])
    assert not corrupt.ok and not corrupt([0, 1]).any()


def test_loader_threads_build_the_native_decoder_once(videos, tmp_path, monkeypatch):
    """Eight threads opening readers at once on an empty build directory (the
    loader's pool on its first batch): one builds, all take its outcome, so
    every thread decodes with the same backend and no partial file is left."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from fitclip_torch.data import native

    monkeypatch.setattr(vr, "_native_reader", _NATIVE_READER)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "decoder")
    monkeypatch.setattr(native, "_OUTCOME", [])
    builds = []
    build = native.build_decoder
    monkeypatch.setattr(native, "build_decoder", lambda: builds.append(1) or build())
    start = threading.Barrier(8)

    def read(_):
        start.wait()
        reader = vr.VideoReader.from_path(videos["textured"])
        return type(reader).__name__, reader([0, 4, 9])

    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(read, range(8)))
    assert len(builds) == 1
    assert len({name for name, _ in results}) == 1
    for _, frames in results[1:]:
        np.testing.assert_array_equal(frames, results[0][1])
    assert not list(tmp_path.rglob("*.partial"))


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_tiny_test_vocab(str(tmp_path_factory.mktemp("vocab")),
                                 ["a", "cat", "video", "of", "person"] * 3)


@pytest.fixture(scope="module")
def encoders(vocab):
    merges, vocab_json = vocab
    return (load.load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab_json, device="cpu"),
            jax_load.load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab_json))


def _assert_same_batches(port_batches, jax_batches):
    assert len(port_batches) == len(jax_batches)
    for got, want in zip(port_batches, jax_batches):
        assert sorted(got) == sorted(want)
        for key in want:
            if isinstance(want[key], np.ndarray):
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            else:
                assert got[key] == want[key], key


@pytest.fixture(scope="module")
def msrvtt_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("msrvtt")
    for i in range(7):
        _write_textured_video(root / "videos" / "all" / f"video{i}.avi", num_frames=12 + i,
                              seed=10 + i)
    (root / "structured-symlinks").mkdir()
    (root / "structured-symlinks" / "val_list_jsfusion.txt").write_text(
        "\n".join(f"video{i}" for i in range(5)))
    (root / "structured-symlinks" / "train_list_jsfusion.txt").write_text(
        "\n".join(f"video{i}" for i in range(2, 7)))
    (root / "annotation").mkdir()
    annotations = [{"image_id": f"video{i}", "caption": f"a cat video of {i}"} for i in range(7)]
    annotations += [{"image_id": f"video{i}", "caption": f"a person {i}"} for i in range(7)]
    (root / "annotation" / "MSR_VTT.json").write_text(json.dumps({"annotations": annotations}))
    return str(root)


def test_msrvtt_loaders_match_jax(encoders, msrvtt_root):
    """Eval: 5 videos in batches of 2 (the last one short), the first caption;
    train: shuffled, random captions and crops from per-item RNGs, drop_last."""
    port_enc, jax_enc = encoders
    kwargs = dict(base_path=msrvtt_root, eval_batch_size=2, batch_size=2, num_threads=3)
    port_dm = msrvtt.MsrVttDataModule(encoder=port_enc, **kwargs)
    jax_dm = jax_msrvtt.MsrVttDataModule(encoder=jax_enc, **kwargs)
    port_val, jax_val = list(port_dm.val_dataloader()), list(jax_dm.val_dataloader())
    _assert_same_batches(port_val, jax_val)
    assert [b["video"].shape[0] for b in port_val] == [2, 2, 1]
    assert port_val[0]["video"].shape == (2, 4, 32, 32, 3)
    assert port_val[0]["video_id"] == ["video0", "video1"]
    decoded = list(port_enc.decode_text(port_val[0]["text"]))
    assert decoded == list(jax_enc.encoder.decode_text(port_val[0]["text"]))
    assert decoded[0] == "<|startoftext|>a cat video of 0 <|endoftext|>"
    for epoch in (0, 1):
        port_train, jax_train = port_dm.train_dataloader(), jax_dm.train_dataloader()
        port_train.set_epoch(epoch)
        jax_train.set_epoch(epoch)
        assert len(port_train) == len(jax_train) == 2
        _assert_same_batches(list(port_train), list(jax_train))
    dataset = port_dm.val_dataloader().dataset
    item = dataset.__getitem__(3, rng=loader.item_rng(42, 0, 3))
    ref = jax_dm.val_dataloader().dataset.__getitem__(3, rng=jax_loader.item_rng(42, 0, 3))
    assert item["target"] == ref["target"] and item["video_id"] == ref["video_id"]
    np.testing.assert_array_equal(item["video"], ref["video"])


def test_collator_pads_variable_frames_as_jax(encoders):
    from fitclip_tpu.data.video_dataset import Collator as JaxCollator
    from fitclip_torch.data.video_dataset import Collator

    port_enc, jax_enc = encoders
    rng = np.random.default_rng(0)
    items = [{"video": rng.integers(0, 255, (n, 8, 8, 3), dtype=np.uint8),
              "target": f"a cat {n}", "video_id": f"v{n}", "index": n} for n in (2, 4, 3)]
    for pad in (True, False):
        if not pad:
            items = [dict(it, video=it["video"][:2]) for it in items]
        got = Collator(tokenizers=port_enc.get_tokenizer(), pad_batch=pad)(items)
        want = JaxCollator(tokenizers=jax_enc.get_tokenizer(), pad_batch=pad)(items)
        _assert_same_batches([got], [want])
    got = Collator(tokenizers={"student": port_enc.get_tokenizer(),
                               "teacher": port_enc.get_tokenizer()})(items)
    assert {"text_student", "text_teacher"} <= set(got)


@pytest.fixture(scope="module")
def ucf_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ucf")
    categories = ["ApplyEyeMakeup", "Basketball", "YoYo"]
    (root / "classInd.txt").write_text(
        "\n".join(f"{i + 1} {c}" for i, c in enumerate(categories)))
    lines = []
    for i, category in enumerate(categories):
        for g in range(2):
            rel = f"{category}/v_{category}_g0{g}_c01.avi"
            _write_textured_video(root / "videos" / rel, seed=20 + 2 * i + g)
            lines.append(f"{rel} {i + 1}")
    (root / "testlist01.txt").write_text("\n".join(lines))
    return root


def ucf_kwargs(root):
    return dict(categories_file_path=str(root / "classInd.txt"),
                val_file_list_path=str(root / "testlist01.txt"),
                val_videos_folder=str(root / "videos"))


def test_ucf_module_matches_jax(encoders, ucf_root):
    port_enc, jax_enc = encoders
    port_dm = ucf.UcfDataModule(encoder=port_enc, eval_batch_size=4, num_threads=2,
                                **ucf_kwargs(ucf_root))
    jax_dm = jax_ucf.UcfDataModule(encoder=jax_enc, eval_batch_size=4, num_threads=2,
                                   **ucf_kwargs(ucf_root))
    assert port_dm.categories == jax_dm.categories == \
        {"Apply Eye Makeup": 0, "Basketball": 1, "Yo Yo": 2}
    assert port_dm.templates == jax_dm.templates and len(port_dm.templates) == 48
    batches = list(port_dm.val_dataloader())
    _assert_same_batches(batches, list(jax_dm.val_dataloader()))
    assert batches[0]["label"].tolist() == [0, 0, 1, 1]


@pytest.fixture(scope="module")
def kinetics_root(tmp_path_factory):
    """Categories, CSVs and video folders for val and test (different videos)."""
    root = tmp_path_factory.mktemp("kinetics")
    categories = ["abseiling", "air drumming", "yoga"]
    (root / "categories.txt").write_text("\n".join(categories) + "\n")
    for split, offset in (("val", 0), ("test", 10)):
        rows = ["label,youtube_id,time_start,time_end,split"]
        for i in range(4):
            label = categories[(i + offset) % 3]
            youtube_id = f"yt{split}{i}"
            start, end = 10 * i, 10 * i + 10
            rows.append(f"{label},{youtube_id},{start},{end},{split}")
            _write_textured_video(root / split / f"{youtube_id}_{start:06}_{end:06}.mp4",
                                  seed=30 + offset + i)
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")
    return root


def kinetics_kwargs(root):
    return dict(categories_file_path=str(root / "categories.txt"),
                val_video_info_file_path=str(root / "val.csv"),
                val_videos_folder=str(root / "val"),
                test_video_info_file_path=str(root / "test.csv"),
                test_videos_folder=str(root / "test"))


@pytest.mark.parametrize("filter_from_info", [False, True])
def test_kinetics_module_matches_jax(encoders, kinetics_root, filter_from_info):
    port_enc, jax_enc = encoders
    kwargs = dict(kinetics_kwargs(kinetics_root), eval_batch_size=3, num_threads=2,
                  val_filter_videos_from_info_file=filter_from_info,
                  test_filter_videos_from_info_file=filter_from_info)
    port_dm = kinetics.KineticsDataModule(encoder=port_enc, **kwargs)
    jax_dm = jax_kinetics.KineticsDataModule(encoder=jax_enc, **kwargs)
    assert port_dm.categories == jax_dm.categories
    assert port_dm.templates == jax_dm.templates and len(port_dm.templates) == 28
    for port_loader, jax_loader_ in ((port_dm.val_dataloader(), jax_dm.val_dataloader()),
                                     (port_dm.test_dataloader(), jax_dm.test_dataloader())):
        _assert_same_batches(list(port_loader), list(jax_loader_))


def _spec(spec):
    """A PreprocessSpec as comparable fields, samplers by type and state."""
    out = {}
    for field in dataclasses.fields(spec):
        value = getattr(spec, field.name)
        if callable(value):
            value = (type(value).__name__ if hasattr(value, "__dict__") and
                     not callable(getattr(value, "__func__", None)) else value.__name__,
                     vars(value) if hasattr(value, "__dict__") and
                     type(value).__name__ != "function" else None)
        out[field.name] = value
    return out


def test_every_encoder_exposes_the_jax_preprocess(encoders):
    from fitclip_tpu.models.frozen_in_time.encoder import (
        FrozenInTimeConfig as JaxFitConfig, FrozenInTimeVideoTextEncoder as JaxFit)
    from fitclip_tpu.models.mil_nce import MilNceVideoTextEncoder as JaxMilNce
    from fitclip_tpu.models.slip import SlipConfig as JaxSlipConfig
    from fitclip_tpu.models.slip import SlipVideoTextEncoder as JaxSlip
    from fitclip_tpu.models.videoclip import BertConfig as JaxBertConfig
    from fitclip_tpu.models.videoclip import VideoClipVideoTextEncoder as JaxVideoClip
    from fitclip_torch.models.frozen_in_time.encoder import (FrozenInTimeConfig,
                                                             FrozenInTimeVideoTextEncoder)
    from fitclip_torch.models.mil_nce import MilNceVideoTextEncoder
    from fitclip_torch.models.slip import SlipConfig, SlipVideoTextEncoder
    from fitclip_torch.models.videoclip import BertConfig, VideoClipVideoTextEncoder

    port_clip, jax_clip = encoders
    pairs = [
        (port_clip.preprocess, jax_clip.preprocess),
        (SlipVideoTextEncoder(SlipConfig.tiny_test(), num_frames=3).preprocess,
         JaxSlip(JaxSlipConfig.tiny_test(), num_frames=3).preprocess),
        (FrozenInTimeVideoTextEncoder(FrozenInTimeConfig.tiny_test(), num_frames=2,
                                      max_tokens=20).preprocess,
         JaxFit(JaxFitConfig.tiny_test(), num_frames=2, max_tokens=20).preprocess),
        (MilNceVideoTextEncoder(vocab_size=50, num_frames=8, max_tokens=12).preprocess,
         JaxMilNce(vocab_size=50, num_frames=8, max_tokens=12).preprocess),
        (VideoClipVideoTextEncoder(BertConfig.tiny_test(), num_frames=16,
                                   max_tokens=24).preprocess,
         JaxVideoClip(JaxBertConfig.tiny_test(), num_frames=16, max_tokens=24).preprocess),
    ]
    for port_spec, jax_spec in pairs:
        assert _spec(port_spec) == _spec(jax_spec)
        assert type(port_spec.eval_frame_sampler).__module__.startswith("fitclip_torch.")
