"""The port's last single-device utilities against the JAX package's:
``utils/viz.py`` (``denormalize_video``, ``make_image_grid``, ``debug_batch``)
and ``utils/profiling.py`` (``StageTimer``, ``device_trace``)."""

import json

import numpy as np
import pytest

from fitclip_tpu.utils import profiling as jax_profiling
from fitclip_tpu.utils import viz as jax_viz
from fitclip_torch.utils import profiling, viz

MEAN, STD = (0.48, 0.46, 0.41), (0.27, 0.26, 0.28)


@pytest.mark.parametrize("scale_255", [True, False])
def test_denormalize_video_is_jax_bit_for_bit(scale_255):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 3, 8, 8, 3), dtype=np.uint8)
    pixels = frames.astype(np.float32) / (255.0 if scale_255 else 1.0)
    normalized = (pixels - np.asarray(MEAN, np.float32)) / np.asarray(STD, np.float32)
    got = viz.denormalize_video(normalized, MEAN, STD)
    np.testing.assert_array_equal(got, jax_viz.denormalize_video(normalized, MEAN, STD))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(viz.denormalize_video(frames, MEAN, STD), frames)


@pytest.mark.parametrize("columns,padding", [(None, 2), (2, 1), (3, 0)])
def test_make_image_grid_is_jax_bit_for_bit(columns, padding):
    images = np.random.default_rng(1).integers(0, 256, (5, 6, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(viz.make_image_grid(images, columns, padding),
                                  jax_viz.make_image_grid(images, columns, padding))


def test_debug_batch_writes_png_and_prints_captions(tmp_path, capsys):
    import cv2
    import torch

    from fitclip_torch.models.clip.load import load_tiny_test_encoder
    from fitclip_torch.models.clip.tokenizer import write_tiny_test_vocab

    merges, vocab = write_tiny_test_vocab(str(tmp_path), ["a", "cat", "video"] * 3)
    encoder = load_tiny_test_encoder(bpe_path=merges, vocab_path=vocab, device="cpu").encoder
    size = encoder.preprocess.image_size
    video = np.random.default_rng(0).integers(0, 256, (2, 2, size, size, 3), dtype=np.uint8)
    text = encoder.get_tokenizer()(["a cat video", "a video"])
    out = str(tmp_path / "grid.png")
    grid = viz.debug_batch(torch.from_numpy(video), torch.from_numpy(text), encoder,
                           output_path=out)
    np.testing.assert_array_equal(grid, jax_viz.make_image_grid(
        video.reshape(4, size, size, 3), num_columns=2))
    np.testing.assert_array_equal(cv2.imread(out)[..., ::-1], grid)
    printed = capsys.readouterr().out.splitlines()
    assert printed == list(encoder.decode_text(text))
    assert "a cat video" in printed[0] and "a video" in printed[1]


def test_stage_timer_summary_and_report_match_jax(monkeypatch):
    """The same stages on the same clock give JAX's summary and report."""
    ticks = iter(np.arange(0.0, 10.0, 0.0125))
    clock = lambda: float(next(ticks))  # noqa: E731
    timers = []
    for module in (profiling, jax_profiling):
        monkeypatch.setattr(module.time, "perf_counter", clock)
        timer = module.StageTimer()
        for name in ("decode", "decode", "collate"):
            with timer.stage(name):
                pass
        timers.append(timer)
    port, ref = timers
    assert port.summary() == pytest.approx(ref.summary())
    assert port.summary() == pytest.approx({"decode": 0.0125, "collate": 0.0125})
    assert port.report() == ref.report() == \
        "collate: 12.5ms avg (1x) | decode: 12.5ms avg (2x)"


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    with profiling.device_trace(None):  # no directory: nothing to do
        pass
