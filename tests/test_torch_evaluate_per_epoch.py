"""The port's per-epoch evaluation loop (``python -m
fitclip_torch.cli.evaluate_per_epoch``, the counterpart of
scripts/evaluate_per_epoch.sh) and ``fitclip_torch.utils.subcorr`` (of
scripts/subcorr.py), on the CPU.

- The loop over two tiny checkpoints (the port's train-state files) and two
  tiny trees (MSR-VTT, and YouCook2, whose clip times are part of the cache
  key), with FRAME_CACHE set: the first checkpoint fills the cache, the second
  opens no video, and every job's metrics equal the same loop's with no cache.
  The tiny encoders take the configs' places through ``_target_`` overrides
  appended to the loop's own (the tiny CLIP's widths are not a released
  preset's, so ``clip_from_pretrained`` cannot infer them).
- ``subcorr``'s probabilities against the JAX script's math (JAX's encoder on
  the same checkpoint, softmax of cosine / temperature) at 1e-5, and its PNG.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip import load as jax_load
from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab
from fitclip_torch.cli import evaluate_per_epoch
from fitclip_torch.convert import prepare_trained_clip_checkpoint_for_evaluation as prepare
from fitclip_torch.convert.torch_state_dict import clip_params_from_torch, load_torch_state_dict
from fitclip_torch.data import video_reader
from fitclip_torch.data.transforms import eval_transform
from fitclip_torch.data.video_reader import VideoReader
from fitclip_torch.models.clip import load
from fitclip_torch.models.clip.model import CLIPConfig, TextConfig, VisionConfig
from fitclip_torch.training.checkpointing import save_checkpoint
from fitclip_torch.training.state import init_train_state, make_optimizer
from fitclip_torch.utils import subcorr

from tests.test_torch_cli import WORDS, _msrvtt_tree
from tests.test_torch_convert_state_dict import _save, openai_state_dict
from tests.test_torch_data import _write_textured_video
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def opencv_only():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(video_reader, "_native_reader", lambda: None)
        yield


def tiny_pretrained(bpe_path, vocab_path, num_frames=4, device="cpu", **_):
    """model1: the tiny CLIP from seed 0 (in place of the pretrained ViT-B/16)."""
    return load.load_tiny_test_encoder(num_frames=num_frames, seed=0, bpe_path=bpe_path,
                                       vocab_path=vocab_path, device=device)


def tiny_from_checkpoint(checkpoint_path, bpe_path, vocab_path, num_frames=4, device="cpu", **_):
    """model2: the tiny CLIP with a prepared (OpenAI-schema) state dict's weights."""
    loaded = tiny_pretrained(bpe_path, vocab_path, num_frames, device)
    model = loaded.encoder.model
    model.load_state_dict(clip_params_from_torch(load_torch_state_dict(checkpoint_path),
                                                 loaded.encoder.config))
    return loaded


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_tiny_test_vocab(str(tmp_path_factory.mktemp("vocab")), WORDS)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    msrvtt = _msrvtt_tree(root / "msrvtt", 5)
    rows = ["task,video_id,start,end,text"]
    for i, task in enumerate(("0101", "0101", "226")):
        _write_textured_video(root / "youcook2" / task / f"{i}.avi", num_frames=30, fps=10.0,
                              seed=60 + i)
        rows.append(f"{task},{i},{0.5 + i * 0.2},{2.0},a person cooking the {WORDS[i]}")
    rows.append("0101,0,1.5,2.5,the cat of a video")  # a second clip of one file
    (root / "youcook2.csv").write_text("\n".join(rows) + "\n")
    return {"MSRVTT_PATH": msrvtt, "YOUCOOK2_VAL_CSV": str(root / "youcook2.csv"),
            "YOUCOOK2_VAL_VIDEOS": str(root / "youcook2")}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, vocab):
    """Two train-state files of the tiny CLIP, as a run's per-epoch checkpoints."""
    merges, vocab_json = vocab
    root = tmp_path_factory.mktemp("ckpt")
    for epoch, seed in enumerate((1, 2)):
        encoder = load.load_tiny_test_encoder(seed=seed, bpe_path=merges, vocab_path=vocab_json,
                                              device="cpu").encoder
        save_checkpoint(str(root / f"epoch_{epoch}"),
                        init_train_state(encoder, make_optimizer(1e-3)))
    return str(root / "epoch_*")


def _tiny_overrides(vocab):
    merges, vocab_json = vocab
    out = ["+data.num_threads=2"]
    for slot, target in (("model1", "tiny_pretrained"), ("model2", "tiny_from_checkpoint")):
        out += [f"++encoder.{slot}._target_={__name__}.{target}",
                f"+encoder.{slot}.bpe_path={merges}", f"+encoder.{slot}.vocab_path={vocab_json}",
                f"++encoder.{slot}.device=cpu"]
    return out


def _printed_jobs(printed):
    """Every JSON object the jobs printed, in order."""
    decoder, jobs, at = json.JSONDecoder(), [], 0
    while (start := printed.find("{", at)) >= 0:
        value, at = decoder.raw_decode(printed, start)
        jobs.append(value)
    return jobs


def _run_loop(monkeypatch, capsys, env, vocab, frame_cache=None):
    """The loop as ``python -m`` runs it; returns (metrics per job, the videos
    opened while each checkpoint ran)."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if frame_cache:
        monkeypatch.setenv("FRAME_CACHE", frame_cache)
    else:
        monkeypatch.delenv("FRAME_CACHE", raising=False)
    opens, per_checkpoint = [], []
    from_path, prepare_main = VideoReader.from_path, prepare.main

    def counted(path, short_side=None):
        opens.append(path)
        return from_path(path, short_side=short_side)

    def prepare_counted(argv):
        per_checkpoint.append(len(opens))
        return prepare_main(argv)

    monkeypatch.setattr(VideoReader, "from_path", staticmethod(counted))
    monkeypatch.setattr(prepare, "main", prepare_counted)
    capsys.readouterr()
    level = logging.getLogger().level  # silent=true quiets the root logger
    try:
        evaluate_per_epoch.main(_tiny_overrides(vocab))
    finally:
        logging.getLogger().setLevel(level)
    per_checkpoint.append(len(opens))
    monkeypatch.setattr(VideoReader, "from_path", staticmethod(from_path))
    monkeypatch.setattr(prepare, "main", prepare_main)
    return _printed_jobs(capsys.readouterr().out), np.diff(per_checkpoint).tolist()


def test_overrides_are_the_shell_script_s():
    got = evaluate_per_epoch.wise_overrides("/tmp/p.pt", "0.4", "msrvtt,webvid", "/cache")
    assert got == ["command=evaluate", "encoder=wise", "+encoder@encoder.model1=clip_vit_b_16",
                   "+encoder@encoder.model2=clip_from_pretrained",
                   "++encoder.model2.checkpoint_path=/tmp/p.pt", "++encoder.weight_for_2=0.4",
                   "data=msrvtt,webvid", "++data.eval_frame_cache_dir=/cache", "silent=true"]
    assert "++data.eval_frame_cache_dir" not in " ".join(
        evaluate_per_epoch.wise_overrides("/tmp/p.pt", "0.4", "msrvtt", None))


def test_loop_with_the_cache_opens_no_video_after_the_first_checkpoint(
        tmp_path, monkeypatch, capsys, trees, checkpoints, vocab):
    env = {**trees, "CKPT_GLOB": checkpoints, "BENCHMARKS": "msrvtt,youcook2",
           "WISE_WEIGHT": "0.4"}
    cached, opens = _run_loop(monkeypatch, capsys, env, vocab, str(tmp_path / "cache"))
    assert opens == [5 + 4, 0]  # MSR-VTT's videos and YouCook2's rows, then none
    assert len(os.listdir(tmp_path / "cache")) == 9
    plain, plain_opens = _run_loop(monkeypatch, capsys, env, vocab)
    assert plain_opens == [9, 9]
    assert len(cached) == len(plain) == 4  # two checkpoints x two benchmarks
    assert cached == plain
    assert all(np.isfinite(v) for job in cached for v in job.values())
    # The two checkpoints' ensembles differ, so each job scored its own weights.
    assert cached[0] != cached[2] or cached[1] != cached[3]


def test_loop_refuses_a_glob_that_matches_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("CKPT_GLOB", str(tmp_path / "epoch_*"))
    with pytest.raises(SystemExit, match="matches no checkpoint"):
        evaluate_per_epoch.main([])


def _subcorr_config(vocab_size):
    # heads = width / 64, so that load_clip_encoder infers the config.
    return CLIPConfig(embed_dim=32,
                      vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                                          heads=1),
                      text=TextConfig(context_length=77, vocab_size=vocab_size, width=64,
                                      layers=2, heads=1))


def test_subcorr_probabilities_are_the_jax_script_s(tmp_path, vocab):
    merges, vocab_json = vocab
    vocab_size = len(json.loads(open(vocab_json).read()))
    checkpoint = _save(tmp_path / "clip.pt", openai_state_dict(_subcorr_config(vocab_size), 5))
    video = tmp_path / "clip.avi"
    _write_textured_video(video, num_frames=24, size=(48, 40), seed=11)
    texts = ["a cat", "a person doing the video", "the photo of a dog"]

    probs = subcorr.main([str(video), *texts, "--checkpoint-path", checkpoint,
                          "--bpe-path", merges, "--stride", "3", "--device", "cpu",
                          "--output", str(tmp_path / "subcorr.png")])

    ref = jax_load.load_clip_encoder(checkpoint_path=checkpoint, bpe_path=merges)
    encoder, params = ref.encoder, ref.params
    reader = VideoReader.from_path(str(video))
    frames = eval_transform(reader(list(range(0, len(reader), 3))), 32)
    frame_emb = np.asarray(jax.jit(encoder.encode_video)(params, jnp.asarray(frames[:, None])))
    ids = encoder.get_tokenizer()(texts)
    text_emb = np.asarray(jax.jit(encoder.encode_text)(params, jnp.asarray(ids)))
    scores = (frame_emb @ text_emb.T) / 0.015
    want = np.exp(scores - scores.max(1, keepdims=True))
    want = want / want.sum(1, keepdims=True)

    assert probs.shape == (8, 3)
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-5)
    import cv2

    image = cv2.imread(str(tmp_path / "subcorr.png"))
    assert image is not None and image.shape == (480, 1440, 3)
    assert len(np.unique(image.reshape(-1, 3), axis=0)) > 3  # lines drawn, not a blank canvas
