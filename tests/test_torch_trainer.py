"""fitclip_torch's training loop through ``run_train``, on an in-memory loader.

- resume: 3 steps (a mid-epoch stop), save, restore, then on to 8 equals 8
  straight steps bit for bit (params, moments, count, step), in both modes;
- early stopping, the best-by-monitor and every-N-epochs checkpoints, the
  sidecar, max_steps;
- the refusals: an int8 or fused_block student, and a prompts file without
  a BPE merges file for the tokenizer.
"""

import json

import numpy as np
import pytest
import torch

from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.load import LoadedEncoder
from fitclip_torch.models.clip.model import CLIPConfig, init_float_params
from fitclip_torch.training.checkpointing import (is_full_train_state, load_checkpoint,
                                                  load_trainer_state)
from fitclip_torch.training.train_runner import run_train
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

FRAMES = 2


class InMemoryLoader:
    """Batches in an order fixed by the epoch (as the repo's loaders shuffle)."""

    def __init__(self, batches):
        self.batches, self.epoch = batches, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        order = np.random.default_rng(self.epoch).permutation(len(self.batches))
        return iter([self.batches[i] for i in order])


class DataModule:
    def __init__(self, train, val=None):
        self.train, self.val = train, val

    def train_dataloader(self):
        return InMemoryLoader(self.train)

    def val_dataloader(self):
        if self.val is None:
            raise NotImplementedError
        return self.val


def _clip_text(rng, n):
    return {"video": rng.integers(0, 256, size=(n, FRAMES, 32, 32, 3), dtype=np.uint8),
            "text": rng.integers(1, 60, size=(n, 16)).astype(np.int64),
            "video_id": [f"v{i}" for i in range(n)]}  # host metadata, never moved


def _teacher_student(rng, n):
    def sub():
        return {"video_student": rng.integers(0, 256, size=(n, FRAMES, 32, 32, 3), dtype=np.uint8),
                "text_student": rng.integers(1, 60, size=(n, 16)).astype(np.int64),
                "video_teacher": rng.integers(0, 256, size=(n, FRAMES, 32, 32, 3), dtype=np.uint8),
                "text_teacher": rng.integers(1, 60, size=(n, 16)).astype(np.int64)}
    return {"labeled": sub(), "unlabeled": sub()}


def _encoder(seed, **kwargs):
    enc = ClipVideoTextEncoder(CLIPConfig.tiny_test(), num_frames=FRAMES, **kwargs)
    if not enc.quantized:
        init_float_params(enc.model, seed)
    return LoadedEncoder(enc)


def _slot(mode):
    if mode == "contrastive":
        return _encoder(0)
    return {"student": _encoder(0), "teacher": _encoder(1)}


def _train(mode, workdir, max_steps=None, checkpoint_path=None):
    rng = np.random.default_rng(0)
    make = _clip_text if mode == "contrastive" else _teacher_student
    data = DataModule([make(rng, 2) for _ in range(4)])
    trainer_cfg = {"max_epochs": 2, "log_every_n_steps": 1}
    if max_steps:
        trainer_cfg["max_steps"] = max_steps
    callbacks = {"checkpoint": {"dirpath": str(workdir / "ckpt"), "monitor": None,
                                "every_n_epochs": 0}}
    run_train(_slot(mode), data, {"init_temperature": 0.05, "labeled_dataset_loss_share": 0.7},
              trainer_cfg, {"lr": 1e-3, "moment_dtype": "bfloat16"}, callbacks,
              log_dir=str(workdir / "logs"), checkpoint_path=checkpoint_path)
    return str(workdir / "ckpt" / "last")


@pytest.mark.parametrize("mode", ["contrastive", "teacher_student"])
def test_resume_is_bit_identical_to_a_straight_run(tmp_path, mode):
    straight = load_checkpoint(_train(mode, tmp_path / "straight"))
    assert straight["step"] == 8

    last = _train(mode, tmp_path / "resumed", max_steps=3)  # stops mid-epoch
    assert is_full_train_state(last)
    assert load_checkpoint(last)["step"] == 3
    resumed = load_checkpoint(_train(mode, tmp_path / "resumed", max_steps=8,
                                     checkpoint_path=last))
    assert resumed["step"] == 8 and resumed["opt_state"]["count"] == 8
    assert set(resumed["params"]) == set(straight["params"])
    if mode == "teacher_student":
        assert "ts_logit_scale" in resumed["params"]
    for name, value in straight["params"].items():
        assert torch.equal(resumed["params"][name], value), name
        for key in ("mu", "nu"):
            assert torch.equal(resumed["opt_state"][key][name], straight["opt_state"][key][name])
    logged = [json.loads(line) for line in (tmp_path / "straight" / "logs" / "metrics.jsonl")
              .read_text().splitlines()]
    assert [entry["step"] for entry in logged] == list(range(1, 9))
    assert all(np.isfinite(entry["loss/train"]) for entry in logged)


def test_early_stopping_and_best_checkpoint(tmp_path):
    rng = np.random.default_rng(1)
    # One val loader (a list would be a list of loaders, one per dataset).
    data = DataModule([_clip_text(rng, 2) for _ in range(2)],
                      val=InMemoryLoader([_clip_text(rng, 3)]))
    callbacks = {"early_stopping": {"monitor": "mr", "mode": "min", "patience": 0},
                 "checkpoint": {"dirpath": str(tmp_path), "monitor": "r1", "mode": "max",
                                "every_n_epochs": 1}}
    # lr 0: the params never move, so the validation metrics never improve.
    out = run_train(_encoder(0), data, {}, {"max_epochs": 5}, {"lr": 0.0}, callbacks)
    assert out["state"].step == 4  # two epochs: one sets the best, one stops
    assert set(out["metrics"]) == {"r1", "r5", "r10", "mr"}
    for name in ("best", "epoch_1", "epoch_2", "last"):
        assert is_full_train_state(str(tmp_path / name)), name
    assert not (tmp_path / "epoch_3").exists()
    sidecar = load_trainer_state(str(tmp_path / "best"))
    assert sidecar["best_monitor"] == out["metrics"]["r1"]
    assert sidecar["early_stopping_bad_checks"] == 0


def test_max_steps_stops_inside_an_epoch(tmp_path):
    rng = np.random.default_rng(2)
    out = run_train(_encoder(0), DataModule([_clip_text(rng, 2) for _ in range(4)]), {},
                    {"max_epochs": 3, "max_steps": 5}, {"lr": 1e-3}, None)
    assert out["state"].step == 5 and out["state"].opt_state["count"] == 5


@pytest.mark.parametrize("kwargs,match", [
    (dict(quantized=True), "int8"),
    (dict(fused_block=True), "fused_block")])
def test_untrainable_student_slots_are_refused(kwargs, match):
    data = DataModule([])
    with pytest.raises(ValueError, match=match):
        run_train(_encoder(0, **kwargs), data, {}, {}, {})
    with pytest.raises(ValueError, match=match):
        run_train({"student": _encoder(0, **kwargs), "teacher": _encoder(1)}, data, {}, {}, {})


def test_prompts_need_the_tokenizer(tmp_path, monkeypatch):
    """prompts_path is tokenized by each tower's CLIP tokenizer before any
    step: without a BPE merges file that fails (the ids themselves are held to
    JAX's in tests/test_torch_tokenizer.py)."""
    monkeypatch.delenv("FITCLIP_BPE_PATH", raising=False)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a video of a cat\n")
    with pytest.raises(FileNotFoundError, match="BPE"):
        run_train({"student": _encoder(0), "teacher": _encoder(1)}, DataModule([]), {}, {}, {},
                  prompts_path=str(prompts))
