"""command=tune: the batch-size and learning-rate searches (port of
``fitclip_tpu/cli/tune.py``; the PL ``trainer.tune()`` the reference exposes,
__main__.py:55-63), over the port's contrastive train step on the encoder's
device:

- **Batch-size scaling** (PL ``scale_batch_size``, power mode): double the
  batch until a step runs out of device memory or the trial cap is hit, and
  suggest the last size that ran. One real batch is tiled to each size, so the
  search measures training's own memory. Only ``torch.OutOfMemoryError`` ends
  the search: a failed kernel build or launch propagates.
- **LR range test** (PL ``lr_find``, Leslie Smith): AdamW whose learning rate
  is a geometric per-step schedule lr_min -> lr_max, run over real batches;
  the loss is smoothed, the test stops on divergence (smoothed loss past 4x
  its best), and the suggestion is the LR at the smoothed curve's steepest
  descent.

The port's step updates its parameters in place, so each search trains a
copy of the encoder and frees it, with its optimizer state and the
allocator's cached blocks, before the next begins: the encoder itself is left
as it was.
"""

import copy
import gc
import logging
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from fitclip_torch.training.state import init_train_state, make_optimizer
from fitclip_torch.training.steps import make_contrastive_train_step
from fitclip_torch.training.train_runner import make_batch_preparer
from fitclip_torch.utils.precision import training_convolutions

LOGGER = logging.getLogger(__name__)


def _video_text(batch) -> Dict[str, np.ndarray]:
    video = batch.get("video", batch.get("video_student"))
    text = batch.get("text", batch.get("text_student"))
    if video is None or text is None:
        raise ValueError(f"tune needs a video+text train batch; got keys {sorted(batch)}")
    return {"video": np.asarray(video), "text": np.asarray(text)}


def _first_batch(data_module) -> Dict[str, np.ndarray]:
    for batch in data_module.train_dataloader():
        return _video_text(batch)
    raise ValueError("empty train dataloader")


def _tile_to(batch: Mapping[str, np.ndarray], size: int) -> Dict[str, np.ndarray]:
    return {key: np.concatenate([value] * -(-size // value.shape[0]), axis=0)[:size]
            for key, value in batch.items()}


def _device(encoder) -> torch.device:
    return next(encoder.parameters()).device


def _release(device: torch.device) -> None:
    """Free what the last trial left: unreachable tensors, then the
    allocator's cached blocks."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class _Trainee:
    """A copy of the encoder with a fresh train state and contrastive step."""

    def __init__(self, loaded, learning_rate):
        self.encoder = copy.deepcopy(loaded.encoder)
        self.optimizer = make_optimizer(learning_rate)
        self.state = init_train_state(self.encoder, self.optimizer)
        self.step = make_contrastive_train_step(self.encoder, self.optimizer)
        self.prepare = make_batch_preparer(_device(self.encoder))

    def loss(self, batch: Mapping[str, np.ndarray]) -> float:
        """One train step; its loss (waits for the device)."""
        self.state, metrics = self.step(self.state, self.prepare(batch))
        return float(metrics["loss/train"])


def scale_batch_size(loaded, batch: Mapping[str, np.ndarray], init_size: int = 2,
                     max_trials: int = 8) -> int:
    """Doubling search: the largest batch size whose train step ran."""
    device = _device(loaded.encoder)
    trainee = _Trainee(loaded, 1e-4)
    best, size = 0, init_size
    try:
        for _ in range(max_trials):
            candidate = _tile_to(batch, size)
            try:
                trainee.loss(candidate)
            except torch.OutOfMemoryError:
                LOGGER.info("batch_size=%d ran out of device memory; stopping the search",
                            size)
                break
            best = size
            LOGGER.info("batch_size=%d fits", size)
            size *= 2
    finally:
        del trainee
        _release(device)
    return best


def lr_find(loaded, data_module, lr_min: float = 1e-8, lr_max: float = 1.0,
            num_steps: int = 100, smoothing: float = 0.05,
            diverge_factor: float = 4.0) -> Dict[str, Any]:
    """LR range test: {"lr": suggestion, "losses": smoothed, "lrs": [...]}."""
    ratio = (lr_max / lr_min) ** (1.0 / max(num_steps - 1, 1))

    def schedule(count):
        return lr_min * ratio ** count

    device = _device(loaded.encoder)
    trainee = _Trainee(loaded, schedule)
    losses, lrs = [], []
    smoothed, best, i = None, math.inf, 0
    try:
        while i < num_steps:
            for batch in data_module.train_dataloader():
                if i >= num_steps:
                    break
                loss = trainee.loss(_video_text(batch))
                if not math.isfinite(loss):
                    LOGGER.info("lr_find: non-finite loss at lr=%.3g; stopping", schedule(i))
                    i = num_steps
                    break
                smoothed = loss if smoothed is None else (
                    smoothing * loss + (1 - smoothing) * smoothed)
                losses.append(smoothed)
                lrs.append(float(schedule(i)))
                best = min(best, smoothed)
                if smoothed > diverge_factor * best and i > num_steps // 10:
                    LOGGER.info("lr_find: diverged at lr=%.3g (loss %.3g > %gx best)",
                                lrs[-1], smoothed, diverge_factor)
                    i = num_steps
                    break
                i += 1
            else:
                continue
            break
    finally:
        del trainee
        _release(device)

    if len(losses) < 3:
        raise ValueError("lr_find collected too few points; is the train dataloader empty?")
    # PL's suggestion(): the LR at the steepest negative gradient of the
    # smoothed loss, past the first and before the last tenth.
    gradient = np.gradient(np.asarray(losses))
    skip = max(1, len(losses) // 10)
    window = gradient[skip:len(gradient) - skip or None]
    index = int(np.argmin(window)) + skip
    return {"lr": lrs[index], "losses": losses, "lrs": lrs}


def run_tune(encoder_slot, data_module, trainer_cfg: Mapping[str, Any],
             tune_cfg: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """{"batch_size": int, "lr": float} suggestions (the CLI prints them). The
    caller refuses a checkpoint_path (the reference's __main__.py:55-59)."""
    if isinstance(encoder_slot, Mapping):
        raise ValueError("command=tune expects a single encoder; for teacher-student runs "
                         "tune the student encoder alone (encoder=<student config>)")
    tune_cfg = dict(tune_cfg or {})
    results: Dict[str, Any] = {}
    with training_convolutions():
        if tune_cfg.get("scale_batch_size", True):
            results["batch_size"] = scale_batch_size(
                encoder_slot, _first_batch(data_module),
                init_size=int(tune_cfg.get("init_batch_size", 2)),
                max_trials=int(tune_cfg.get("max_trials", 8)))
        if tune_cfg.get("lr_find", True):
            results["lr"] = lr_find(encoder_slot, data_module,
                                    lr_min=float(tune_cfg.get("lr_min", 1e-8)),
                                    lr_max=float(tune_cfg.get("lr_max", 1.0)),
                                    num_steps=int(tune_cfg.get("num_lr_steps", 100)))["lr"]
    return results
