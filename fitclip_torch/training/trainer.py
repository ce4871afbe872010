"""The outer training loop: epochs, periodic validation, callbacks (port of
``fitclip_tpu/training/trainer.py``).

- periodic validation at ``val_check_interval`` (a fraction of an epoch, e.g.
  0.02 in teacher_student_trainer.yaml);
- checkpoints: best-by-monitor, every-N-epochs, wall-clock interval, and
  ``last`` at the end;
- early stopping on a monitored metric;
- metric logging every ``log_every_n_steps``;
- a resumed state fast-forwards its loader to the step it was saved at.

The step runs eagerly on the device; this loop is plain Python on the host.
"""

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np

from fitclip_torch.training.checkpointing import save_checkpoint, save_trainer_state
from fitclip_torch.training.state import TrainState
from fitclip_torch.utils.logging import MetricsLogger


@dataclasses.dataclass
class EarlyStoppingConfig:
    monitor: str = "loss/val"
    mode: str = "min"
    patience: int = 3
    min_delta: float = 0.0


@dataclasses.dataclass
class CheckpointConfig:
    dirpath: str = "checkpoints"
    monitor: Optional[str] = "loss/val"
    mode: str = "min"
    every_n_epochs: Optional[int] = 5
    train_time_interval_seconds: Optional[float] = 3600.0


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: int = 1
    val_check_interval: float = 1.0
    log_every_n_steps: int = 10
    early_stopping: Optional[EarlyStoppingConfig] = None
    checkpoint: Optional[CheckpointConfig] = None
    max_steps: Optional[int] = None


class _EarlyStopping:
    def __init__(self, config: EarlyStoppingConfig):
        self.config = config
        self.best = np.inf if config.mode == "min" else -np.inf
        self.bad_checks = 0

    def update(self, metrics: Mapping[str, float]) -> bool:
        """Returns True if training should stop."""
        value = metrics.get(self.config.monitor)
        if value is None:
            return False
        improved = (value < self.best - self.config.min_delta if self.config.mode == "min"
                    else value > self.best + self.config.min_delta)
        if improved:
            self.best = value
            self.bad_checks = 0
        else:
            self.bad_checks += 1
        return self.bad_checks > self.config.patience


class Trainer:
    def __init__(self, config: TrainerConfig, logger: Optional[MetricsLogger] = None,
                 prepare_batch: Optional[Callable[[Any], Any]] = None) -> None:
        self.config = config
        self.logger = logger or MetricsLogger()
        self.prepare_batch = prepare_batch or (lambda batch: batch)
        self._best_monitor: Optional[float] = None
        self._early_stopping: Optional[_EarlyStopping] = None
        self.last_val_metrics: Dict[str, float] = {}

    def fit(self, state: TrainState, train_step: Callable, train_loader,
            validate: Optional[Callable[[TrainState], Dict[str, float]]] = None,
            resume_trainer_state: Optional[Mapping[str, Any]] = None) -> TrainState:
        """``train_step(state, batch) -> (state, metrics)``."""
        config = self.config
        early_stopping = _EarlyStopping(config.early_stopping) if config.early_stopping else None
        ckpt = config.checkpoint
        last_time_ckpt = time.time()
        global_step = int(state.step)
        stop = False

        # Callback state saved beside a full-TrainState checkpoint.
        if resume_trainer_state:
            if resume_trainer_state.get("best_monitor") is not None:
                self._best_monitor = resume_trainer_state["best_monitor"]
            if early_stopping and "early_stopping_best" in resume_trainer_state:
                early_stopping.best = resume_trainer_state["early_stopping_best"]
                early_stopping.bad_checks = resume_trainer_state.get(
                    "early_stopping_bad_checks", 0)
        self._early_stopping = early_stopping

        for epoch in range(config.max_epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            steps_per_epoch = len(train_loader) if hasattr(train_loader, "__len__") else None
            val_every = (max(1, int(steps_per_epoch * config.val_check_interval))
                         if steps_per_epoch and config.val_check_interval < 1 else None)

            # Resume fast-forward: epochs the restored step covers are skipped; a
            # partly covered epoch re-iterates its loader (same epoch seed, same
            # order) and drops the batches already trained on, so 3 steps +
            # resume + 5 steps consume the sample stream of 8 straight steps.
            skip_batches = 0
            if steps_per_epoch and global_step > epoch * steps_per_epoch:
                if global_step >= (epoch + 1) * steps_per_epoch:
                    continue
                skip_batches = global_step - epoch * steps_per_epoch

            for batch in train_loader:
                if skip_batches:
                    skip_batches -= 1
                    continue
                state, metrics = train_step(state, self.prepare_batch(batch))
                global_step += 1

                if global_step % config.log_every_n_steps == 0:
                    self.logger.log({k: float(v) for k, v in metrics.items()}, step=global_step)

                if val_every and global_step % val_every == 0 and validate:
                    stop = self._validate_and_callbacks(state, validate, early_stopping, ckpt,
                                                        global_step)
                    if stop:
                        break

                if (ckpt and ckpt.train_time_interval_seconds
                        and time.time() - last_time_ckpt > ckpt.train_time_interval_seconds):
                    self._save(state, os.path.join(ckpt.dirpath, "time_interval"))
                    last_time_ckpt = time.time()

                if config.max_steps and global_step >= config.max_steps:
                    stop = True
                    break
            if stop:
                break

            # Epoch-end validation (when not validating within the epoch).
            if validate and not val_every:
                stop = self._validate_and_callbacks(state, validate, early_stopping, ckpt,
                                                    global_step)
            if ckpt and ckpt.every_n_epochs and (epoch + 1) % ckpt.every_n_epochs == 0:
                self._save(state, os.path.join(ckpt.dirpath, f"epoch_{epoch + 1}"))
            if stop:
                break

        if ckpt:
            self._save(state, os.path.join(ckpt.dirpath, "last"))
        return state

    def _validate_and_callbacks(self, state, validate, early_stopping, ckpt,
                                global_step) -> bool:
        metrics = validate(state)
        self.logger.log(metrics, step=global_step)
        if ckpt and ckpt.monitor and ckpt.monitor in metrics:
            value = metrics[ckpt.monitor]
            best = self._best_monitor
            if best is None or (value < best if ckpt.mode == "min" else value > best):
                self._best_monitor = value
                self._save(state, os.path.join(ckpt.dirpath, "best"))
        self.last_val_metrics = metrics
        return early_stopping.update(metrics) if early_stopping else False

    def _save(self, state: TrainState, path: str) -> None:
        save_checkpoint(path, state)
        trainer_state: Dict[str, Any] = {}
        if self._best_monitor is not None:
            trainer_state["best_monitor"] = float(self._best_monitor)
        if self._early_stopping is not None:
            trainer_state["early_stopping_best"] = float(self._early_stopping.best)
            trainer_state["early_stopping_bad_checks"] = int(self._early_stopping.bad_checks)
        if trainer_state:
            save_trainer_state(path, trainer_state)
