"""command=train on one device: contrastive fine-tuning or teacher-student
distillation (port of ``fitclip_tpu/cli/train_runner.py``).

Wires config -> optimizer, state, step, trainer. The encoder slot decides the
mode: one ``LoadedEncoder`` trains contrastively; a {"student", "teacher"} map
runs the FitCLIP distillation over mixed batches. Batches are numpy trees from
the data module's loaders, moved to the student's device (pinned, without
blocking). Validation is the runners' retrieval eval (``cli/runners.py:run_eval``)
of the student over each val loader, a group's metrics suffixed with each
member's name. The callbacks' ``param_freeze_patterns`` freeze parameters by
their JAX paths (``trainer.callbacks=clip_freeze_text``: ``^encoder/text/``).
Distribution (DDP, FSDP, several hosts) is not ported yet: ``trainer.fsdp``
only logs a warning, as the JAX package does on one device.
"""

import logging
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from fitclip_torch.cli.runners import run_eval
from fitclip_torch.config_engine import instantiate
from fitclip_torch.data.data_module_group import DataModuleStructuredGroup
from fitclip_torch.models.frozen_in_time.encoder import FrozenInTimeVideoTextEncoder
from fitclip_torch.training.checkpointing import load_trainer_state, restore_checkpoint
from fitclip_torch.training.state import init_train_state, make_optimizer
from fitclip_torch.training.steps import (make_contrastive_train_step,
                                          make_teacher_student_train_step)
from fitclip_torch.training.trainer import (CheckpointConfig, EarlyStoppingConfig, Trainer,
                                            TrainerConfig)
from fitclip_torch.utils.logging import MetricsLogger
from fitclip_torch.utils.precision import training_convolutions

LOGGER = logging.getLogger(__name__)


def _trainer_config(trainer_cfg: Mapping[str, Any],
                    callbacks_cfg: Optional[Mapping[str, Any]]) -> TrainerConfig:
    callbacks_cfg = callbacks_cfg or {}
    early = (EarlyStoppingConfig(**callbacks_cfg["early_stopping"])
             if "early_stopping" in callbacks_cfg else None)
    ckpt = (CheckpointConfig(**callbacks_cfg["checkpoint"])
            if "checkpoint" in callbacks_cfg else None)
    return TrainerConfig(max_epochs=int(trainer_cfg.get("max_epochs", 1)),
                         val_check_interval=float(trainer_cfg.get("val_check_interval", 1.0)),
                         log_every_n_steps=int(trainer_cfg.get("log_every_n_steps", 10)),
                         max_steps=trainer_cfg.get("max_steps"),
                         early_stopping=early, checkpoint=ckpt)


def make_batch_preparer(device: torch.device):
    """numpy tree -> the same tree of tensors on ``device``; keys that are
    neither a mapping nor an array (host metadata) are dropped."""
    device = torch.device(device)

    def put(array: np.ndarray) -> torch.Tensor:
        tensor = torch.from_numpy(np.ascontiguousarray(array))
        if device.type == "cuda":
            return tensor.pin_memory().to(device, non_blocking=True)
        return tensor.to(device)

    def prepare(node):
        if isinstance(node, Mapping):
            return {k: prepare(v) for k, v in node.items()
                    if isinstance(v, (Mapping, np.ndarray))}
        return put(node)

    return prepare


def _has_val(data_module) -> bool:
    # Only "no val split defined" disables validation; a val loader that
    # crashes propagates.
    try:
        data_module.val_dataloader()
        return True
    except NotImplementedError:
        return False


def _refuse_untrainable(slot_name: str, enc) -> None:
    if enc.quantized:
        raise ValueError(
            f"the {slot_name} slot holds {type(enc).__name__} with int8 weights, which is "
            "evaluation-only; fine-tune a float ViT CLIP encoder instead "
            "(load_clip_encoder(dtype='float32' or 'bfloat16'))")
    if enc.fused_block:
        raise ValueError(
            f"the {slot_name} slot holds {type(enc).__name__} built with fused_block (the "
            "inference layer kernels, which have no gradient path); rebuild it with "
            "fused_block=False to train")
    # Off the CPU the attention wrappers launch their kernels (a CPU tensor
    # alone takes the plain, differentiable version).
    off_cpu = any(p.device.type != "cpu" for p in enc.parameters())
    if isinstance(enc, FrozenInTimeVideoTextEncoder) and enc.fused_attention and off_cpu:
        raise ValueError(
            f"the {slot_name} slot holds {type(enc).__name__} with fused_attention on CUDA: "
            "its divided attention runs K5 and K6, which are forward only (no gradient "
            "reaches the attention's parameters); rebuild it with fused_attention=False "
            "to train")


def load_prompts(prompts_path: str, student, teacher, device) -> Tuple[torch.Tensor, ...]:
    """The prompt file's non-empty lines, tokenized by the student's and the
    teacher's tokenizers, as int64 ids on the device (they replace the
    unlabeled text of the teacher-student step)."""
    with open(prompts_path) as file:
        prompts = [line.strip() for line in file if line.strip()]
    return tuple(torch.from_numpy(np.asarray(enc.get_tokenizer()(prompts))).long().to(device)
                 for enc in (student, teacher))


def run_train(encoder_slot, data_module, model_cfg: Mapping[str, Any],
              trainer_cfg: Mapping[str, Any], optimizer_cfg: Mapping[str, Any],
              callbacks_cfg: Optional[Mapping[str, Any]] = None,
              prompts_path: Optional[str] = None, log_dir: Optional[str] = None,
              checkpoint_path: Optional[str] = None) -> Dict[str, Any]:
    """Train on the student's device. Returns {"state", "metrics"} (the last
    validation metrics)."""
    is_teacher_student = isinstance(encoder_slot, Mapping)
    student = encoder_slot["student"] if is_teacher_student else encoder_slot
    teacher = encoder_slot["teacher"] if is_teacher_student else None
    # The frozen teacher never receives gradients, so an inference-form teacher
    # (int8, fused layer kernels) is valid; a gradient-carrying slot is not.
    _refuse_untrainable("student" if is_teacher_student else "encoder", student.encoder)
    encoder = student.encoder
    device = next(encoder.parameters()).device
    params_template = {"encoder": encoder, "logit_scale": torch.zeros(1)}
    if is_teacher_student:
        params_template["ts_logit_scale"] = torch.zeros(1)
    optimizer = make_optimizer(
        learning_rate=float(optimizer_cfg.get("lr", 3e-6)),
        weight_decay=float(optimizer_cfg.get("weight_decay", 0.01)),
        eps=float(optimizer_cfg.get("eps", 1e-8)),
        betas=tuple(optimizer_cfg.get("betas", (0.9, 0.999))),
        freeze_patterns=list((callbacks_cfg or {}).get("param_freeze_patterns") or []) or None,
        fit_temperature=bool(model_cfg.get("fit_temperature", True)),
        gradient_clip_val=trainer_cfg.get("gradient_clip_val"),
        params_example=params_template,
        # The opt_state layout is the same either way; a checkpoint resumes under
        # the same moment dtype only.
        fused=bool(optimizer_cfg.get("fused", True)),
        moment_dtype=optimizer_cfg.get("moment_dtype"))
    state = init_train_state(encoder, optimizer,
                             init_temperature=float(model_cfg.get("init_temperature", 0.05)),
                             min_temperature=float(model_cfg.get("min_temperature", 0.001)),
                             with_teacher_student_scale=is_teacher_student)

    # Full resume: the whole TrainState (params, moments, step, temperatures)
    # and the callback state from the sidecar. The teacher always comes from
    # the encoder config.
    resume_trainer_state = None
    if checkpoint_path:
        state = restore_checkpoint(checkpoint_path, state)
        resume_trainer_state = load_trainer_state(checkpoint_path)
        LOGGER.info("Resumed full TrainState at step %d from %s", state.step, checkpoint_path)

    if is_teacher_student:
        student_prompts, teacher_prompts = (load_prompts(prompts_path, student, teacher, device)
                                            if prompts_path else (None, None))
        step = make_teacher_student_train_step(
            encoder, teacher.encoder, optimizer,
            labeled_loss_share=float(model_cfg.get("labeled_dataset_loss_share", 0.5)),
            student_prompt_ids=student_prompts, teacher_prompt_ids=teacher_prompts)
    else:
        step = make_contrastive_train_step(encoder, optimizer)

    if bool(trainer_cfg.get("fsdp", False)):
        LOGGER.warning("++trainer.fsdp=true has no effect on one device; the TrainState "
                       "is not sharded.")
    train_loader = _train_loader(data_module)
    # An experiment-tracker sink (trainer.logger={_target_: ...}) receives every
    # logged dict beside the JSONL stream.
    sinks = [instantiate(trainer_cfg["logger"])] if trainer_cfg.get("logger") else []
    trainer = Trainer(_trainer_config(trainer_cfg, callbacks_cfg),
                      logger=MetricsLogger(log_dir=log_dir, sinks=sinks),
                      prepare_batch=make_batch_preparer(device))
    try:
        with training_convolutions():
            final_state = trainer.fit(state, step, train_loader,
                                      validate=((lambda _: run_eval(student, data_module))
                                                if _has_val(data_module) else None),
                                      resume_trainer_state=resume_trainer_state)
    finally:
        trainer.logger.close()
    return {"state": final_state, "metrics": trainer.last_val_metrics}


def _train_loader(data_module):
    """The data module's train loader. A structured group, whose train loader
    is a mapping of each member's, is refused before any loader is built: the
    train loop takes one loader of batches."""
    source = getattr(data_module, "train_data_module", data_module)
    if isinstance(source, DataModuleStructuredGroup):
        raise ValueError(
            f"command=train over {type(source).__name__}: its train_dataloader() is a "
            f"mapping of loaders, one per member ({', '.join(source.names)}), which the train "
            "loop cannot iterate; train over a MixedBatchDataModule (data=mixed_batch_*) or "
            "one data module instead")
    return data_module.train_dataloader()
