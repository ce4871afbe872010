"""Train and eval steps (port of ``fitclip_tpu/training/steps.py``).

One function per task module of the reference:
- contrastive step  <- VideoTextLightningModule
- teacher-student   <- TeacherStudentLightningModule (the FitCLIP method)
- eval step         <- the validation paths (embeddings only)

A train step runs the forward, ``torch.autograd.grad`` over the trainable
parameters, and ``apply_updates_with_clamp``; it updates the state in place and
returns it with a metrics dict whose keys are the JAX steps'. Metric values
stay 0-dim tensors on the device: reading them waits for the step.
"""

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from fitclip_torch.ops.losses import nce_loss, teacher_student_nce_loss
from fitclip_torch.training.state import AdamW, TrainState, apply_updates_with_clamp

Batch = Mapping[str, Any]


def _scores(video_emb: torch.Tensor, text_emb: torch.Tensor,
            logit_scale: torch.Tensor) -> torch.Tensor:
    """exp(logit_scale) * V T^T in fp32."""
    return torch.exp(logit_scale[0]) * (video_emb.float() @ text_emb.float().T)


def _update(state: TrainState, loss: torch.Tensor, optimizer: AdamW) -> TrainState:
    named = {n: p for n, p in state.named_parameters().items() if optimizer.trainable(n)}
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {n: g if g is not None else torch.zeros_like(p)
             for (n, p), g in zip(named.items(), grads)}
    return apply_updates_with_clamp(state, grads, optimizer)


def make_contrastive_train_step(encoder, optimizer: AdamW):
    """(state, batch{video, text}) -> (state, metrics). ``encoder`` is the
    module that ``state.params["encoder"]`` holds."""

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        video_emb = encoder.encode_video(batch["video"])
        text_emb = encoder.encode_text(batch["text"])
        loss = nce_loss(_scores(video_emb, text_emb, state.params["logit_scale"]))
        state = _update(state, loss, optimizer)
        with torch.no_grad():
            metrics = {"loss/train": loss.detach(),
                       "temperature": 1.0 / torch.exp(state.params["logit_scale"][0])}
        return state, metrics

    return step


def make_teacher_student_train_step(student, teacher, optimizer: AdamW,
                                    labeled_loss_share: float = 0.5,
                                    student_prompt_ids: Optional[torch.Tensor] = None,
                                    teacher_prompt_ids: Optional[torch.Tensor] = None):
    """The FitCLIP distillation step. Batch: {"labeled": sub, "unlabeled": sub},
    each sub-batch with video_student/text_student/video_teacher/text_teacher.
    Prompt ids, if given, replace the unlabeled text of both towers. The student
    runs once over the concatenated labeled and unlabeled batch; the teacher is
    frozen and runs under ``torch.no_grad()``, so it may be an int8 encoder on
    the fused layer kernels."""
    unlabeled_loss_share = 1.0 - labeled_loss_share

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        logit_scale, ts_logit_scale = state.params["logit_scale"], state.params["ts_logit_scale"]
        labeled, unlabeled = batch["labeled"], batch["unlabeled"]
        student_text = (student_prompt_ids if student_prompt_ids is not None
                        else unlabeled["text_student"])
        teacher_text = (teacher_prompt_ids if teacher_prompt_ids is not None
                        else unlabeled["text_teacher"])

        n_video, n_text = labeled["video_student"].shape[0], labeled["text_student"].shape[0]
        all_video_emb = student.encode_video(
            torch.cat([labeled["video_student"], unlabeled["video_student"]]))
        all_text_emb = student.encode_text(torch.cat([labeled["text_student"], student_text]))
        video_emb, u_video = all_video_emb[:n_video], all_video_emb[n_video:]
        text_emb, u_text = all_text_emb[:n_text], all_text_emb[n_text:]
        labeled_loss = nce_loss(_scores(video_emb, text_emb, logit_scale))

        with torch.no_grad():
            t_video = teacher.encode_video(unlabeled["video_teacher"])
            t_text = teacher.encode_text(teacher_text)
        student_scores = _scores(u_video, u_text, logit_scale)
        ts_scale = torch.exp(ts_logit_scale[0])
        teacher_scores = ts_scale * (t_video.float() @ t_text.float().T)
        unlabeled_loss = (teacher_student_nce_loss(student_scores, teacher_scores,
                                                   reduction="batchmean") * ts_scale ** 2)
        total = labeled_loss_share * labeled_loss + unlabeled_loss_share * unlabeled_loss

        state = _update(state, total, optimizer)
        with torch.no_grad():
            metrics = {"loss/train_labeled": labeled_loss.detach(),
                       "loss/train_unlabeled": unlabeled_loss.detach(),
                       "loss/train": total.detach(),
                       "temperature/labeled": 1.0 / torch.exp(logit_scale[0]),
                       "temperature/unlabeled": 1.0 / torch.exp(ts_logit_scale[0])}
        return state, metrics

    return step


def make_eval_step(encoder):
    """batch{video, text} -> (video_emb, text_emb) in fp32, without a graph."""

    @torch.no_grad()
    def step(batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        return (encoder.encode_video(batch["video"]).float(),
                encoder.encode_text(batch["text"]).float())

    return step
