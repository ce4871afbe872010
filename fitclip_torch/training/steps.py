"""Train and eval steps (port of ``fitclip_tpu/training/steps.py``).

One function per task module of the reference:
- contrastive step  <- VideoTextLightningModule
- teacher-student   <- TeacherStudentLightningModule (the FitCLIP method)
- eval step         <- the validation paths (embeddings only)

A train step runs the forward, ``torch.autograd.grad`` over the trainable
parameters, and ``apply_updates_with_clamp`` (each phase a span of
``utils/profiling.py``), then, for an encoder with
batch-statistics BatchNorm (a CLIP ResNet, ``encode_video_train``), writes
the running statistics' EMA updates; it updates the state in place and
returns it with a metrics dict whose keys are the JAX steps'. Metric values
stay 0-dim tensors on the device: reading them waits for the step.

Under a process group each rank holds its block of the global batch. The
steps are written global-batch style, as the JAX package's: every embedding
computed from the batch is gathered from all ranks (``parallel/collectives.py:
gather_rows``, the teacher's without a graph), so each rank's loss is the JAX
step's loss over the global batch, and the gradients are averaged over ranks
in flat buckets before AdamW, whose global-norm clip then sees the global
gradient. Prompt ids are the same on every rank and are not gathered. DDP's
reducer would see nothing here (``torch.autograd.grad`` fills no ``.grad``),
so the all-reduce is explicit. A sharded state (``state.fsdp``) gathers its
parameters for the step and updates each rank's parts.

The contrastive step also runs on a tensor-parallel encoder
(``parallel/sharding_rules.py:shard_params`` on a (data, model) grid): the
ranks of a data row encode the same rows, so the embeddings are gathered and
the gradients averaged over the data group only, and the clip's norm sums a
TP-split leaf's squares over the model group (a replicated leaf's gradient is
the same on every rank of the row, and counts once).
"""

import contextlib
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from fitclip_torch.ops.losses import nce_loss, teacher_student_nce_loss
from fitclip_torch.parallel.collectives import average_gradients, gather_rows
from fitclip_torch.parallel.sharding_rules import split_global_norm, tensor_parallel_shardings
from fitclip_torch.parallel.tensor_parallel import grid_of
from fitclip_torch.training.state import AdamW, TrainState, apply_updates_with_clamp
from fitclip_torch.utils.profiling import span

Batch = Mapping[str, Any]


def _scores(video_emb: torch.Tensor, text_emb: torch.Tensor,
            logit_scale: torch.Tensor) -> torch.Tensor:
    """exp(logit_scale) * V T^T in fp32."""
    return torch.exp(logit_scale[0]) * (video_emb.float() @ text_emb.float().T)


def _update(state: TrainState, loss: torch.Tensor, optimizer: AdamW, grid=None,
            tp_split: Optional[Mapping[str, bool]] = None) -> TrainState:
    """One optimizer step on the trainable parameters. A parameter that takes
    no gradient (a BatchNorm's running statistics) gets a zero one, as JAX's
    gradient of a value used only under stop_gradient is. ``grid``: a
    tensor-parallel encoder's, and ``tp_split`` whether each state parameter
    is split over its model group (``_tp_split``)."""
    named = {n: p for n, p in state.named_parameters().items() if optimizer.trainable(n)}
    wanted = [n for n, p in named.items() if p.requires_grad]
    with span("backward"):
        found = dict(zip(wanted, torch.autograd.grad(loss, [named[n] for n in wanted],
                                                     allow_unused=True)))
    grads = {n: found[n] if found.get(n) is not None else torch.zeros_like(p)
             for n, p in named.items()}
    if state.fsdp is not None:
        with span("grad_average"):
            return state.fsdp.apply(state, grads, optimizer)
    names = list(grads)
    with span("grad_average"):
        averaged = dict(zip(names, average_gradients([grads[n] for n in names],
                                                     None if grid is None else grid.data_group)))
    norm_fn = None if grid is None else (lambda names, g32: split_global_norm(
        names, g32, lambda n: (False, tp_split.get(n, False)), grid))
    with span("optimizer"):
        return apply_updates_with_clamp(state, averaged, optimizer, norm_fn=norm_fn)


def _tp_split(encoder) -> Dict[str, bool]:
    """{state parameter name: split over the model group} of a tensor-parallel
    encoder's parameters; the rest of the state (``logit_scale``) replicates."""
    return {f"encoder.{n}": dim is not None for n, dim in
            tensor_parallel_shardings(dict(encoder.model.named_parameters())).items()}


def _parameters(state: TrainState):
    """A sharded state's parameters whole for the step; nothing otherwise."""
    return state.fsdp.gathered(state) if state.fsdp is not None else contextlib.nullcontext()


def _encode_video_train(encoder, video: torch.Tensor):
    """The train-form video encode: (embeddings, BatchNorm EMA updates) for an
    encoder with normalization state (a CLIP ResNet), else (embeddings, None)."""
    if hasattr(encoder, "encode_video_train"):
        return encoder.encode_video_train(video)
    return encoder.encode_video(video), None


def _apply_bn_updates(encoder, updates) -> None:
    """After the optimizer step: the running statistics take their EMA."""
    if updates is not None:
        encoder.apply_bn_updates(updates)


def make_contrastive_train_step(encoder, optimizer: AdamW):
    """(state, batch{video, text}) -> (state, metrics). ``encoder`` is the
    module that ``state.params["encoder"]`` holds; on a tensor-parallel
    encoder the batch is this data row's rows."""
    grid = grid_of(encoder)
    rows_group = None if grid is None else grid.data_group
    tp_split = None if grid is None else _tp_split(encoder)

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("train_step"), _parameters(state):
            with span("student_forward"):
                video_emb, bn_updates = _encode_video_train(encoder, batch["video"])
                text_emb = encoder.encode_text(batch["text"])
            with span("loss"):
                loss = nce_loss(_scores(gather_rows(video_emb, rows_group),
                                        gather_rows(text_emb, rows_group),
                                        state.params["logit_scale"]))
            state = _update(state, loss, optimizer, grid, tp_split)
            _apply_bn_updates(encoder, bn_updates)
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
    the fused layer kernels. A BatchNorm student normalizes with the combined
    batch's statistics and takes one EMA update a step."""
    unlabeled_loss_share = 1.0 - labeled_loss_share
    if grid_of(student) is not None:
        raise ValueError("tensor parallelism runs the contrastive step only; the "
                         "teacher-student step takes a replicated student")

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("train_step"), _parameters(state):
            return _step(state, batch)

    def _step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        logit_scale, ts_logit_scale = state.params["logit_scale"], state.params["ts_logit_scale"]
        labeled, unlabeled = batch["labeled"], batch["unlabeled"]
        prompted = student_prompt_ids is not None
        student_text = student_prompt_ids if prompted else unlabeled["text_student"]
        teacher_text = (teacher_prompt_ids if teacher_prompt_ids is not None
                        else unlabeled["text_teacher"])

        n_video, n_text = labeled["video_student"].shape[0], labeled["text_student"].shape[0]
        with span("student_forward"):
            all_video_emb, bn_updates = _encode_video_train(
                student, torch.cat([labeled["video_student"], unlabeled["video_student"]]))
            all_text_emb = student.encode_text(torch.cat([labeled["text_student"],
                                                          student_text]))
            video_emb, u_video = (gather_rows(all_video_emb[:n_video]),
                                  gather_rows(all_video_emb[n_video:]))
            text_emb, u_text = gather_rows(all_text_emb[:n_text]), all_text_emb[n_text:]
            if not prompted:
                u_text = gather_rows(u_text)

        with torch.no_grad(), span("teacher_forward"):
            t_video = gather_rows(teacher.encode_video(unlabeled["video_teacher"]))
            t_text = teacher.encode_text(teacher_text)
            if teacher_prompt_ids is None:
                t_text = gather_rows(t_text)
        with span("loss"):
            labeled_loss = nce_loss(_scores(video_emb, text_emb, logit_scale))
            student_scores = _scores(u_video, u_text, logit_scale)
            ts_scale = torch.exp(ts_logit_scale[0])
            teacher_scores = ts_scale * (t_video.float() @ t_text.float().T)
            unlabeled_loss = (teacher_student_nce_loss(student_scores, teacher_scores,
                                                       reduction="batchmean") * ts_scale ** 2)
            total = labeled_loss_share * labeled_loss + unlabeled_loss_share * unlabeled_loss

        state = _update(state, total, optimizer)
        _apply_bn_updates(student, bn_updates)
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
        with span("encode_video"):
            video = encoder.encode_video(batch["video"]).float()
        with span("encode_text"):
            return video, encoder.encode_text(batch["text"]).float()

    return step
