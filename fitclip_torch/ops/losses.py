"""Contrastive and distillation losses (port of ``fitclip_tpu/ops/losses.py``).

A symmetric InfoNCE over a square similarity matrix, a symmetric KL
teacher-student distillation loss with ``torch.nn.functional.kl_div``'s
conventions, and a sigmoid similarity loss (reference ``aligner/loss.py``).
"""

from typing import Literal

import torch
import torch.nn.functional as F

Reduction = Literal["none", "mean", "sum"]
KLReduction = Literal["none", "batchmean", "mean", "sum"]


def _reduce(loss: torch.Tensor, reduction: Reduction) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _rows_to_columns_nce(scores: torch.Tensor, reduction: Reduction) -> torch.Tensor:
    # -log p(column i | row i): the diagonal of the row-wise log-softmax.
    return _reduce(-torch.diagonal(F.log_softmax(scores, dim=-1)), reduction)


def nce_loss(scores: torch.Tensor, reduction: Reduction = "mean") -> torch.Tensor:
    """Symmetric InfoNCE on a square score matrix (video rows x text columns):
    rows_to_columns(scores) + rows_to_columns(scores.T), each reduced alone."""
    return _rows_to_columns_nce(scores, reduction) + _rows_to_columns_nce(scores.T, reduction)


def _kl_div(student_log_probs: torch.Tensor, teacher_probs: torch.Tensor,
            reduction: KLReduction) -> torch.Tensor:
    # KL(teacher || student) pointwise: t * (log t - s), and exactly 0 where t == 0.
    positive = teacher_probs > 0
    safe_log_t = torch.where(positive, torch.log(torch.where(positive, teacher_probs, 1.0)),
                             0.0)
    pointwise = torch.where(positive, teacher_probs * (safe_log_t - student_log_probs), 0.0)
    if reduction == "batchmean":
        return pointwise.sum() / pointwise.shape[0]
    if reduction == "mean":
        return pointwise.mean()
    if reduction == "sum":
        return pointwise.sum()
    return pointwise


def _rows_to_columns_ts_nce(scores, teacher_scores, reduction: KLReduction) -> torch.Tensor:
    return _kl_div(F.log_softmax(scores, dim=-1), F.softmax(teacher_scores, dim=-1), reduction)


def teacher_student_nce_loss(scores: torch.Tensor, teacher_scores: torch.Tensor,
                             reduction: KLReduction = "mean") -> torch.Tensor:
    """Symmetric KL distillation loss: the row-direction KL plus the
    column-direction KL, each on softmaxed scores. FitCLIP trains with
    reduction="batchmean"."""
    return (_rows_to_columns_ts_nce(scores, teacher_scores, reduction)
            + _rows_to_columns_ts_nce(scores.T, teacher_scores.T, reduction))


def similarity_loss(scores: torch.Tensor, reduction: Reduction = "mean") -> torch.Tensor:
    """-log(sigmoid(diag(scores)))."""
    return _reduce(-F.logsigmoid(torch.diagonal(scores)), reduction)
