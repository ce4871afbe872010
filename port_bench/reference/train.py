"""The FitCLIP teacher-student step in plain float32 PyTorch: the losses of
the paper's distillation (a symmetric InfoNCE on the labeled pairs, a
symmetric KL between the student's and the frozen teacher's score
distributions on the unlabeled pairs, scaled by the teacher-student scale
squared) and AdamW with decoupled weight decay, bias correction on the step
count and eps outside the square root, then the temperature clamp.

``encode_video`` and ``encode_text`` are a family's reference functions
(``reference/clip.py``); ``bits`` passes to them (the control).
"""

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

SCALES = ("logit_scale", "ts_logit_scale")


def nce(scores: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over a square score matrix, each direction a mean."""
    return (-torch.diagonal(F.log_softmax(scores, dim=-1)).mean()
            - torch.diagonal(F.log_softmax(scores.T, dim=-1)).mean())


def kl_batchmean(student: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """KL(softmax(teacher) || softmax(student)) summed over a row, the mean over rows."""
    t = F.softmax(teacher, dim=-1)
    return (t * (torch.log(t) - F.log_softmax(student, dim=-1))).sum() / student.shape[0]


def losses(student: Dict[str, torch.Tensor], teacher: Dict[str, torch.Tensor], batch: dict,
           cfg: dict, share: float, encode_video: Callable, encode_text: Callable,
           bits: Optional[dict] = None):
    """(total, labeled, unlabeled) of one step. The teacher's embeddings carry
    no graph; its scores do through the teacher-student scale, as the
    method's."""
    lab, unl = batch["labeled"], batch["unlabeled"]
    n_video, n_text = lab["video"].shape[0], lab["text"].shape[0]
    video = encode_video(student, torch.cat([lab["video"], unl["video"]]), cfg, bits)
    text = encode_text(student, torch.cat([lab["text"], unl["text"]]), cfg, bits)
    scale = torch.exp(student["logit_scale"][0])
    labeled = nce(scale * video[:n_video] @ text[:n_text].T)
    with torch.no_grad():
        t_video = encode_video(teacher, unl["video"], cfg, bits)
        t_text = encode_text(teacher, unl["text"], cfg, bits)
    ts_scale = torch.exp(student["ts_logit_scale"][0])
    t_scores = ts_scale * t_video @ t_text.T
    s_scores = scale * video[n_video:] @ text[n_text:].T
    unlabeled = (kl_batchmean(s_scores, t_scores) + kl_batchmean(s_scores.T, t_scores.T)) \
        * ts_scale ** 2
    return share * labeled + (1 - share) * unlabeled, labeled, unlabeled


class AdamW:
    """AdamW over a dict of float32 leaves, updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 betas, eps: float, max_logit_scale: float):
        self.lr, self.wd, (self.b1, self.b2), self.eps = lr, weight_decay, betas, eps
        self.max_logit_scale = max_logit_scale
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        bc1 = 1.0 - self.b1 ** (self.count + 1)
        bc2 = 1.0 - self.b2 ** (self.count + 1)
        for name, p in params.items():
            g = grads[name]
            self.mu[name] = self.b1 * self.mu[name] + (1 - self.b1) * g
            self.nu[name] = self.b2 * self.nu[name] + (1 - self.b2) * g * g
            adam = (self.mu[name] / bc1) / (torch.sqrt(self.nu[name] / bc2) + self.eps)
            p.sub_(self.lr * (adam + self.wd * p))
        for name in SCALES:
            params[name].clamp_(max=self.max_logit_scale)
        self.count += 1


def initial_scales(init_temperature: float, device) -> Dict[str, torch.Tensor]:
    return {name: torch.full((1,), -math.log(init_temperature), device=device)
            for name in SCALES}
