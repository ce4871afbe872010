"""Zero-shot video classification (port of
``fitclip_tpu/evaluation/classification.py``): every label is formatted into
every template and tokenized once; the bank is encoded in batches of 32,
reshaped to (labels, templates, D) and averaged over the templates; videos are
scored against it, and top-1/top-5 accuracy and the median rank are reported
(optionally top-1 per class)."""

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fitclip_torch.ops.metrics import median_rank, ranks_from_scores, recall_at_k


def tokenize_label_bank(encoder, labels: Sequence[str],
                        templates: Optional[Sequence[str]] = None) -> np.ndarray:
    """(labels * templates, L) token ids, labels-major (label i holds rows
    [i * T, (i + 1) * T))."""
    templates = list(templates) if templates else ["{}"]
    texts = [template.format(label) for label in labels for template in templates]
    return encoder.get_tokenizer()(texts)


@torch.no_grad()
def encode_label_bank(encoder, tokenized: np.ndarray, num_labels: int, device,
                      encode_batch_size: int = 32) -> torch.Tensor:
    """Encode the bank in batches of ``encode_batch_size`` rows, the last one
    zero-padded to full size, and mean-pool per label -> (labels, D) fp32."""
    total = tokenized.shape[0]
    padded_total = -(-total // encode_batch_size) * encode_batch_size
    padded = np.zeros((padded_total, tokenized.shape[1]), tokenized.dtype)
    padded[:total] = tokenized
    ids = torch.from_numpy(padded).long().to(device)
    embeddings = torch.cat([encoder.encode_text(ids[i: i + encode_batch_size]).float()
                            for i in range(0, padded_total, encode_batch_size)])[:total]
    return embeddings.reshape(num_labels, total // num_labels, -1).mean(dim=1)


@dataclasses.dataclass
class ClassificationEvaluator:
    """Accumulates (video embedding, label) batches and computes accuracy
    against a fixed label bank."""
    label_bank: torch.Tensor  # (labels, D)
    per_class: bool = False

    def __post_init__(self):
        self._scores: List[torch.Tensor] = []
        self._labels: List[torch.Tensor] = []

    def update(self, video_emb: torch.Tensor, labels, valid: Optional[int] = None) -> None:
        scores = video_emb.detach().float() @ self.label_bank.float().T
        labels = torch.as_tensor(np.asarray(labels))
        if valid is not None:
            scores, labels = scores[:valid], labels[:valid]
        self._scores.append(scores.cpu())
        self._labels.append(labels)

    def compute(self) -> Dict[str, float]:
        scores, labels = torch.cat(self._scores), torch.cat(self._labels).long()
        ranks = ranks_from_scores(scores, labels)
        metrics = {"a1": float(recall_at_k(ranks, 1)), "a5": float(recall_at_k(ranks, 5)),
                   "mr": float(median_rank(ranks))}
        if self.per_class:
            for label in torch.unique(labels).tolist():
                mask = labels == label
                metrics[f"a1_class_{int(label)}"] = float((ranks[mask] < 1).float().mean())
        return metrics
