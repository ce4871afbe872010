"""Text->video retrieval evaluation (port of
``fitclip_tpu/evaluation/retrieval.py``): accumulate embeddings over batches,
then rank the full ``texts @ videos^T`` matrix in fp32 with target arange(N) and
report R@1/5/10 and the median rank (optionally the mean rank)."""

import dataclasses
from typing import Dict, List

import torch

from fitclip_torch.ops.metrics import mean_rank, median_rank, ranks_from_scores, recall_at_k


def retrieval_metrics(ranks: torch.Tensor, include_mean_rank: bool = False) -> Dict[str, float]:
    metrics = {"r1": float(recall_at_k(ranks, 1)), "r5": float(recall_at_k(ranks, 5)),
               "r10": float(recall_at_k(ranks, 10)), "mr": float(median_rank(ranks))}
    if include_mean_rank:
        metrics["mean_rank"] = float(mean_rank(ranks))
    return metrics


@dataclasses.dataclass
class RetrievalEvaluator:
    """Embeddings are kept as fp32 on the host (N x 512 is small)."""
    include_mean_rank: bool = False

    def __post_init__(self):
        self._videos: List[torch.Tensor] = []
        self._texts: List[torch.Tensor] = []

    def update(self, video_emb: torch.Tensor, text_emb: torch.Tensor) -> None:
        self._videos.append(video_emb.detach().float().cpu())
        self._texts.append(text_emb.detach().float().cpu())

    def compute(self) -> Dict[str, float]:
        videos, texts = torch.cat(self._videos), torch.cat(self._texts)
        scores = texts @ videos.T
        ranks = ranks_from_scores(scores, torch.arange(scores.shape[0]))
        return retrieval_metrics(ranks, self.include_mean_rank)
