"""Retrieval metrics (port of ``fitclip_tpu/ops/metrics.py``): pure reductions
over a rank vector."""

import torch


def ranks_from_scores(scores: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0-based rank of each row's target column when the row is sorted
    descending, as torch.argsort(descending=True) orders it: the count of
    greater scores plus the count of equal scores at an earlier column."""
    target = target.long()
    target_scores = torch.gather(scores, 1, target[:, None])
    greater = (scores > target_scores).sum(dim=1)
    col = torch.arange(scores.shape[1], device=scores.device)[None, :]
    ties_before = ((scores == target_scores) & (col < target[:, None])).sum(dim=1)
    return (greater + ties_before).to(torch.int32)


def recall_at_k(ranks: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of queries whose 0-based rank is < k (R@K)."""
    return (ranks < k).float().mean()


def median_rank(ranks: torch.Tensor) -> torch.Tensor:
    """Median of ranks, 1-based; the lower middle element for an even count,
    as torch.median gives it."""
    return torch.sort(ranks).values[(ranks.shape[0] - 1) // 2] + 1


def mean_rank(ranks: torch.Tensor) -> torch.Tensor:
    """Mean of ranks, 1-based."""
    return ranks.float().mean() + 1
