"""fitclip_torch's retrieval metrics and evaluator against the JAX package's,
on the same seeded embeddings and scores (ties included): ranks exactly, the
reductions at fp32 atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.evaluation.retrieval import RetrievalEvaluator as JaxEvaluator
from fitclip_tpu.ops import metrics as jax_metrics
from fitclip_torch.evaluation.retrieval import RetrievalEvaluator
from fitclip_torch.ops import metrics as M


def _tied_scores(seed, n=12):
    # Scores on a coarse grid, so many rows hold ties with their target.
    return np.round(np.random.default_rng(seed).normal(size=(n, n)), 0).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_ranks_and_reductions_match_jax(seed):
    scores = _tied_scores(seed)
    target = np.random.default_rng(seed + 10).permutation(scores.shape[0]).astype(np.int32)
    ref = np.asarray(jax_metrics.ranks_from_scores(jnp.asarray(scores), jnp.asarray(target)))
    ranks = M.ranks_from_scores(torch.from_numpy(scores), torch.from_numpy(target))
    np.testing.assert_array_equal(ranks.numpy(), ref)
    ref_ranks = jnp.asarray(ref)
    for k in (1, 5, 10):
        np.testing.assert_allclose(float(M.recall_at_k(ranks, k)),
                                   float(jax_metrics.recall_at_k(ref_ranks, k)), atol=1e-6)
    assert int(M.median_rank(ranks)) == int(jax_metrics.median_rank(ref_ranks))
    np.testing.assert_allclose(float(M.mean_rank(ranks)),
                               float(jax_metrics.mean_rank(ref_ranks)), atol=1e-6)


def test_retrieval_evaluator_matches_jax():
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(n, 8)).astype(np.float32),
                rng.normal(size=(n, 8)).astype(np.float32)) for n in (5, 4, 6)]
    port, ref = RetrievalEvaluator(include_mean_rank=True), JaxEvaluator(include_mean_rank=True)
    for video, text in batches:
        port.update(torch.from_numpy(video), torch.from_numpy(text))
        ref.update(jnp.asarray(video), jnp.asarray(text))
    got, want = port.compute(), ref.compute()
    assert set(got) == set(want) == {"r1", "r5", "r10", "mr", "mean_rank"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)
