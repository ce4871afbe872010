"""fitclip_torch/ops/losses.py against fitclip_tpu/ops/losses.py: values and
gradients of the three losses on the same seeded scores, at fp32 atol/rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.ops import losses as jax_losses
from fitclip_torch.ops import losses as L


def _scores(seed, n=6, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(n, n)) * scale).astype(np.float32)


def _check(jax_fn, torch_fn, *inputs):
    """Value and gradient with respect to the first input."""
    ref, ref_grad = jax.value_and_grad(jax_fn)(*map(jnp.asarray, inputs))
    tensors = [torch.from_numpy(x) for x in inputs]
    tensors[0].requires_grad_()
    got = torch_fn(*tensors)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tensors[0].grad.numpy(), np.asarray(ref_grad), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_nce_loss_matches_jax(reduction):
    _check(lambda s: jax_losses.nce_loss(s, reduction),
           lambda s: L.nce_loss(s, reduction), _scores(1))


@pytest.mark.parametrize("reduction", ["batchmean", "mean", "sum"])
def test_teacher_student_loss_matches_jax(reduction):
    teacher = _scores(3)
    teacher[0, :] = [60.0, -60.0, -60.0, -60.0, -60.0, -60.0]  # softmax underflows to t == 0
    _check(lambda s, t: jax_losses.teacher_student_nce_loss(s, t, reduction),
           lambda s, t: L.teacher_student_nce_loss(s, t, reduction), _scores(2), teacher)


def test_kl_zero_teacher_probability_contributes_zero():
    student = torch.log_softmax(torch.tensor([[1.0, 2.0, 3.0]]), dim=-1)
    teacher = torch.tensor([[0.0, 0.5, 0.5]])
    pointwise = L._kl_div(student, teacher, "none")
    assert pointwise[0, 0] == 0
    np.testing.assert_allclose(
        pointwise.numpy(),
        np.asarray(jax_losses._kl_div(jnp.asarray(student.numpy()), jnp.asarray(teacher.numpy()),
                                      "none")), atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_similarity_loss_matches_jax(reduction):
    _check(lambda s: jax_losses.similarity_loss(s, reduction),
           lambda s: L.similarity_loss(s, reduction), _scores(4))


def test_unreduced_losses_keep_their_shape():
    scores = torch.from_numpy(_scores(5))
    assert L.nce_loss(scores, "none").shape == (6,)
    assert L.teacher_student_nce_loss(scores, scores, "none").shape == (6, 6)
