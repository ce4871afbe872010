"""The gradient of fitclip_torch's fused attention against the JAX package's.

``fused_attention_qkv`` is an ``autograd.Function`` (K3): on the CPU its
backward is ``attention_backward_plain``, held here against ``jax.vjp`` of
``fitclip_tpu.ops.attention.fused_attention_qkv``, whose backward runs the TPU
kernel ``_packed_bwd_kernel`` in Pallas interpret mode, at fp32 atol 1e-5 (the
bound of tests/test_fused_attention.py). The plain backward is also held
against torch autograd of the plain forward. The kernel itself is tested
against the plain backward on the card (test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.ops.attention import fused_attention_qkv as jax_fused_attention_qkv
from fitclip_torch.ops import attention as A


def _inputs(batch, seq, heads, head_dim, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(batch, seq, 3 * heads * head_dim)).astype(np.float32)
    grad = rng.normal(size=(batch, seq, heads * head_dim)).astype(np.float32)
    return qkv, grad


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads,head_dim", [(2, 64), (4, 8)])
def test_backward_matches_pallas_interpret_vjp(causal, heads, head_dim):
    qkv, grad = _inputs(2, 13, heads, head_dim, seed=1)
    scale = head_dim ** -0.5
    _, vjp = jax.vjp(lambda x: jax_fused_attention_qkv(x, heads, scale, causal, True),
                     jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(grad))
    x = torch.from_numpy(qkv).requires_grad_()
    A.fused_attention_qkv(x, heads, scale, causal).backward(torch.from_numpy(grad))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    plain = A.attention_backward_plain(torch.from_numpy(qkv), torch.from_numpy(grad), heads,
                                       scale, causal)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(causal):
    qkv, grad = _inputs(2, 11, 3, 16, seed=2)
    x = torch.from_numpy(qkv).double().requires_grad_()
    A.attention_core_plain(x, 3, 0.25, causal).backward(torch.from_numpy(grad).double())
    plain = A.attention_backward_plain(torch.from_numpy(qkv), torch.from_numpy(grad), 3, 0.25,
                                       causal)
    np.testing.assert_allclose(plain.numpy(), x.grad.numpy(), atol=1e-5, rtol=1e-5)


def test_bf16_backward_follows_the_kernels_casts():
    """In bf16 the plain backward rounds q_s, the weights fed to dV and dL as
    _packed_bwd_kernel does: it agrees with the interpreted kernel in bf16 to
    within a bf16 step of the output."""
    qkv, grad = _inputs(1, 9, 2, 64, seed=3)
    scale = 0.125
    _, vjp = jax.vjp(lambda x: jax_fused_attention_qkv(x, 2, scale, True, True),
                     jnp.asarray(qkv, jnp.bfloat16))
    (ref,) = vjp(jnp.asarray(grad, jnp.bfloat16))
    ref = np.asarray(ref.astype(jnp.float32))
    got = A.attention_backward_plain(torch.from_numpy(qkv).bfloat16(),
                                     torch.from_numpy(grad).bfloat16(), 2, scale, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=1e-2)


def test_function_saves_qkv_and_runs_the_backward_wrapper(monkeypatch):
    """The gradient goes through K3's backward (on the CPU its plain version),
    called once on the saved qkv."""
    calls = []
    original = A.fused_attention_qkv_backward

    def counting(qkv, grad_out, heads, scale, causal=False):
        calls.append((tuple(qkv.shape), heads, scale, causal))
        return original(qkv, grad_out, heads, scale, causal)

    monkeypatch.setattr(A, "fused_attention_qkv_backward", counting)
    qkv, grad = _inputs(2, 5, 2, 8, seed=4)
    x = torch.from_numpy(qkv).requires_grad_()
    out = A.fused_attention_qkv(x, 2, 0.3, True)
    assert type(out.grad_fn).__name__ == "FusedAttentionQKVBackward"
    out.backward(torch.from_numpy(grad))
    assert calls == [((2, 5, 48), 2, 0.3, True)]
