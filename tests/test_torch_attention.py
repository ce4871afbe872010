"""fitclip_torch/ops/attention.py against the JAX package's attention.

On the CPU the port's wrappers take their plain versions; they are held
against the TPU kernel `_packed_kernel` in Pallas interpret mode (qkv mode)
and against `ops/block._attention_core`, the per-head core of the int8 layer
kernel (int8 mode). The kernel-vs-plain tests are in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.ops.attention import fused_attention_qkv as jax_fused_attention_qkv
from fitclip_tpu.ops.block import _attention_core
from fitclip_torch.ops import attention as A


def _qkv(batch, seq, heads, head_dim, seed, std=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, seq, 3 * heads * head_dim)) * std).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads,head_dim", [(2, 64), (4, 8)])
def test_fused_attention_qkv_matches_pallas_interpret(causal, heads, head_dim):
    qkv = _qkv(2, 13, heads, head_dim, seed=1)
    scale = head_dim ** -0.5
    ref = jax_fused_attention_qkv(jnp.asarray(qkv), heads, scale, causal, True)
    out = A.fused_attention_qkv(torch.from_numpy(qkv), heads, scale, causal)
    assert out.dtype == torch.float32 and out.shape == (2, 13, heads * head_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal,seq_valid", [(False, None), (True, None), (False, 9)])
def test_attention_int8_matches_layer_attention_core(causal, seq_valid):
    heads, head_dim = 2, 64
    qkv = _qkv(2, 13, heads, head_dim, seed=2, std=1.5)
    scale, out_mul = head_dim ** -0.5, 127.0 / 2.5
    ref = np.asarray(_attention_core(jnp.asarray(qkv), heads, scale, causal, jnp.float32,
                                     out_mul=jnp.float32(out_mul), seq_valid=seq_valid))
    core = A.attention_core_plain(torch.from_numpy(qkv), heads, scale, causal, out_mul,
                                  seq_valid, torch.float32)
    np.testing.assert_allclose(core.numpy(), ref, atol=1e-4, rtol=1e-5)
    # The int8 wrapper rounds that core half to even and clips it, as
    # _layer_kernel does; a value on a rounding boundary may land one step off.
    q = A.attention_int8(torch.from_numpy(qkv), heads, scale, causal, out_mul, seq_valid)
    expected = np.clip(np.round(ref), -127, 127).astype(np.int8)
    assert q.dtype == torch.int8
    assert np.abs(q.numpy().astype(np.int32) - expected).max() <= 1


def test_seq_valid_masks_dead_keys():
    """Keys at and past seq_valid do not reach the live rows' output."""
    heads, head_dim = 2, 8
    qkv = _qkv(1, 10, heads, head_dim, seed=3)
    padded = A.attention_core_plain(torch.from_numpy(qkv), heads, 0.3, False, 20.0, 7,
                                    torch.float32)
    live = A.attention_core_plain(torch.from_numpy(qkv[:, :7]), heads, 0.3, False, 20.0,
                                  None, torch.float32)
    np.testing.assert_allclose(padded[:, :7].numpy(), live.numpy(), atol=1e-5, rtol=1e-5)
