"""Frozen-in-Time's divided attention in the port (ops/attention.py: K5, K6 and
K4's three int8-mode cores) against the JAX package, on the CPU, where the
wrappers take their plain versions.

- K5/K6 against the Pallas kernels in interpret mode: atol = rtol = 2e-5 in
  fp32 (tests/test_frozen_in_time.py's fused-vs-einsum bound), 2e-2 in bf16.
- K4's cores (before the int8 rounding) against the JAX kernel's own helpers
  of the shipped arm (_time_attention_mxu, _space_attention_packed with the
  concat CLS join, _cls_global_row_packed), which are plain jnp functions:
  atol = rtol = 1e-4 in fp32 on values pre-scaled by out_mul ~ 30.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.ops import fit_block as jax_fit_block
from fitclip_tpu.ops.attention import fused_attention_qkv_gkv as jax_gkv
from fitclip_tpu.ops.attention import fused_time_attention as jax_time
from fitclip_torch.ops import attention as A

TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


def _inputs(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 1.5


def _pair(array, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        t = torch.from_numpy(array).to(torch.bfloat16)
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t
    return jnp.asarray(array), torch.from_numpy(array)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("groups,seq,heads,head_dim", [(6, 9, 4, 16), (4, 196, 2, 64)])
def test_gkv_attention_matches_pallas_interpret(dtype, groups, seq, heads, head_dim):
    width = heads * head_dim
    qkv_j, qkv_t = _pair(_inputs(0, groups, seq, 3 * width), dtype)
    gkv_j, gkv_t = _pair(_inputs(1, groups, 3 * width), dtype)
    scale = head_dim ** -0.5
    ref = np.asarray(jax_gkv(qkv_j, gkv_j, heads, scale, interpret=True), np.float32)
    before = A.fused_attention_qkv_gkv.launches
    out = A.fused_attention_qkv_gkv(qkv_t, gkv_t, heads, scale)
    assert A.fused_attention_qkv_gkv.launches == before  # CPU: the plain version
    assert out.dtype == qkv_t.dtype and out.shape == (groups, seq, width)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("batch,frames,patches,heads,head_dim",
                         [(2, 3, 5, 4, 16), (2, 4, 196, 2, 64), (3, 1, 4, 2, 8)])
def test_time_attention_matches_pallas_interpret(dtype, batch, frames, patches, heads,
                                                 head_dim):
    width = heads * head_dim
    qkv_j, qkv_t = _pair(_inputs(2, batch, frames * patches, 3 * width), dtype)
    gkv_j, gkv_t = _pair(_inputs(3, batch, 3 * width), dtype)
    scale = head_dim ** -0.5
    ref = np.asarray(jax_time(qkv_j, gkv_j, heads, frames, scale, interpret=True), np.float32)
    before = A.fused_time_attention.launches
    out = A.fused_time_attention(qkv_t, gkv_t, heads, frames, scale)
    assert A.fused_time_attention.launches == before
    assert out.dtype == qkv_t.dtype and out.shape == (batch, frames * patches, width)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("frames,patches", [(2, 4), (4, 9), (1, 6)])
def test_int8_mode_cores_match_the_shipped_jax_arm(frames, patches):
    heads, head_dim, batch = 2, 16, 2
    width = heads * head_dim
    n = 1 + frames * patches
    qkv = _inputs(4, batch, n, 3 * width)
    qkv_j, qkv_t = jnp.asarray(qkv), torch.from_numpy(qkv)
    scale, out_mul = head_dim ** -0.5, 127.0 / 4.0
    time_ref = jax_fit_block._time_attention_mxu(qkv_j, heads, frames, patches, scale, out_mul)
    space_ref = jax_fit_block._space_attention_packed(qkv_j, heads, frames, patches, scale,
                                                      out_mul, cls_concat=True)
    cls_ref = jax_fit_block._cls_global_row_packed(qkv_j, heads, scale, out_mul)
    for mode, ref in (("time", time_ref), ("space", space_ref)):
        got = A.fit_rows_attention_int8_plain(qkv_t, heads, frames, mode, out_mul)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    got = A.cls_attention_plain(qkv_t, heads, scale, out_mul)
    np.testing.assert_allclose(got.numpy(), np.asarray(cls_ref), atol=1e-4, rtol=1e-4)


def test_int8_wrappers_fill_the_joint_rows_on_the_cpu():
    heads, frames, patches = 2, 2, 4
    qkv = torch.from_numpy(_inputs(5, 2, 1 + frames * patches, 3 * heads * 64))
    counts = [f.launches for f in (A.fit_cls_attention_int8, A.fit_time_attention_int8,
                                   A.fit_space_attention_int8)]
    out = A.fit_cls_attention_int8(qkv, heads, 20.0)
    out = A.fit_time_attention_int8(qkv, heads, frames, 20.0, out)
    scale = 64 ** -0.5
    want_cls = torch.round(A.cls_attention_plain(qkv, heads, scale, 20.0)).clamp(-127, 127)
    want_rows = torch.round(A.fit_rows_attention_int8_plain(qkv, heads, frames, "time", 20.0))
    assert torch.equal(out[:, :1].float(), want_cls)
    assert torch.equal(out[:, 1:].float(), want_rows.clamp(-127, 127))
    assert counts == [f.launches for f in (A.fit_cls_attention_int8, A.fit_time_attention_int8,
                                           A.fit_space_attention_int8)]
    with pytest.raises(ValueError, match="int8"):
        A.fit_space_attention_int8(qkv, heads, frames, 20.0, torch.zeros(2, 9, 128))
