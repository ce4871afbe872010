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


@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("seq", [77, 197, 577])
def test_backward_body_choice(seq, head_dim):
    """bf16 takes the tensor-core body at every CLIP length; fp32 keeps its
    CUDA-core bodies, the global one where two transposed operands of one head
    overflow a block (L = 577 at head_dim 64). Each body answers its own shared
    memory, within a block's."""
    assert A.backward_body(torch.bfloat16, seq, head_dim) == "mma"
    mma = A.backward_smem_bytes(seq, head_dim, "mma")
    rows = -(-seq // 16) * 16
    assert mma == 2 * 2 * rows * head_dim + 4 * 4 * rows <= A.SMEM_LIMIT
    body = A.backward_body(torch.float32, seq, head_dim)
    assert body == ("f32_global" if (seq, head_dim) == (577, 64) else "f32")
    lp = seq | 1
    sizes = {name: A.backward_smem_bytes(seq, head_dim, name)
             for name in ("f32", "f32_global")}
    assert sizes["f32"] - sizes["f32_global"] == -(-4 * head_dim * lp // 16) * 16
    assert sizes[body] <= A.SMEM_LIMIT
    if body == "f32_global":
        assert sizes["f32"] > A.SMEM_LIMIT


def test_backward_body_refuses_what_no_body_takes():
    for head_dim in (16, 48, 128):
        with pytest.raises(ValueError, match="head_dim"):
            A.backward_body(torch.bfloat16, 197, head_dim)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        A.backward_body(torch.float16, 197, 64)
    with pytest.raises(ValueError, match="shared memory"):
        A.backward_body(torch.bfloat16, 1601, 64)  # q_s and statistics: 232,960 bytes
    with pytest.raises(ValueError, match="no backward body"):
        A.backward_smem_bytes(197, 64, "mma_sweep")


def _backward_taken_before(dtype, seq, head_dim):
    """Whether the CUDA-core kernels that took every shape before the tensor-core
    body took (dtype, L, head_dim): two transposed operands, or the first alone
    with the second read through L2, three statistics and two fp32 row buffers
    per warp, at a pitch odd in 4-byte words."""
    if dtype == torch.bfloat16:
        lp = seq + (seq & 1)
        lp, size = (lp if (lp // 2) % 2 else lp + 2), 2
    else:
        lp, size = seq | 1, 4
    align = lambda n: -(-n // 16) * 16  # noqa: E731
    return any(k * align(size * head_dim * lp) + 4 * 3 * lp + 4 * 2 * 8 * lp <= A.SMEM_LIMIT
               for k in (1, 2))


@pytest.mark.parametrize("head_dim", [32, 64])
def test_no_backward_shape_taken_before_is_refused(head_dim):
    """Over every length: a bf16 shape that the CUDA-core kernels took is taken
    on a tensor-core body (reading V and g through L2 past 848 keys at
    head_dim 64), and fp32 keeps its bodies and its limit."""
    for seq in range(1, 2049):
        for dtype in (torch.bfloat16, torch.float32):
            try:
                body = A.backward_body(dtype, seq, head_dim)
            except ValueError:
                body = None
            if dtype == torch.bfloat16:
                if _backward_taken_before(dtype, seq, head_dim):
                    assert body in ("mma", "mma_global"), (seq, head_dim)
                mma_fits = A.backward_smem_bytes(seq, head_dim, "mma") <= A.SMEM_LIMIT
                assert body != "mma_global" or not mma_fits
            else:
                assert (body is not None) == _backward_taken_before(dtype, seq, head_dim)
                f32_fits = A.backward_smem_bytes(seq, head_dim, "f32") <= A.SMEM_LIMIT
                assert body in (None, "f32" if f32_fits else "f32_global"), (seq, head_dim)


BLOCK, TILE = 64, 16  # attention_bwd_mma.cuh: rows or keys per block, per warp and query tile


def _two_kernel_model(qkv, grad, heads, scale, causal):
    """attention_bwd_mma.cuh's decomposition in float64, index for index: the
    rows kernel (blocks of 64 query rows, warps of 16; the keys a block loads and
    a warp uses under causal) writes dQ and each row's peak, denom and inner; the
    columns kernel (blocks of 64 keys, warps of 16) reads q_s and g of the rows
    r0 .. L - 1 padded with zero rows to a multiple of 16, walks query tiles of
    16 from the warp's own diagonal under causal, and writes dK and dV."""
    batch, seq, triple = qkv.shape
    width = triple // 3
    d = width // heads
    x = qkv.double().reshape(batch, seq, 3, heads, d).permute(2, 0, 3, 1, 4)  # (3, B, H, L, D)
    q_s, k, v = x[0] * scale, x[1], x[2]
    g = grad.double().reshape(batch, seq, heads, d).transpose(1, 2)
    dq, dk, dv = (torch.zeros_like(k) for _ in range(3))
    peak, denom, inner = (torch.zeros(batch, heads, seq, dtype=torch.float64) for _ in range(3))
    pad = lambda t, n: torch.cat([t, t.new_zeros(*t.shape[:2], n - t.shape[2], d)], 2)  # noqa
    for q0 in range(0, seq, BLOCK):
        keys = min(q0 + BLOCK, seq) if causal else seq
        filled = -(-keys // 16) * 16
        ks, vs = pad(k[:, :, :keys], filled), pad(v[:, :, :keys], filled)
        for i0 in range(q0, min(q0 + BLOCK, seq), TILE):
            rows = torch.arange(i0, i0 + TILE)
            used = min(i0 + TILE, keys) if causal else keys
            cols = torch.arange(used)
            seen = (cols[None] <= rows[:, None]) if causal else torch.ones(TILE, used, dtype=bool)
            qa, ga = pad(q_s[:, :, i0:i0 + TILE], TILE), pad(g[:, :, i0:i0 + TILE], TILE)
            s = torch.where(seen, qa @ ks[:, :, :used].transpose(-1, -2), -torch.inf)
            pk = s.amax(-1, keepdim=True)
            e = torch.exp(s - pk)
            dn = e.sum(-1, keepdim=True)
            w = e / dn
            dw = ga @ vs[:, :, :used].transpose(-1, -2)
            inn = (w * dw).sum(-1, keepdim=True)
            dl = torch.where(seen, w * (dw - inn), 0.0)
            steps = -(-used // 16) * 16  # the 16-key steps of dQ, pad keys zero-filled
            dl = torch.cat([dl, dl.new_zeros(*dl.shape[:3], steps - used)], -1)
            out = (dl @ ks[:, :, :steps]) * scale
            n = min(TILE, seq - i0)
            dq[:, :, i0:i0 + n] = out[:, :, :n]
            for stat, value in ((peak, pk), (denom, dn), (inner, inn)):
                stat[:, :, i0:i0 + n] = value[:, :, :n, 0]
    for k0 in range(0, seq, BLOCK):
        r0 = k0 if causal else 0
        filled = -(-(seq - r0) // 16) * 16
        qs, gs = pad(q_s[:, :, r0:], filled), pad(g[:, :, r0:], filled)
        stat = [torch.cat([t[:, :, r0:], t.new_full((batch, heads, filled - seq + r0), fill)], -1)
                for t, fill in ((peak, 0.0), (denom, 1.0), (inner, 0.0))]
        for s0 in range(k0, min(k0 + BLOCK, seq), TILE):
            key = torch.arange(s0, s0 + TILE)
            ka, va = pad(k[:, :, s0:s0 + TILE], TILE), pad(v[:, :, s0:s0 + TILE], TILE)
            acc_k, acc_v = torch.zeros_like(ka), torch.zeros_like(va)
            for l0 in range(s0 - r0 if causal else 0, filled, TILE):
                lq = torch.arange(l0, l0 + TILE)
                seen = (lq[None] < seq - r0) & (key[:, None] < seq)
                if causal:
                    seen &= r0 + lq[None] >= key[:, None]
                st = ka @ qs[:, :, l0:l0 + TILE].transpose(-1, -2)
                dwt = va @ gs[:, :, l0:l0 + TILE].transpose(-1, -2)
                pk, dn, inn = (t[:, :, None, l0:l0 + TILE] for t in stat)
                wt = torch.where(seen, torch.exp(st - pk) / dn, 0.0)
                dlt = torch.where(seen, wt * (dwt - inn), 0.0)
                acc_v += wt @ gs[:, :, l0:l0 + TILE]
                acc_k += dlt @ qs[:, :, l0:l0 + TILE]
            n = min(TILE, seq - s0)
            dk[:, :, s0:s0 + n], dv[:, :, s0:s0 + n] = acc_k[:, :, :n], acc_v[:, :, :n]
    merge = lambda t: t.transpose(1, 2).reshape(batch, seq, width)  # noqa: E731
    return torch.cat([merge(dq), merge(dk), merge(dv)], -1)


@pytest.fixture(scope="module")
def pallas_backward():
    """The JAX kernel's gradient (_packed_bwd_kernel in interpret mode) for each
    case of the decomposition test, computed once."""
    cases = {}
    for seq in (20, 33):
        for causal in (False, True):
            qkv, grad = _inputs(2, seq, 2, 32, seed=seq)
            _, vjp = jax.vjp(
                lambda x, c=causal: jax_fused_attention_qkv(x, 2, 32 ** -0.5, c, True),
                jnp.asarray(qkv))
            cases[seq, causal] = qkv, grad, np.asarray(vjp(jnp.asarray(grad))[0])
    return cases


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [20, 33])
def test_two_kernel_decomposition_matches_plain_and_pallas(pallas_backward, seq, causal):
    """The tiling and the causal skip that the CUDA kernels follow give the
    backward: in float64 the model agrees with attention_backward_plain and with
    the JAX kernel in interpret mode at fp32's atol 1e-5, at a length one tile
    past a 16 multiple and one that leaves a ragged last warp."""
    qkv, grad, ref = pallas_backward[seq, causal]
    model = _two_kernel_model(torch.from_numpy(qkv), torch.from_numpy(grad), 2, 32 ** -0.5,
                              causal)
    plain = A.attention_backward_plain(torch.from_numpy(qkv), torch.from_numpy(grad), 2,
                                       32 ** -0.5, causal)
    np.testing.assert_allclose(model.numpy(), plain.double().numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(model.numpy(), ref, atol=1e-5, rtol=1e-5)
