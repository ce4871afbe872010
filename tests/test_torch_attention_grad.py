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
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


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
    """bf16 takes the tensor-core body at every CLIP length; fp32 takes the
    register-tiled kernels with 32 query rows a block in the rows kernel at
    every CLIP length (16 past 680 keys at head_dim 64, 776 at 32). Each body
    answers its own shared memory, within a block's: the larger of the rows
    kernel's (q_s and g tiles, two 64-key tiles, two row buffers of R x pitch)
    and the columns kernel's, which does not grow with L."""
    assert A.backward_body(torch.bfloat16, seq, head_dim) == "mma"
    mma = A.backward_smem_bytes(seq, head_dim, "mma")
    rows = -(-seq // 16) * 16
    assert mma == 2 * 2 * rows * head_dim + 4 * 4 * rows <= A.SMEM_LIMIT
    body = A.backward_body(torch.float32, seq, head_dim)
    assert body == "f32_32"
    pitch = ((-(-seq // 4) * 4 + 23) & ~31) + 8
    columns = A.backward_smem_bytes(1, head_dim, "f32_16")
    for name in ("f32_32", "f32_16"):
        r = int(name[4:])
        assert A.backward_smem_bytes(seq, head_dim, name) == max(
            4 * (2 * r * (head_dim + 4) + 2 * 64 * (head_dim + 4) + 2 * r * pitch), columns)
    assert A.backward_smem_bytes(seq, head_dim, body) <= A.SMEM_LIMIT


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
    head_dim 64), and an fp32 one on a register-tiled tier, the first that
    fits (32, then 16 query rows a block)."""
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
                if _backward_taken_before(dtype, seq, head_dim):
                    assert body is not None, (seq, head_dim)
                fits = [name for name in ("f32_32", "f32_16")
                        if A.backward_smem_bytes(seq, head_dim, name) <= A.SMEM_LIMIT]
                assert body == (fits[0] if fits else None), (seq, head_dim)


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
    for seq in (20, 33, 70):
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


F32_TILE, F32_WARPS = 64, 8  # attention_f32.cuh: rows or keys per streamed tile, warps per block


def _round4(n):
    return -(-n // 4) * 4


def _rows(t, r0, n):
    """Rows r0 .. r0 + n - 1 of t (..., L, D), past the end zero-filled."""
    part = t[..., r0:r0 + n, :]
    return torch.cat([part, part.new_zeros(*part.shape[:-2], n - part.shape[-2], part.shape[-1])], -2)


def _f32_backward_model(qkv, grad, heads, scale, causal, rows):
    """attention_bwd.cu's fp32 kernels in float64, index for index. The rows
    kernel (blocks of `rows` query rows, the tier; 64-key tiles of K, V, then
    K again up to the last key the block sees; each warp's 4 TM rows x 32 keys
    skipped past the keys its rows see) writes dQ and each row's peak, denom
    and inner; the columns kernel (blocks of 64 keys; 64-row tiles of q_s, g
    and the statistics from the block's diagonal under causal; each warp's 16
    keys x 32 rows skipped where every pair is masked or past the end) stages
    W32 and dL and sums dK, dV from each warp's first unmasked row. Every
    buffer starts as NaN, so a read of a cell the kernels never write shows."""
    batch, seq, triple = qkv.shape
    width = triple // 3
    d = width // heads
    tm = rows // 16
    nan = float("nan")
    x = qkv.double().reshape(batch, seq, 3, heads, d).permute(2, 0, 3, 1, 4)  # (3, B, H, L, D)
    q_s, k, v = x[0] * scale, x[1], x[2]
    g = grad.double().reshape(batch, seq, heads, d).transpose(1, 2)
    dq, dk, dv = (torch.full_like(k, nan) for _ in range(3))
    stats = torch.full((3, batch, heads, seq), nan, dtype=torch.float64)
    for q0 in range(0, seq, rows):
        q1 = min(q0 + rows, seq)
        keys = q1 if causal else seq
        tiles, kcols = -(-keys // F32_TILE), _round4(keys)
        qs, gs = _rows(q_s, q0, rows), _rows(g, q0, rows)
        e, w = (torch.full((batch, heads, rows, _round4(seq) + 64), nan, dtype=torch.float64)
                for _ in range(2))
        warps = []
        for warp in range(F32_WARPS):
            r = (warp // 2) * 4 * tm
            wkeys = min(keys, q0 + r + 4 * tm) if causal else keys
            warps.append((warp % 2, torch.arange(r, r + 4 * tm), q0 + r < seq, wkeys))
        for buf, a, b in ((e, qs, k), (w, gs, v)):
            for t in range(tiles):
                j0 = F32_TILE * t
                tile = _rows(b[..., :keys, :], j0, F32_TILE)
                for wc, r_idx, live, wkeys in warps:
                    if live and j0 + 32 * wc < wkeys:
                        cols = j0 + 32 * wc + torch.arange(32)
                        out = a[..., r_idx, :] @ tile[..., cols - j0, :].transpose(-1, -2)
                        keep = cols < kcols
                        buf[..., r_idx[:, None], cols[keep][None]] = out[..., keep]
            for r in range(min(rows, seq - q0)):
                i = q0 + r
                nk = i + 1 if causal else seq
                if buf is e:
                    peak = e[..., r, :nk].amax(-1)
                    e[..., r, :nk] = torch.exp(e[..., r, :nk] - peak[..., None])
                    stats[0, ..., i], stats[1, ..., i] = peak, e[..., r, :nk].sum(-1)
                else:
                    e[..., r, :nk] = e[..., r, :nk] / stats[1, ..., i, None]
                    inner = (e[..., r, :nk] * w[..., r, :nk]).sum(-1)
                    w[..., r, :nk] = e[..., r, :nk] * (w[..., r, :nk] - inner[..., None])
                    w[..., r, nk:kcols] = 0.0
                    stats[2, ..., i] = inner
        acc = torch.zeros(batch, heads, rows, d, dtype=torch.float64)
        for t in range(tiles):
            j0 = F32_TILE * t
            tile = _rows(k[..., :keys, :], j0, F32_TILE)
            for wc, r_idx, live, wkeys in warps:
                n = min(F32_TILE, _round4(wkeys) - j0)
                if live and n > 0:
                    cols = (d // 2) * wc + torch.arange(d // 2)
                    acc[..., r_idx[:, None], cols[None]] += w[..., r_idx, j0:j0 + n] @ tile[..., :n, cols]
        dq[..., q0:q1, :] = acc[..., :q1 - q0, :] * scale
    for k0 in range(0, seq, F32_TILE):
        r0 = k0 if causal else 0
        ks, vs = _rows(k, k0, F32_TILE), _rows(v, k0, F32_TILE)
        acc_k, acc_v = (torch.zeros(batch, heads, F32_TILE, d, dtype=torch.float64) for _ in range(2))
        for l0 in range(r0, seq, F32_TILE):
            n_rows = min(F32_TILE, seq - l0)
            qt, gt = _rows(q_s, l0, F32_TILE), _rows(g, l0, F32_TILE)
            pk, dn, inn = (torch.cat([s[..., l0:l0 + n_rows], s.new_zeros(batch, heads, F32_TILE - n_rows)],
                                     -1) for s in stats)
            wt, et = (torch.full((batch, heads, F32_TILE, F32_TILE + 8), nan, dtype=torch.float64)
                      for _ in range(2))
            warps = []
            for warp in range(F32_WARPS):
                wr, wc = warp // 2, warp % 2
                wkey = k0 + 16 * wr
                lstart = max(0, wkey - l0) if causal else 0
                warps.append((wc, torch.arange(16 * wr, 16 * wr + 16), wkey < seq, lstart))
            for wc, key_idx, live, lstart in warps:
                if live and 32 * wc < n_rows and 32 * wc + 32 > lstart:
                    cols = 32 * wc + torch.arange(32)
                    s_t = ks[..., key_idx, :] @ qt[..., cols, :].transpose(-1, -2)
                    dw_t = vs[..., key_idx, :] @ gt[..., cols, :].transpose(-1, -2)
                    seen = (l0 + cols[None] < seq) & (~torch.tensor(causal) | (
                        l0 + cols[None] >= k0 + key_idx[:, None]))
                    wv = torch.where(seen, torch.exp(s_t - pk[..., None, cols]) / dn[..., None, cols],
                                     0.0)
                    dl = torch.where(seen, wv * (dw_t - inn[..., None, cols]), 0.0)
                    wt[..., key_idx[:, None], cols[None]] = wv
                    et[..., key_idx[:, None], cols[None]] = dl
            lend = _round4(n_rows)
            for wc, key_idx, live, lstart in warps:
                if live and lstart < lend:
                    cols = (d // 2) * wc + torch.arange(d // 2)
                    acc_v[..., key_idx[:, None], cols[None]] += (wt[..., key_idx, lstart:lend]
                                                                @ gt[..., lstart:lend, cols])
                    acc_k[..., key_idx[:, None], cols[None]] += (et[..., key_idx, lstart:lend]
                                                                @ qt[..., lstart:lend, cols])
        n = min(F32_TILE, seq - k0)
        dk[..., k0:k0 + n, :], dv[..., k0:k0 + n, :] = acc_k[..., :n, :], acc_v[..., :n, :]
    merge = lambda t: t.transpose(1, 2).reshape(batch, seq, width)  # noqa: E731
    return torch.cat([merge(dq), merge(dk), merge(dv)], -1)


@pytest.mark.parametrize("rows", [32, 16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [20, 33, 70])
def test_f32_backward_decomposition_matches_plain_and_pallas(pallas_backward, seq, causal, rows):
    """The fp32 kernels' tiling, at each tier's rows a block, gives the
    backward: in float64 the model agrees with attention_backward_plain and
    with the JAX kernel in interpret mode at fp32's atol 1e-5, at lengths
    inside one key tile (ragged row blocks) and one that leaves a ragged second
    key and row tile."""
    qkv, grad, ref = pallas_backward[seq, causal]
    model = _f32_backward_model(torch.from_numpy(qkv), torch.from_numpy(grad), 2, 32 ** -0.5,
                                causal, rows)
    plain = A.attention_backward_plain(torch.from_numpy(qkv), torch.from_numpy(grad), 2,
                                       32 ** -0.5, causal)
    np.testing.assert_allclose(model.numpy(), plain.double().numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(model.numpy(), ref, atol=1e-5, rtol=1e-5)
