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


# --- the fp32 kernel's decomposition (csrc/attention.cu: attention_f32_kernel) ---

TILE, WARPS = 64, 8  # attention_f32.cuh: keys per streamed tile, warps per block


def _round4(n):
    return -(-n // 4) * 4


def _rows(t, r0, n):
    """Rows r0 .. r0 + n - 1 of t (..., L, D), past the end zero-filled."""
    part = t[..., r0:r0 + n, :]
    return torch.cat([part, part.new_zeros(*part.shape[:-2], n - part.shape[-2], part.shape[-1])], -2)


def _f32_forward_model(qkv, heads, scale, causal, seq_valid, rows, out_mul=None, gkv=None):
    """attention_f32_kernel in float64, index for index: blocks of `rows`
    query rows (the tier), 64-key tiles up to the last key a block sees, each
    warp's QK^T of its 4 TM rows x 32 keys skipped past the keys its rows see,
    the exact softmax by rows (zeros from a row's last key to round4(keys)), and
    each warp's P.V over the columns its rows see. The row buffer starts as NaN,
    so a read of a cell the kernel never writes shows in the output. With gkv
    (B, 3W), fit_attention.cu's space_f32_kernel on the same body: the keys
    are [gkv's row | the L rows], L + 1 of them, key 0 in the first tile."""
    batch, seq, triple = qkv.shape
    d = triple // 3 // heads
    x = qkv.double().reshape(batch, seq, 3, heads, d).permute(2, 0, 3, 1, 4)  # (3, B, H, L, D)
    q, k, v = x[0] * scale, x[1], x[2]
    if gkv is not None:
        g = gkv.double().reshape(batch, 1, 3, heads, d).permute(2, 0, 3, 1, 4)
        k, v = torch.cat([g[1], k], -2), torch.cat([g[2], v], -2)
    kv = k.shape[-2]
    tm = rows // 16
    valid = kv if seq_valid is None else min(seq_valid, kv)
    out = torch.full((batch, heads, seq, d), float("nan"), dtype=torch.float64)
    for q0 in range(0, seq, rows):
        q1 = min(q0 + rows, seq)
        keys = min(q1 if causal else kv, valid)
        tiles, kcols = -(-keys // TILE), _round4(keys)
        qs = _rows(q, q0, rows)
        buf = torch.full((batch, heads, rows, _round4(kv) + 64), float("nan"), dtype=torch.float64)
        warps = []
        for warp in range(WARPS):
            r = (warp // 2) * 4 * tm
            wkeys = min(keys, q0 + r + 4 * tm) if causal else keys
            warps.append((warp % 2, torch.arange(r, r + 4 * tm), q0 + r < seq, wkeys))
        for t in range(tiles):
            j0 = TILE * t
            ks = _rows(k[..., :keys, :], j0, TILE)
            for wc, r_idx, live, wkeys in warps:
                if live and j0 + 32 * wc < wkeys:
                    cols = j0 + 32 * wc + torch.arange(32)
                    logits = qs[..., r_idx, :] @ ks[..., cols - j0, :].transpose(-1, -2)
                    keep = cols < kcols
                    buf[..., r_idx[:, None], cols[keep][None]] = logits[..., keep]
        for r in range(min(rows, seq - q0)):
            i = q0 + r
            nk = min(i + 1 if causal else kv, valid)
            logits = buf[..., r, :nk]
            exps = torch.exp(logits - logits.amax(-1, keepdim=True))
            denom = exps.sum(-1, keepdim=True)
            buf[..., r, :nk] = exps / denom if out_mul is None else exps * (out_mul / denom)
            buf[..., r, nk:kcols] = 0.0
        o = torch.zeros(batch, heads, rows, d, dtype=torch.float64)
        for t in range(tiles):
            j0 = TILE * t
            vs = _rows(v[..., :keys, :], j0, TILE)
            for wc, r_idx, live, wkeys in warps:
                n = min(TILE, _round4(wkeys) - j0)
                if live and n > 0:
                    cols = (d // 2) * wc + torch.arange(d // 2)
                    o[..., r_idx[:, None], cols[None]] += (buf[..., r_idx, j0:j0 + n]
                                                          @ vs[..., :n, cols])
        out[..., q0:q1, :] = o[..., :q1 - q0, :]
    return out.transpose(1, 2).reshape(batch, seq, triple // 3)


@pytest.fixture(scope="module")
def pallas_forward():
    """_packed_kernel in interpret mode for each case of the model tests, once."""
    cases = {}
    for seq in (20, 70):
        for causal in (False, True):
            qkv = _qkv(2, seq, 2, 32, seed=seq)
            ref = jax_fused_attention_qkv(jnp.asarray(qkv), 2, 32 ** -0.5, causal, True)
            cases[seq, causal] = qkv, np.asarray(ref)
    return cases


@pytest.mark.parametrize("rows", [64, 32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [20, 70])
def test_f32_forward_decomposition_matches_plain_and_pallas(pallas_forward, seq, causal, rows):
    """The fp32 kernel's tiling, at both tiers' rows a block, gives the qkv
    mode: in float64 the model agrees with attention_core_plain and with the
    JAX kernel in interpret mode at fp32's atol 1e-5, at a length inside one
    key tile and one that leaves a ragged second tile (and, at 32 rows, a
    ragged third row block)."""
    qkv, ref = pallas_forward[seq, causal]
    model = _f32_forward_model(torch.from_numpy(qkv), 2, 32 ** -0.5, causal, None, rows)
    plain = A.attention_core_plain(torch.from_numpy(qkv), 2, 32 ** -0.5, causal)
    np.testing.assert_allclose(model.numpy(), plain.double().numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(model.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows", [64, 32])
@pytest.mark.parametrize("causal,seq_valid", [(False, 50), (True, None), (True, 40)])
def test_f32_forward_decomposition_int8_and_block_modes(rows, causal, seq_valid):
    """The int8 mode's core (exps * (out_mul / denom)) and the block mode's
    (exps * (1 / denom)) on the same tiling, with seq_valid masking keys,
    against attention_core_plain (at fp32's atol over the output / out_mul,
    whose weights sum to 1) and the int8 layer's _attention_core."""
    heads, head_dim, seq = 2, 64, 70
    qkv = _qkv(2, seq, heads, head_dim, seed=5, std=1.5)
    scale = head_dim ** -0.5
    for out_mul in (127.0 / 2.5, 1.0):
        model = _f32_forward_model(torch.from_numpy(qkv), heads, scale, causal, seq_valid, rows,
                                   out_mul)
        plain = A.attention_core_plain(torch.from_numpy(qkv), heads, scale, causal, out_mul,
                                       seq_valid, torch.float32)
        np.testing.assert_allclose(model.numpy() / out_mul, plain.double().numpy() / out_mul,
                                   atol=1e-5, rtol=1e-5)
    ref = np.asarray(_attention_core(jnp.asarray(qkv), heads, scale, causal, jnp.float32,
                                     out_mul=jnp.float32(127.0 / 2.5), seq_valid=seq_valid))
    model = _f32_forward_model(torch.from_numpy(qkv), heads, scale, causal, seq_valid, rows,
                               127.0 / 2.5)
    np.testing.assert_allclose(model.numpy(), ref, atol=1e-4, rtol=1e-5)
