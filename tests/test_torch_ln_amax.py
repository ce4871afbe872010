"""The plain versions of the port's two row passes against the JAX package.

``csrc/ln_quant.cu`` (every LayerNorm the port launches) and the amax pass of
``csrc/bench_arms.cu`` are held on the card against their plain versions
(``tests/test_torch_kernels.py``, ``chip_smoke.py``). These tests hold those
plain versions, on the CPU, to what they replace:

- ``ops/block.py:ln_quant_plain`` and ``ln_cast_plain`` against
  ``fitclip_tpu/ops/block.py:_ln`` followed by ``_quant`` (K1) or nothing (K2);
- ``bench/kernels.py:ln_quant_variant_plain`` against S1's LN prologues,
  ``scripts/bench_block_layer.py:196-223`` (``lnvar``, ``lnfold``,
  ``noquant``), restated below in JAX line for line because they are closures
  inside the script's kernel;
- ``bench/kernels.py:attn_amax_plain`` against S2's per-block scale,
  ``jnp.maximum(jnp.max(jnp.abs(x32)), 1e-6)`` of
  ``scripts/bench_attn_int8.py:150,151,167``, taken over each block of frames.

Inputs are made with numpy from a seed, at the widths the port's callers use
(128 in the tests, 384 ViT-S/16, 512 text, 768 ViT-B, 1024 ViT-L/14), from bf16
and fp32 inputs. Tolerances: an int8 output may be one step off on at most
0.1% of the elements (the row sums run in another order); fp32 LayerNorm
outputs within atol/rtol 1e-5; the amax exactly, NaN included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.ops.block import _ln, _quant
from fitclip_torch.bench import kernels as P
from fitclip_torch.ops import block as K

WIDTHS = (128, 384, 512, 768, 1024)
ROWS = 37  # ragged: no multiple of a CTA's rows
INV = 127.0 / 4.0
INT8_MAX_FLIPPED = 1e-3
FLOAT_TOL = 1e-5


@pytest.fixture(scope="module")
def rows():
    """{(width, dtype): (x as torch, x as fp32 numpy, gamma, beta)}; bf16 inputs
    are rounded once in torch and reach JAX as the same fp32 values."""
    rng = np.random.default_rng(0)
    out = {}
    for width in WIDTHS:
        gamma = (1 + 0.1 * rng.normal(size=width)).astype(np.float32)
        beta = (0.1 * rng.normal(size=width)).astype(np.float32)
        x = (rng.normal(size=(ROWS, width)) * 3 + rng.normal(size=(ROWS, 1))).astype(np.float32)
        for dtype in (torch.bfloat16, torch.float32):
            xt = torch.from_numpy(x).to(dtype)
            out[width, dtype] = (xt, xt.float().numpy(), gamma, beta)
    return out


def _jax_ln(x32, gamma, beta, eps=1e-5):
    return _ln(jnp.asarray(x32), jnp.asarray(gamma)[None], jnp.asarray(beta)[None], eps)


def _assert_int8_close(out, ref):
    diff = np.abs(out.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert diff.max() <= 1, f"int8 output off by {diff.max()} steps"
    assert (diff != 0).mean() <= INT8_MAX_FLIPPED, f"{(diff != 0).mean():.2e} of outputs differ"


def _script_prologue(mode, x32, gamma, beta, inv):
    """S1's LN + quantize prologue of scripts/bench_block_layer.py:196-223 in
    the mode named by the script (s_ref[...][0] is gamma, b_ref[...][0] beta)."""
    x32 = jnp.asarray(x32)
    s, b = jnp.asarray(gamma), jnp.asarray(beta)
    if mode == "lnvar":
        mean = jnp.mean(x32, axis=-1, keepdims=True)
        msq = jnp.mean(x32 * x32, axis=-1, keepdims=True)
        normed = (x32 - mean) * jax.lax.rsqrt(msq - mean * mean + 1e-5)
        return _quant(normed * s + b, inv)
    if mode == "lnfold":
        mean = jnp.mean(x32, axis=-1, keepdims=True)
        centered = x32 - mean
        var = jnp.mean(centered * centered, axis=-1, keepdims=True)
        normed = centered * jax.lax.rsqrt(var + 1e-5)
        scaled = normed * (s * inv) + b * inv
        return jnp.clip(jnp.round(scaled), -127, 127).astype(jnp.int8)
    assert mode == "noquant"
    return _jax_ln(x32, gamma, beta).astype(jnp.int8)


S1_MODES = {"one": "lnvar", "fold": "lnfold", "cast": "noquant"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("width", WIDTHS)
def test_ln_quant_plain_matches_jax(rows, width, dtype):
    x, x32, gamma, beta = rows[width, dtype]
    out = K.ln_quant_plain(x, torch.from_numpy(gamma), torch.from_numpy(beta), INV)
    assert out.dtype == torch.int8 and out.shape == x.shape
    _assert_int8_close(out, _quant(_jax_ln(x32, gamma, beta), INV))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("width", WIDTHS)
def test_ln_cast_plain_matches_jax(rows, width, dtype):
    x, x32, gamma, beta = rows[width, dtype]
    ref = np.asarray(_jax_ln(x32, gamma, beta, 1e-6))
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    out = K.ln_cast_plain(x, g, b, torch.float32, 1e-6)
    np.testing.assert_allclose(out.numpy(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    # bf16, K2's compute dtype: the same values rounded once.
    cast = K.ln_cast_plain(x, g, b, torch.bfloat16, 1e-6)
    assert cast.dtype == torch.bfloat16 and torch.equal(cast, out.to(torch.bfloat16))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mode", sorted(S1_MODES))
def test_s1_ln_modes_match_the_script_prologues(rows, mode, width):
    for dtype in (torch.bfloat16, torch.float32):
        x, x32, gamma, beta = rows[width, dtype]
        out = P.ln_quant_variant_plain(x, torch.from_numpy(gamma), torch.from_numpy(beta), INV,
                                       K.LN_EPS, mode)
        assert out.dtype == torch.int8 and out.shape == x.shape
        _assert_int8_close(out, _script_prologue(S1_MODES[mode], x32, gamma, beta, INV))


def _edge_rows(width, dtype, rng):
    """2048 ordinary rows with four edge rows among them: a constant row (var
    = 0), a row on a common offset of 1e3, and two rows whose outputs fall on
    the .5 boundaries of the quantization (gamma 1, beta 0, and inv = sqrt(var
    + eps) of those rows: LN(x) * inv is k + 0.5 up to rounding). Returns x as
    torch, x as fp32 numpy and inv."""
    x = rng.normal(size=(2048, width)).astype(np.float32)
    half = np.arange(width // 2) % 20 + 0.5
    ties = np.concatenate([half, -half]).astype(np.float32)
    x[100] = 0.75
    x[700] = 1e3 + rng.normal(size=width)
    x[1200], x[1900] = rng.permutation(ties), rng.permutation(ties)
    xt = torch.from_numpy(x).to(dtype)
    inv = float(np.sqrt(np.mean(ties.astype(np.float64) ** 2) + 1e-5))
    return xt, xt.float().numpy(), inv


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("mode", ["two", "fold", "cast", "ln_cast"])
def test_two_pass_modes_on_edge_rows(mode, dtype):
    """The two-pass LayerNorms (K1's, S1's fold and cast, K2's) on the rows
    where they are easiest to get wrong. The constant row gives beta exactly
    (0 * rsqrt(eps)); the offset row the same as the row without its offset
    up to fp32's resolution at 1e3."""
    width = 768
    x, x32, inv = _edge_rows(width, dtype, np.random.default_rng(1))
    gamma, beta = np.ones(width, np.float32), np.zeros(width, np.float32)
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    if mode == "ln_cast":
        out = K.ln_cast_plain(x, g, b, torch.float32)
        ref = np.asarray(_jax_ln(x32, gamma, beta))
        assert not out[100].any() and not ref[100].any()
        # The offset row's centered values carry fp32's error at 1e3 (2^-14):
        # two sums in another order may differ there by that, times rsqrt(var).
        keep = np.ones(len(ref), bool)
        keep[700] = False
        np.testing.assert_allclose(out.numpy()[keep], ref[keep], atol=FLOAT_TOL, rtol=FLOAT_TOL)
        np.testing.assert_allclose(out.numpy()[700], ref[700], atol=2 ** -12, rtol=0)
        return
    if mode == "two":
        out = K.ln_quant_plain(x, g, b, inv)
        ref = _quant(_jax_ln(x32, gamma, beta), inv)
    else:
        out = P.ln_quant_variant_plain(x, g, b, inv, K.LN_EPS, mode)
        ref = _script_prologue(S1_MODES[mode], x32, gamma, beta, inv)
    assert not out[100].any()
    _assert_int8_close(out, ref)
    if mode != "cast":  # LN(x) * inv of the tie rows is x = k + 0.5: k or k + 1
        for row in (1200, 1900):
            assert (out[row].float() - torch.from_numpy(x32[row])).abs().max() <= 0.5 + 1e-3


def _script_block_max(qkv32, block):
    """S2's scales: per block of frames (the last one ragged), the script's
    jnp.maximum(jnp.max(jnp.abs(x32)), 1e-6) over each of q, k and v."""
    frames, _, triple = qkv32.shape
    width = triple // 3
    out = []
    for f0 in range(0, frames, block):
        part = jnp.asarray(qkv32[f0:f0 + block])
        out.append([jnp.maximum(jnp.max(jnp.abs(part[..., p * width:(p + 1) * width])), 1e-6)
                    for p in range(3)])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("block", [1, 2, 3])
def test_attn_amax_plain_matches_the_script(block, nan):
    """7 frames (no multiple of 2 or 3) of 17 x 3 x 128 bf16; a single large
    value at the last element, an all-zero part of one frame (that block's
    floor where the block is that frame alone), and with ``nan`` a NaN in
    frame 3's k, which its block's k scale must carry."""
    rng = np.random.default_rng(2)
    qkv = (0.7 * rng.normal(size=(7, 17, 3 * 128))).astype(np.float32)
    qkv[-1, -1, -1] = 40.0
    qkv[4, :, :128] = 0.0
    if nan:
        qkv[3, 5, 128 + 7] = np.nan
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    out = P.attn_amax_plain(x, block)
    ref = _script_block_max(x.float().numpy(), block)
    assert out.shape == ref.shape == (-(-7 // block), 3) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)  # NaN equal to NaN, the rest exact
    assert out[-1, 2] == 40.0
    assert bool(torch.isnan(out).any()) == nan
    if block == 1:
        assert float(out[4, 0]) == float(np.float32(1e-6))
