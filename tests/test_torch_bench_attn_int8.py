"""fitclip_torch/bench/attn_int8.py (S2) against scripts/bench_attn_int8.py.

Each mode's plain twin runs on the CPU and is held against the TPU script's
``make_variant(mode, block)`` (``_variant_kernel``) in Pallas interpret mode,
on a bf16 qkv of 2 frames x 17 tokens x 3 x 128 with 2 heads of the real
head_dim 64 (the script's module constants set on a copy of the module loaded
from its file). Bound: within two bf16 ulps (atol/rtol 1e-2) of the script's
bf16 output; the int8 arms' q, k and v operands are held bit for bit.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_torch.bench import attn_int8 as S2
from fitclip_torch.bench import kernels

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "bench_attn_int8.py"
FRAMES, SEQ, HEADS, HEAD_DIM = 2, 17, 2, 64
WIDTH = HEADS * HEAD_DIM


def _load_script():
    """The script as a module of its own, without writing bytecode into scripts/."""
    spec = importlib.util.spec_from_file_location("_bench_attn_int8_script", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    saved, sys.dont_write_bytecode = sys.dont_write_bytecode, True
    try:
        spec.loader.exec_module(module)
    finally:
        sys.dont_write_bytecode = saved
    module.HEADS, module.HEAD_DIM = HEADS, HEAD_DIM
    return module


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    qkv = (rng.normal(size=(FRAMES, SEQ, 3 * WIDTH)).astype(np.float32) * 0.7)
    qkv_t = torch.from_numpy(qkv).to(torch.bfloat16)
    return _load_script(), qkv_t, jnp.asarray(qkv_t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("mode,block", [(m, 1) for m in S2.MODES] + [("i8qkav", 2)])
def test_mode_plain_twin_matches_the_script(setup, mode, block):
    script, qkv, jqkv = setup
    ref = np.asarray(script.make_variant(mode, block)(jqkv), np.float32)
    out = S2.run_arm(qkv, mode, HEADS, block, plain=True)
    assert out.dtype == torch.bfloat16 and out.shape == (FRAMES, SEQ, WIDTH)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("block", [1, 2])
def test_int8_operands_match_the_script_bit_for_bit(setup, block):
    """q, k and v as the script quantizes them (``_variant_kernel:147-168``):
    one scale per block of frames over every head."""
    _, qkv, jqkv = setup
    q8, k8, v8, amax = kernels.s8_operands_plain(qkv, block)
    for p, ours in enumerate((q8, k8, v8)):
        for b0 in range(0, FRAMES, block):
            part = jqkv[b0:b0 + block, :, p * WIDTH:(p + 1) * WIDTH].astype(jnp.float32)
            peak = jnp.maximum(jnp.max(jnp.abs(part)), 1e-6)
            ref = jnp.clip(jnp.round(part * (127.0 / peak)), -127, 127).astype(jnp.int8)
            np.testing.assert_array_equal(ours[b0:b0 + block].numpy(), np.asarray(ref))
            assert float(amax[b0, p]) == float(peak)


def test_nopack_is_head_zero_on_every_head(setup):
    """bf16(1 + h * 1e-6) is 1: each head's slice is head 0's attention."""
    _, qkv, _ = setup
    out = S2.run_arm(qkv, "nopack", HEADS, plain=True)
    q, k, v = (qkv[..., p * WIDTH:p * WIDTH + HEAD_DIM] for p in range(3))
    head0 = S2.run_arm(torch.cat([q, k, v], dim=-1), "bf16", 1, plain=True)
    for h in range(HEADS):
        assert torch.equal(out[..., h * HEAD_DIM:(h + 1) * HEAD_DIM], head0)


def test_mode_wrappers_take_the_plain_versions_on_the_cpu(setup):
    _, qkv, _ = setup
    counts = [w.launches for w in kernels.WRAPPERS]
    for mode in S2.MODES:
        assert torch.equal(S2.run_arm(qkv, mode, HEADS), S2.run_arm(qkv, mode, HEADS, plain=True))
    assert counts == [w.launches for w in kernels.WRAPPERS]


def test_oracle_and_case_names():
    rng = np.random.default_rng(1)
    qkv = rng.normal(size=(1, 5, 3 * WIDTH)).astype(np.float32)
    out = S2.oracle(qkv, HEADS)
    plain = S2.run_arm(torch.from_numpy(qkv), "bf16", HEADS, plain=True).numpy()
    np.testing.assert_allclose(out, plain, atol=1e-5, rtol=1e-5)
    assert S2.min_row_cosine(out, out) == pytest.approx(1.0)
    assert [S2.mode_of(c) for c in S2.DEFAULT_CASES.split(",")] == ["bf16", "i8qk", "i8qkav"]
    with pytest.raises(ValueError, match="unknown case"):
        S2.mode_of("core_fp8")
