"""fitclip_torch/bench/block_layer.py (S1, S1s) against scripts/bench_block_layer.py.

Each arm's plain twin runs on the CPU and is held against the TPU script's
``make_run(mode, block)`` in Pallas interpret mode, and the two-stream `skew`
against ``make_skew_run()``, at 2 frames x 17 tokens x width 64 with 2 heads
(the script's module constants set on a copy of the module loaded from its
file). The weights are the script's own ``make_layer_params``, carried across
as numpy through ``convert/from_jax.py``; x is fp32, so the arms' bf16 casts
of the TPU kernel become fp32 on both sides. Bound: K1's int8 tolerance
(atol/rtol 2e-3, tests/test_torch_block.py); for the arms with an approximate
reciprocal, which interpret mode rounds through bf16
(fitclip_tpu/ops/block.py:177-179) while the plain twin divides exactly, a
min-row cosine of 0.999.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_torch.bench import block_layer as S1

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "bench_block_layer.py"
FRAMES, SEQ, WIDTH, HEADS = 2, 17, 64, 2
# The arms whose TPU body multiplies by pl.reciprocal(approx=True) somewhere,
# avfold's MLP epilogue (scripts/bench_block_layer.py:294) included.
APPROX_RECIPROCAL = ("lnvar", "avfold", "avfold2", "sm2", "smf", "sm2mlp16", "mlpfold",
                     "mlpfold16")
CASES = sorted(S1.ARMS) + sorted(S1.RENAMES) + ["b2"]


def _load_script():
    """The script as a module of its own, without writing bytecode into scripts/."""
    spec = importlib.util.spec_from_file_location("_bench_block_layer_script", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    saved, sys.dont_write_bytecode = sys.dont_write_bytecode, True
    try:
        spec.loader.exec_module(module)
    finally:
        sys.dont_write_bytecode = saved
    module.SEQ, module.WIDTH, module.HEADS = SEQ, WIDTH, HEADS
    return module


@pytest.fixture(scope="module")
def setup():
    script = _load_script()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(FRAMES, SEQ, WIDTH)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, script.make_layer_params(rng))
    return script, x, params, S1.layer_block(params, HEADS, device="cpu")


def _script_case(case):
    """The script's main: ``b{n}`` is `full` at block rows n, `b2split` block 2."""
    if case.startswith("b") and case[1:].isdigit():
        return "full", int(case[1:])
    return case, 2 if case == "b2split" else 1


def _min_row_cosine(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def _check(out, ref, approx):
    if approx:
        assert _min_row_cosine(out, ref) >= 0.999
    else:
        np.testing.assert_allclose(out, ref, atol=2e-3, rtol=2e-3)


def test_layer_params_match_the_script(setup):
    script, _, params, _ = setup
    rng = np.random.default_rng(0)
    rng.normal(size=(FRAMES, SEQ, WIDTH))  # x is drawn first, as in setup
    ours = S1.make_layer_params(rng, WIDTH)
    for path in (("attn", "in_proj"), ("attn", "out_proj"), ("mlp_fc",), ("mlp_proj",)):
        a, b = ours, params
        for key in path:
            a, b = a[key], b[key]
        for leaf in ("kernel_q", "scale", "bias", "act_scale"):
            np.testing.assert_array_equal(a[leaf], np.asarray(b[leaf]))


@pytest.mark.parametrize("case", CASES)
def test_arm_plain_twin_matches_the_script(setup, case):
    script, x, params, block = setup
    script_mode, block_rows = _script_case(case)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    with jax.disable_jit():  # eager interpret mode: faster here than compiling each arm
        ref = np.asarray(script.make_run(script_mode, block_rows, case == "alias")(
            jnp.asarray(x), jparams))
    mode = S1.arm_of(case)
    ops = S1.arm_operands(block, mode)
    out = S1.run_arm(torch.from_numpy(x), ops, mode, HEADS, plain=True).numpy()
    assert out.shape == x.shape and out.dtype == np.float32
    _check(out, ref, mode in APPROX_RECIPROCAL)


def test_arm_wrappers_take_the_plain_versions_on_the_cpu(setup):
    """On CPU tensors every arm's kernel steps give the plain twin's bits and
    launch nothing."""
    _, x, _, block = setup
    from fitclip_torch.bench import kernels

    counts = [w.launches for w in kernels.WRAPPERS]
    for mode in ("full", "noquant", "lnvar", "sm2mlp16", "bf16gelu", "noattn", "smfdiv"):
        ops = S1.arm_operands(block, mode)
        xt = torch.from_numpy(x)
        assert torch.equal(S1.run_arm(xt, ops, mode, HEADS),
                           S1.run_arm(xt, ops, mode, HEADS, plain=True))
    assert counts == [w.launches for w in kernels.WRAPPERS]


def test_skew_matches_the_script_and_full(setup):
    script, x, params, block = setup
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    with jax.disable_jit():
        ref = np.asarray(script.make_skew_run()(jnp.asarray(x), jparams))
    ops = S1.arm_operands(block, "full")
    xt = torch.from_numpy(x)
    out = S1.SkewSchedule(chunks=2)(xt, ops, HEADS, plain=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3, rtol=2e-3)
    assert torch.equal(out, S1.run_arm(xt, ops, "full", HEADS, plain=True))
