"""fitclip_torch/bench/fit_block.py (S3) against scripts/bench_fit_block.py.

Each arm's plain twin runs on the CPU and is held against the TPU script's
``make_variant(mode)`` kernel body, launched by ``pl.pallas_call(...,
interpret=True)`` with the operand plumbing of ``launch_variant:125-147``
(the script pins VMEM and SMEM, which interpret mode does not take). The
layer is block 0 of tests/test_torch_fit_block.py's tiny FiT (width 48, 4
heads, 2 frames of 2 x 2 patches), quantized and calibrated by JAX; its input
is the block's input on a video. The script's exact-GELU epilogue multiplies
by pl.reciprocal(approx=True), which interpret mode rounds through bf16, while
the plain twin divides exactly: bound, min-row cosine >= 0.999 of each row's
update (output - input, which the input would dominate).
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fitclip_torch.bench import fit_block as S3
from fitclip_torch.bench import kernels

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "bench_fit_block.py"
CASES = ["full", "b2", "pad8", "split2", "noattn", "notime", "nospace", "nocls", "nomlp"]


def _load_script():
    """The script as a module of its own, without writing bytecode into scripts/."""
    spec = importlib.util.spec_from_file_location("_bench_fit_block_script", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    saved, sys.dont_write_bytecode = sys.dont_write_bytecode, True
    try:
        spec.loader.exec_module(module)
    finally:
        sys.dont_write_bytecode = saved
    return module


@pytest.fixture(scope="module")
def setup():
    """tests/test_torch_fit_block.py's tiny setup: (config, JAX block 0, the
    port's block-0 operands, the block-0 input)."""
    from fitclip_tpu.models.frozen_in_time.encoder import FrozenInTimeConfig as JaxConfig
    from fitclip_tpu.models.frozen_in_time.encoder import FrozenInTimeVideoTextEncoder as JaxEnc
    from fitclip_tpu.models.frozen_in_time.encoder import quantize_fit_video_params
    from fitclip_tpu.ops.quant import apply_act_scales
    from fitclip_torch.convert.from_jax import fit_params_from_jax
    from fitclip_torch.models.frozen_in_time.encoder import (FrozenInTimeConfig,
                                                             FrozenInTimeVideoTextEncoder)

    jax_cfg, cfg = JaxConfig.tiny_test(), FrozenInTimeConfig.tiny_test()
    fp32 = JaxEnc(jax_cfg, num_frames=jax_cfg.num_frames, fused_attention=False)
    # jitted: eager flax takes about three times as long here.
    params = jax.tree_util.tree_map(np.asarray, jax.jit(fp32.init_params)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (2, cfg.num_frames, cfg.img_size, cfg.img_size, 3),
                         dtype=np.uint8)
    sep = JaxEnc(jax_cfg, num_frames=jax_cfg.num_frames, dtype="int8", fused_attention=False,
                 fused_block=False)
    qparams = dict(params, video=quantize_fit_video_params(params["video"]))
    qparams = apply_act_scales(qparams, jax.jit(sep.collect_act_amax)(qparams, jnp.asarray(video)))
    enc = FrozenInTimeVideoTextEncoder(cfg, num_frames=cfg.num_frames, quantized=True)
    enc.load_state_dict(fit_params_from_jax(qparams, cfg))
    float_enc = FrozenInTimeVideoTextEncoder(cfg, num_frames=cfg.num_frames)
    float_enc.load_state_dict(fit_params_from_jax(params, cfg))
    seen = []
    hook = float_enc.video.blocks[0].register_forward_pre_hook(
        lambda module, args: seen.append(args[0]))
    with torch.no_grad():
        float_enc.encode_video(torch.from_numpy(video))
    hook.remove()
    return cfg, qparams["video"]["blocks_0"], enc.video.blocks[0].int8_operands(), seen[0]


def _script_layer(mode, x, layer, heads, frames):
    """make_variant(mode) in interpret mode, operands as launch_variant:125-147."""
    from fitclip_tpu.ops import fit_block as fb

    wtq, tqs, tqb, inv_tq = fb._dense_operands(layer["timeattn"]["qkv"])
    wtp, tps, tpb, inv_tp = fb._dense_operands(layer["timeattn"]["proj"])
    wsq, sqs, sqb, inv_sq = fb._dense_operands(layer["attn"]["qkv"])
    wsp, sps, spb, inv_sp = fb._dense_operands(layer["attn"]["proj"])
    wf, fs, fb_, inv_f = fb._dense_operands(layer["mlp_fc1"])
    wp, ps, pb, inv_p = fb._dense_operands(layer["mlp_fc2"])
    invs = jnp.stack([inv_tq, inv_tp, inv_sq, inv_sp, inv_f, inv_p]).reshape(1, 6)
    fs2, fb2 = fs * inv_p, fb_ * inv_p
    kv = jnp.full(fs.shape, 1.0, jnp.float32) * (0.7071067811865475 / inv_p)

    def ln_vec(name, leaf):
        return jnp.asarray(layer[name][leaf]).astype(jnp.float32).reshape(1, -1)

    operands = [x, invs,
                ln_vec("norm3", "weight"), ln_vec("norm3", "bias"), wtq, tqs, tqb,
                wtp, tps, tpb,
                ln_vec("norm1", "weight"), ln_vec("norm1", "bias"), wsq, sqs, sqb,
                wsp, sps, spb,
                ln_vec("norm2", "weight"), ln_vec("norm2", "bias"), wf, fs2, fb2, kv,
                wp, ps, pb]
    kernel = functools.partial(_load_script().make_variant(mode), heads=heads, frames=frames)
    batch, seq, width = x.shape
    in_specs = [pl.BlockSpec((1, seq, width), lambda i: (i, 0, 0))]
    in_specs += [pl.BlockSpec(op.shape, lambda i, nd=op.ndim: (0,) * nd) for op in operands[1:]]
    return pl.pallas_call(kernel, grid=(batch,), in_specs=in_specs,
                          out_specs=pl.BlockSpec((1, seq, width), lambda i: (i, 0, 0)),
                          out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                          interpret=True)(*operands)


def _min_row_cosine(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


@pytest.fixture(scope="module")
def script_out(setup):
    """The script's output per kernel body, computed once (`b2`, `pad8` and
    `split2` compute `full`'s function)."""
    cfg, layer, _, x = setup
    layer_j = jax.tree_util.tree_map(jnp.asarray, layer)
    cache = {}

    def get(body):
        if body not in cache:
            cache[body] = np.asarray(_script_layer(body, jnp.asarray(x.numpy()), layer_j,
                                                   cfg.num_heads, cfg.num_frames))
        return cache[body]
    return get


@pytest.mark.parametrize("case", CASES)
def test_arm_plain_twin_matches_the_script(setup, script_out, case):
    cfg, _, ops, x = setup
    mode = S3.arm_of(case)
    ref = script_out(mode)
    out = S3.run_arm(x, ops, mode, cfg.num_heads, cfg.num_frames, plain=True)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert _min_row_cosine(out.numpy() - x.numpy(), ref - x.numpy()) >= 0.999


def test_a_wrong_arm_misses_the_bound(setup, script_out):
    """`nocls` (only the CLS row's attention differs) held as `full` misses."""
    cfg, _, ops, x = setup
    out = S3.run_arm(x, ops, "nocls", cfg.num_heads, cfg.num_frames, plain=True)
    assert _min_row_cosine(out.numpy() - x.numpy(), script_out("full") - x.numpy()) < 0.999


def test_arm_wrappers_take_the_plain_versions_on_the_cpu(setup):
    """On CPU tensors each arm's kernel steps give the plain twin's bits and
    launch nothing."""
    cfg, _, ops, x = setup
    counts = [w.launches for w in kernels.WRAPPERS]
    for mode in S3.ARMS:
        assert torch.equal(S3.run_arm(x, ops, mode, cfg.num_heads, cfg.num_frames),
                           S3.run_arm(x, ops, mode, cfg.num_heads, cfg.num_frames, plain=True))
    assert counts == [w.launches for w in kernels.WRAPPERS]


def test_case_names():
    assert [S3.arm_of(c) for c in ("b4", "pad8", "split2", "nocls")] == ["full"] * 3 + ["nocls"]
    with pytest.raises(ValueError, match="unknown case"):
        S3.arm_of("nogelu")
