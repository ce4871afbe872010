"""The port's int8 SpaceTimeBlock (ops/fit_block.py, K4's composition) against
the JAX package on one layer, on the CPU (plain versions).

Parameters: the JAX init of FrozenInTimeConfig.tiny_test (width 48, 4 heads,
2 frames of 2 x 2 patches) and a narrow config with the real head_dim 64,
quantized and calibrated by JAX, carried over with fit_params_from_jax. The
layer input is block 0's input on a video. Bounds, as tests/test_fit_fast.py
holds the TPU kernel: min-row cosine > 0.9995 against the TPU kernel
``fused_fit_int8_layer_pad`` in interpret mode (its pad8 dead rows dropped)
and against the JAX separate-op int8 SpaceTimeBlock.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.frozen_in_time.encoder import FrozenInTimeConfig as JaxConfig
from fitclip_tpu.models.frozen_in_time.encoder import FrozenInTimeVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.frozen_in_time.encoder import quantize_fit_video_params
from fitclip_tpu.models.frozen_in_time.video_transformer import SpaceTimeBlock as JaxBlock
from fitclip_tpu.ops.fit_block import fused_fit_int8_layer_pad
from fitclip_tpu.ops.quant import apply_act_scales
from fitclip_torch.convert.from_jax import fit_params_from_jax
from fitclip_torch.models.frozen_in_time.encoder import (FrozenInTimeConfig,
                                                         FrozenInTimeVideoTextEncoder)
from fitclip_torch.ops import fit_block as K

SHIPPED = "timemxu+spacepack+spacecat+clspack"
NARROW = dict(projection_dim=16, embed_dim=128, depth=2, num_heads=2, img_size=48,
              num_frames=3)


def _configs(name):
    if name == "tiny":
        return JaxConfig.tiny_test(), FrozenInTimeConfig.tiny_test()
    jax_cfg = JaxConfig(**NARROW, text=JaxConfig.tiny_test().text)
    return jax_cfg, FrozenInTimeConfig(**NARROW, text=FrozenInTimeConfig.tiny_test().text)


def _min_cosine(a, b):
    a, b = np.asarray(a, np.float32).reshape(-1, a.shape[-1]), np.asarray(b, np.float32)
    b = b.reshape(a.shape)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


@pytest.fixture(scope="module", params=["tiny", "narrow"])
def setup(request):
    """(config, calibrated int8 JAX video tree, the port's int8 encoder, block-0 input)."""
    jax_cfg, cfg = _configs(request.param)
    fp32 = JaxEncoder(jax_cfg, num_frames=jax_cfg.num_frames, fused_attention=False)
    params = jax.tree_util.tree_map(np.asarray, fp32.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (2, cfg.num_frames, cfg.img_size, cfg.img_size, 3),
                         dtype=np.uint8)
    sep = JaxEncoder(jax_cfg, num_frames=jax_cfg.num_frames, dtype="int8",
                     fused_attention=False, fused_block=False)
    qparams = dict(params, video=quantize_fit_video_params(params["video"]))
    qparams = apply_act_scales(qparams, sep.collect_act_amax(qparams, jnp.asarray(video)))

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
    return cfg, qparams["video"], enc, seen[0]


def _pad8(x, frames, patches):
    """The joint (B, 1 + F*P, W) rows in the TPU's pad8 layout, and the rows to keep."""
    group = -(-patches // 8) * 8
    batch, _, width = x.shape
    rows = x[:, 1:].reshape(batch, frames, patches, width)
    rows = np.pad(rows, ((0, 0), (0, 0), (0, group - patches), (0, 0)))
    padded = np.concatenate([x[:, :1], np.zeros((batch, 7, width), x.dtype),
                             rows.reshape(batch, frames * group, width)], axis=1)
    keep = [0] + [8 + f * group + p for f in range(frames) for p in range(patches)]
    return padded, np.asarray(keep)


@pytest.mark.parametrize("block,dtype", [(0, "float32"), (1, "float32"), (1, "bfloat16")])
def test_int8_block_matches_the_pad8_pallas_kernel(setup, block, dtype):
    cfg, video_tree, enc, x = setup
    frames, patches = cfg.num_frames, (cfg.img_size // cfg.patch_size) ** 2
    x = x.to(getattr(torch, dtype))
    padded, keep = _pad8(x.float().numpy(), frames, patches)
    ref = fused_fit_int8_layer_pad(jnp.asarray(padded).astype(dtype),
                                   video_tree[f"blocks_{block}"], cfg.num_heads, frames=frames,
                                   real_patches=patches, interpret=True, variant=SHIPPED)
    ref = np.asarray(ref, np.float32)[:, keep]
    ops = enc.video.blocks[block].int8_operands()
    out = K.fused_fit_int8_layer(x, ops, cfg.num_heads, frames)
    assert out.dtype == x.dtype and out.shape == x.shape
    out = out.float().numpy()
    cos = _min_cosine(out, ref)
    print(f"K4 block {block} {dtype} vs the pad8 Pallas kernel: min cosine {cos:.7f}, "
          f"max |diff| {np.abs(out - ref).max():.3e}")
    assert cos > 0.9995


def test_int8_block_matches_the_jax_separate_op_block(setup):
    cfg, video_tree, enc, x = setup
    frames, patches = cfg.num_frames, (cfg.img_size // cfg.patch_size) ** 2
    ref = JaxBlock(cfg.embed_dim, cfg.num_heads, dtype=jnp.float32, quantized=True).apply(
        {"params": video_tree["blocks_0"]}, jnp.asarray(x.numpy()), frames, patches)
    out = K.fused_fit_int8_layer_plain(x, enc.video.blocks[0].int8_operands(), cfg.num_heads,
                                       frames)
    cos = _min_cosine(out.numpy(), np.asarray(ref))
    print(f"K4 block vs the JAX separate-op int8 block: min cosine {cos:.7f}")
    assert cos > 0.9995


def test_kernel_wrappers_take_the_plain_versions_on_the_cpu(setup):
    """On CPU tensors the kernel composition is the plain one, bit for bit, and
    launches nothing."""
    cfg, _, enc, x = setup
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import block as B

    wrappers = (B.ln_quant, B.int8_gemm_bias, B.int8_gemm_residual, B.int8_gemm_gelu,
                A.fit_cls_attention_int8, A.fit_time_attention_int8, A.fit_space_attention_int8)
    counts = [w.launches for w in wrappers]
    ops = enc.video.blocks[1].int8_operands()
    for xx in (x, x.to(torch.bfloat16)):
        out = K.fused_fit_int8_layer(xx, ops, cfg.num_heads, cfg.num_frames)
        assert torch.equal(out, K.fused_fit_int8_layer_plain(xx, ops, cfg.num_heads,
                                                             cfg.num_frames))
        assert out.dtype == xx.dtype
    assert counts == [w.launches for w in wrappers]


def test_operands_refold_after_calibration(setup):
    cfg, _, enc, _ = setup
    block = enc.video.blocks[0]
    ops = block.int8_operands()
    assert block.int8_operands() is ops
    np.testing.assert_allclose(ops.fs2.numpy(), (K.prepare_fit_int8_layer(block).fs2).numpy())
    scale = block.mlp_fc2.act_scale.clone()
    with torch.no_grad():
        block.mlp_fc2.act_scale.mul_(2.0)
    refolded = block.int8_operands()
    assert refolded is not ops
    np.testing.assert_allclose(refolded.kv, 2.0 * ops.kv, rtol=1e-6)
    with torch.no_grad():
        block.mlp_fc2.act_scale.copy_(scale)
