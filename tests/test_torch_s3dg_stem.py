"""The port's S3D-G stem (fitclip_torch/ops/s3dg_stem.py) against the JAX package
on the CPU: the plain version (what a CPU tensor runs, and what the Hopper kernel
K7 is held against on the card) against the Pallas stem kernel in interpret mode
(`_stem_kernel_path`, stem v3) and the XLA stem it replaced (`_reference_stem`),
the BatchNorm fold, and the packed weights' k order that the kernel reads.

Both the plain version and the Pallas kernel sum in fp32 and round to bf16
once, so they differ only by summation order: equal or one bf16 ulp apart on
all but 1e-3 of the outputs. The XLA stem rounds twice (after the conv and
after the bias), hence JAX's own 3e-2 there (tests/test_s3dg_stem.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fitclip_tpu.models.s3dg import max_pool_3d_tf_padding, space_to_depth as jax_s2d
from fitclip_tpu.models.s3dg_fast import _folded, _st_conv, _stem_kernel_path
from fitclip_torch.models.s3dg import BatchNorm3dInference
from fitclip_torch.ops import s3dg_stem as S

MAX_OFF_ONE_ULP = 1e-3


def _random_stem_params(rng):
    return {"conv1": {
        "conv1": {"kernel": (rng.normal(size=(2, 4, 4, 24, 64)) * 0.1).astype(np.float32)},
        "bn1": {"weight": (1.0 + rng.random(64)).astype(np.float32),
                "bias": (rng.normal(size=64) * 0.1).astype(np.float32),
                "running_mean": (rng.normal(size=64) * 0.1).astype(np.float32),
                "running_var": (1.0 + rng.random(64)).astype(np.float32)}}}


def _bn(node):
    bn = BatchNorm3dInference(64)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in node.items()})
    return bn


def _port_folded(params, dtype=torch.bfloat16):
    with torch.no_grad():
        return S.fold_bn(torch.from_numpy(params["conv1"]["conv1"]["kernel"]),
                         _bn(params["conv1"]["bn1"]), dtype)


def _jax_tree(params):
    return {"conv1": {k: {n: jnp.asarray(v) for n, v in node.items()}
                      for k, node in params["conv1"].items()}}


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    exponent = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(exponent - 7)


def _stem_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    params = _random_stem_params(rng)
    video = rng.normal(size=shape).astype(np.float32)
    return params, video, torch.from_numpy(video).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 4, 32, 32, 3), (1, 6, 16, 16, 3), (2, 6, 32, 32, 3)])
def test_stem_plain_matches_pallas_kernel(shape):
    params, video, x = _stem_inputs(shape)
    ref = np.asarray(_stem_kernel_path(_jax_tree(params), jnp.asarray(video, jnp.bfloat16),
                                       jnp.bfloat16), np.float32)
    got = S.s3dg_stem(x, *_port_folded(params)).float().numpy()  # a CPU tensor: the plain version
    assert got.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 4, shape[3] // 4, 64)
    diff = np.abs(got - ref)
    assert float(((diff > _bf16_ulp(ref)) | (diff > 0) & (ref == 0)).mean()) <= MAX_OFF_ONE_ULP
    cosine = float((ref * got).sum() / (np.linalg.norm(ref) * np.linalg.norm(got)))
    assert cosine > 0.99999, cosine


@pytest.mark.parametrize("shape", [(2, 4, 32, 32, 3), (1, 6, 16, 16, 3)])
def test_stem_plain_matches_xla_stem(shape):
    params, video, x = _stem_inputs(shape, seed=1)
    s = jax_s2d(jnp.asarray(video, jnp.bfloat16))
    ref = _st_conv(_jax_tree(params)["conv1"], s, (2, 4, 4), stride=1, padding=(1, 2, 2),
                   dtype=jnp.bfloat16)[:, 1:, 1:, 1:, :]
    ref = np.asarray(max_pool_3d_tf_padding(ref, (1, 3, 3), (1, 2, 2)), np.float32)
    got = S.s3dg_stem_plain(x, *_port_folded(params)).float().numpy()
    np.testing.assert_allclose(got, ref, atol=3e-2, rtol=3e-2)


def test_fold_bn_matches_jax():
    """The fold is JAX's fp32 arithmetic but for the reciprocal square root: XLA's
    CPU rsqrt is not correctly rounded, the port's 1 / sqrt is (and rounds alike on
    the card). So fp32 values agree to 2 ulp and the bf16 casts agree except where
    an fp32 value sits on a bf16 rounding boundary."""
    params = _random_stem_params(np.random.default_rng(2))
    tree = _jax_tree(params)["conv1"]
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        kernel, bias = (t.float().numpy() for t in _port_folded(params, dtype))
        ref_kernel, ref_bias = (np.asarray(t, np.float32) for t in _folded(tree["conv1"],
                                                                          tree["bn1"], jdtype))
        if dtype == torch.float32:
            np.testing.assert_allclose(kernel, ref_kernel, rtol=2.5e-7, atol=0)
            np.testing.assert_allclose(bias, ref_bias, rtol=2.5e-7, atol=1e-7)  # b - m * inv cancels
        else:
            assert float((kernel != ref_kernel).mean()) < 1e-3
            np.testing.assert_allclose(kernel, ref_kernel, rtol=2 ** -8, atol=0)
            np.testing.assert_allclose(bias, ref_bias, rtol=2 ** -8, atol=0)


def test_packed_weights_are_the_raw_pixel_patch_order():
    """The kernel's implicit GEMM: conv position (t, h, w) is the 4 x 8 x 8 x 3
    patch of raw frames 2t.., rows 2h-2.., columns 2w-2.. (zero outside) times
    pack_stem_weights' (64, 768): the same as the conv over space_to_depth."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 4, 12, 16, 3)).astype(np.float32))
    kernel = torch.from_numpy(rng.normal(size=(2, 4, 4, 24, 64)).astype(np.float32))
    padded = F.pad(x, (0, 0, 2, 4, 2, 4, 0, 2))  # C, W, H, T
    patches = padded.unfold(1, 4, 2).unfold(2, 8, 2).unfold(3, 8, 2)  # B Ts Hs Ws C a r q
    patches = patches.permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(1, 2, 6, 8, 768)
    got = patches @ S.pack_stem_weights(kernel).T
    s = S.space_to_depth(x).permute(0, 4, 1, 2, 3)
    ref = F.conv3d(s, kernel.permute(4, 3, 0, 1, 2), padding=(1, 2, 2))[:, :, 1:, 1:, 1:]
    torch.testing.assert_close(got, ref.permute(0, 2, 3, 4, 1), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 5, 16, 16, 3), (1, 4, 18, 16, 3), (1, 4, 16, 14, 3),
                                   (1, 4, 16, 16)])
def test_stem_rejects_shapes_it_does_not_take(shape):
    x = torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        S.s3dg_stem(x, torch.zeros(2, 4, 4, 24, 64), torch.zeros(64))
