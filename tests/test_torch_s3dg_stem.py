"""The port's S3D-G stem (fitclip_torch/ops/s3dg_stem.py) against the JAX package
on the CPU: the plain version (what a CPU tensor runs, and what the Hopper kernel
K7 is held against on the card) against the Pallas stem kernel in interpret mode
(`_stem_kernel_path`, stem v3) and the XLA stem it replaced (`_reference_stem`),
the BatchNorm fold, and the packed weights' k order that the kernel reads.

Both the plain version and the Pallas kernel sum in fp32 and round to bf16
once, so they differ only by summation order: equal or one bf16 ulp apart on
all but 1e-3 of the outputs. The XLA stem rounds twice (after the conv and
after the bias), hence JAX's own 3e-2 there (tests/test_s3dg_stem.py).

A model of the Hopper kernel (csrc/s3dg_stem.cu:s3dg_stem_wgmma_kernel) runs
its data movement on the CPU: the swizzled weights read back through wgmma's
descriptor, the RS-form A gather word by word from a ring of raw rows, the
persistent blocks' runs of pooled rows with the halo row carried, the pools.
It is held to the same rule against the plain version and the Pallas kernel,
and must miss it when the gather or the carry is mutated.
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


# --- a model of csrc/s3dg_stem.cu:s3dg_stem_wgmma_kernel --------------------------

RING, STAGE_WORDS, TILE_COLUMNS, WARPGROUPS = 16, 33, 32, 4  # the kernel's constants


def _row_stride(width):
    return ((8 + 3 * (width + 4)) + 7) // 8 * 8


def _swizzled_weights(packed):
    """The weights as the kernel writes them to shared memory (bf16 elements of a
    96 KB image): slice k // 64, row n at 128 bytes, 16-byte chunk c at c ^ (n & 7)."""
    image = np.full(768 * 64, np.nan, np.float32)
    w = packed.float().numpy()
    for n in range(64):
        for chunk in range(96):
            byte = (chunk >> 3) * 8192 + n * 128 + (((chunk & 7) ^ (n & 7)) << 4)
            image[byte // 2:byte // 2 + 8] = w[n, chunk * 8:chunk * 8 + 8]
    return image


def _b_tile(image, kk):
    """wgmma's B (64 x 16) of k16 step kk through the descriptor: start at slice
    kk // 4 plus 32 bytes a step, rows 128 bytes apart (8-row groups 1024), the
    128-byte swizzle (address bits 4-6 ^= bits 7-9)."""
    n, kin = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    logical = (kk >> 2) * 8192 + (kk & 3) * 32 + n * 128 + kin * 2
    physical = logical ^ (((logical >> 7) & 7) << 4)
    return image[physical // 2]


def _a_index(s, ws, rs2, mutate=None):
    """The RS-form A gather of step s for each warpgroup: [wg] -> (64, 768) element
    indices into the ring (frames x 16 slots x rs), word by word as the lanes read
    them: fragment row m = 16 warp + 8 half + g is conv column 32 wg + 4 g + warp at
    conv row 2s + 1 + half; register words by k16 step within a 48-k chunk (frame a,
    raw rows 2rp, 2rp + 1)."""
    m, k = np.meshgrid(np.arange(64), np.arange(768), indexing="ij")
    warp, half, g = m // 16, (m % 16) // 8, m % 8
    c, sub, kin = k // 48, (k % 48) // 16, k % 16
    t, upper, e = (kin % 8) // 2, kin // 8, kin % 2
    a, rp = c >> 2, c & 3
    slot = ((4 * s) % RING + 2 * rp + 2 * half) % RING
    offsets = np.array([[0, 4], [8, rs2], [rs2 + 4, rs2 + 8]])[sub, upper]
    out = []
    for wg in range(WARPGROUPS):
        p = wg * TILE_COLUMNS + 4 * g + warp
        col_word = 3 * np.minimum(p, ws - 1) + (0 if mutate == "gather" else 1) + t
        word = (a * RING + slot) * rs2 + col_word + offsets
        out.append(2 * word + e)
    return out


def _stem_model(x, kernel, bias, grid, mutate=None):
    """s3dg_stem_wgmma_kernel on the CPU, block by block of a ``grid`` of
    persistent blocks: each block's contiguous run of pooled rows, segment by
    (clip, time), a prologue step then one step a pooled row; its ring of 16 raw
    rows a frame filled as the kernel's copies fill it (the pad columns zero,
    rows outside the clip zero, stale slots left as they are, in chunks of 16 or
    8 bytes); the products of conv rows 2s + 1 and 2s + 2 from the A gather
    (float64 sums of the bf16 operands); bias + ReLU in fp32, one bf16 rounding;
    the vertical max with the carried conv row in registers, the horizontal max
    through the staging row. ``mutate``: "gather" (a word off in each run) or
    "carry" (the step's first conv row carried instead of its second)."""
    b, frames, height, width, _ = x.shape
    ts, hs, ws, hp, wp = frames // 2, height // 2, width // 2, height // 4, width // 4
    rs = _row_stride(width)
    rs2 = rs // 2
    copy_bytes = 16 if width % 8 == 0 else 8
    row_chunks = width * 6 // copy_bytes
    assert row_chunks * copy_bytes == width * 6
    image = _swizzled_weights(S.pack_stem_weights(kernel.to(torch.bfloat16)))
    weights = np.concatenate([_b_tile(image, kk) for kk in range(48)], axis=1)  # (64, 768)
    assert not np.isnan(weights).any()
    bias32 = bias.to(torch.bfloat16).float().numpy()
    xs = x.float().numpy()
    out = np.full((b, ts, hp, wp, 64), np.nan, np.float32)
    units = b * ts * hp
    for block in range(grid):
        ring = np.full((4 * RING, rs), np.nan, np.float32)
        ring[:, :8] = ring[:, 8 + 3 * width:] = 0.0

        def load(bb, tt, r0, count):
            for a in range(4):
                for r in range(r0, r0 + count):
                    f, slot = 2 * tt + a, a * RING + r % RING
                    for chunk in range(row_chunks):
                        lo = chunk * copy_bytes // 2
                        dst = slice(8 + lo, 8 + lo + copy_bytes // 2)
                        valid = f < frames and 0 <= r < height
                        ring[slot, dst] = (xs[bb, f, r].reshape(-1)[lo:lo + copy_bytes // 2]
                                           if valid else 0.0)

        u, last = units * block // grid, units * (block + 1) // grid
        while u < last:
            bt, i0 = divmod(u, hp)
            i_end = min(hp, i0 + last - u)
            bb, tt = divmod(bt, ts)
            load(bb, tt, 4 * i0 - 4, 10)
            carry = np.zeros((WARPGROUPS * TILE_COLUMNS, 64), np.float32)
            for s in range(i0 - 1, i_end):
                flat = ring.reshape(-1).copy()  # what the products read
                if s + 1 < i_end:  # the next step's copies land in slots this step does not read
                    assert not {r % RING for r in range(4 * s + 10, 4 * s + 14)} & \
                        {r % RING for r in range(4 * s, 4 * s + 10)}
                    load(bb, tt, 4 * s + 10, 4)
                stage = np.full((ws, 64), np.nan, np.float32)
                for wg, index in enumerate(_a_index(s, ws, rs2, mutate)):
                    if wg * TILE_COLUMNS >= ws:
                        continue
                    a = flat[index]
                    assert not np.isnan(a).any(), "the gather read a slot never written"
                    d = (a.astype(np.float64) @ weights.T.astype(np.float64)).astype(np.float32)
                    y = torch.relu(torch.from_numpy(d + bias32)).to(torch.bfloat16).float().numpy()
                    rows = np.arange(64)
                    cols = wg * TILE_COLUMNS + 4 * (rows % 8) + rows // 16  # fragment row -> column
                    first, second = y[rows % 16 < 8], y[rows % 16 >= 8]
                    col = cols[rows % 16 < 8]
                    if 2 * s + 2 >= hs:
                        second = np.zeros_like(second)
                    v = np.maximum(carry[col], np.maximum(first, second))
                    carry[col] = first if mutate == "carry" else second
                    if s >= i0:
                        live = col < ws
                        stage[col[live]] = v[live]
                if s >= i0:
                    padded = np.concatenate([stage, np.zeros((1, 64), np.float32)])
                    for q in range(wp):
                        out[bb, tt, s, q] = padded[2 * q:2 * q + 3].max(axis=0)
            u += i_end - i0
    assert not np.isnan(out).any(), "a pooled output was never written"
    return out


STEM_MODEL_SHAPES = [((1, 4, 16, 16, 3), 3), ((1, 4, 12, 20, 3), 2), ((1, 2, 8, 72, 3), 1)]


@pytest.mark.parametrize("shape,grid", STEM_MODEL_SHAPES)
def test_stem_wgmma_model_matches_plain_and_pallas(shape, grid):
    """The kernel's gather, ring and run schedule against s3dg_stem_plain and the
    Pallas stem kernel (v3) in interpret mode: within one bf16 ulp on all but
    1e-3 of the outputs. Shapes: a run split across 3 blocks mid (clip, time)
    (prologues and carries at the cut), a width of 4 mod 8 (8-byte copies) with
    a ragged last pooled row's pad, and 36 conv columns (two warpgroups' tiles,
    the second mostly past the frame)."""
    params, video, x = _stem_inputs(shape, seed=5)
    kernel, bias = _port_folded(params)
    got = _stem_model(x, kernel, bias, grid)
    plain = S.s3dg_stem_plain(x, kernel, bias).float().numpy()
    ref = np.asarray(_stem_kernel_path(_jax_tree(params), jnp.asarray(video, jnp.bfloat16),
                                       jnp.bfloat16), np.float32)
    for want in (plain, ref):
        diff = np.abs(got - want)
        assert float(((diff > _bf16_ulp(want)) | (diff > 0) & (want == 0)).mean()) <= MAX_OFF_ONE_ULP


@pytest.mark.parametrize("mutate", ["gather", "carry"])
def test_stem_wgmma_model_fails_when_mutated(mutate):
    """The model is sharp: a gather one word off, or the halo carry taking the
    wrong conv row, misses the plain version."""
    params, _, x = _stem_inputs(STEM_MODEL_SHAPES[0][0], seed=5)
    kernel, bias = _port_folded(params)
    got = _stem_model(x, kernel, bias, STEM_MODEL_SHAPES[0][1], mutate)
    want = S.s3dg_stem_plain(x, kernel, bias).float().numpy()
    diff = np.abs(got - want)
    assert float(((diff > _bf16_ulp(want)) | (diff > 0) & (want == 0)).mean()) > 0.1
