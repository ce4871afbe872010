"""Frozen-in-Time's divided attention in the port (ops/attention.py: K5, K6 and
K4's three int8-mode cores) against the JAX package, on the CPU, where the
wrappers take their plain versions.

- K5/K6 against the Pallas kernels in interpret mode: atol = rtol = 2e-5 in
  fp32 (tests/test_frozen_in_time.py's fused-vs-einsum bound), 2e-2 in bf16.
- K4's cores (before the int8 rounding) against the JAX kernel's own helpers
  of the shipped arm (_time_attention_mxu, _space_attention_packed with the
  concat CLS join, _cls_global_row_packed), which are plain jnp functions:
  atol = rtol = 1e-4 in fp32 on values pre-scaled by out_mul ~ 30.
- float64 models of the kernels' decompositions (csrc/fit_attention.cu): the
  fp32 space kernel's tiling (space_f32_kernel, test_torch_attention.py's
  model of the shared block body with a global key), the time kernel's
  lane mapping and reduction order (time_rows_kernel) and the CLS row's
  (cls_rows_kernel, with its roundings to qkv's dtype), each held against the
  plain version and the Pallas kernel in interpret mode at fp32's atol 1e-5
  (the int8 modes against K4's helpers, over out_mul).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.ops import fit_block as jax_fit_block
from fitclip_tpu.ops.attention import fused_attention_qkv_gkv as jax_gkv
from fitclip_tpu.ops.attention import fused_time_attention as jax_time
from fitclip_torch.ops import attention as A
from test_torch_attention import _f32_forward_model

TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


def _inputs(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 1.5


def _pair(array, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        t = torch.from_numpy(array).to(torch.bfloat16)
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t
    return jnp.asarray(array), torch.from_numpy(array)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("groups,seq,heads,head_dim", [(6, 9, 4, 16), (4, 196, 2, 64)])
def test_gkv_attention_matches_pallas_interpret(dtype, groups, seq, heads, head_dim):
    width = heads * head_dim
    qkv_j, qkv_t = _pair(_inputs(0, groups, seq, 3 * width), dtype)
    gkv_j, gkv_t = _pair(_inputs(1, groups, 3 * width), dtype)
    scale = head_dim ** -0.5
    ref = np.asarray(jax_gkv(qkv_j, gkv_j, heads, scale, interpret=True), np.float32)
    before = A.fused_attention_qkv_gkv.launches
    out = A.fused_attention_qkv_gkv(qkv_t, gkv_t, heads, scale)
    assert A.fused_attention_qkv_gkv.launches == before  # CPU: the plain version
    assert out.dtype == qkv_t.dtype and out.shape == (groups, seq, width)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("batch,frames,patches,heads,head_dim",
                         [(2, 3, 5, 4, 16), (2, 4, 196, 2, 64), (3, 1, 4, 2, 8)])
def test_time_attention_matches_pallas_interpret(dtype, batch, frames, patches, heads,
                                                 head_dim):
    width = heads * head_dim
    qkv_j, qkv_t = _pair(_inputs(2, batch, frames * patches, 3 * width), dtype)
    gkv_j, gkv_t = _pair(_inputs(3, batch, 3 * width), dtype)
    scale = head_dim ** -0.5
    ref = np.asarray(jax_time(qkv_j, gkv_j, heads, frames, scale, interpret=True), np.float32)
    before = A.fused_time_attention.launches
    out = A.fused_time_attention(qkv_t, gkv_t, heads, frames, scale)
    assert A.fused_time_attention.launches == before
    assert out.dtype == qkv_t.dtype and out.shape == (batch, frames * patches, width)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("frames,patches", [(2, 4), (4, 9), (1, 6)])
def test_int8_mode_cores_match_the_shipped_jax_arm(frames, patches):
    heads, head_dim, batch = 2, 16, 2
    width = heads * head_dim
    n = 1 + frames * patches
    qkv = _inputs(4, batch, n, 3 * width)
    qkv_j, qkv_t = jnp.asarray(qkv), torch.from_numpy(qkv)
    scale, out_mul = head_dim ** -0.5, 127.0 / 4.0
    time_ref = jax_fit_block._time_attention_mxu(qkv_j, heads, frames, patches, scale, out_mul)
    space_ref = jax_fit_block._space_attention_packed(qkv_j, heads, frames, patches, scale,
                                                      out_mul, cls_concat=True)
    cls_ref = jax_fit_block._cls_global_row_packed(qkv_j, heads, scale, out_mul)
    for mode, ref in (("time", time_ref), ("space", space_ref)):
        got = A.fit_rows_attention_int8_plain(qkv_t, heads, frames, mode, out_mul)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    got = A.cls_attention_plain(qkv_t, heads, scale, out_mul)
    np.testing.assert_allclose(got.numpy(), np.asarray(cls_ref), atol=1e-4, rtol=1e-4)


def test_int8_wrappers_fill_the_joint_rows_on_the_cpu():
    heads, frames, patches = 2, 2, 4
    qkv = torch.from_numpy(_inputs(5, 2, 1 + frames * patches, 3 * heads * 64))
    counts = [f.launches for f in (A.fit_cls_attention_int8, A.fit_time_attention_int8,
                                   A.fit_space_attention_int8)]
    out = A.fit_cls_attention_int8(qkv, heads, 20.0)
    out = A.fit_time_attention_int8(qkv, heads, frames, 20.0, out)
    scale = 64 ** -0.5
    want_cls = torch.round(A.cls_attention_plain(qkv, heads, scale, 20.0)).clamp(-127, 127)
    want_rows = torch.round(A.fit_rows_attention_int8_plain(qkv, heads, frames, "time", 20.0))
    assert torch.equal(out[:, :1].float(), want_cls)
    assert torch.equal(out[:, 1:].float(), want_rows.clamp(-127, 127))
    assert counts == [f.launches for f in (A.fit_cls_attention_int8, A.fit_time_attention_int8,
                                           A.fit_space_attention_int8)]
    with pytest.raises(ValueError, match="int8"):
        A.fit_space_attention_int8(qkv, heads, frames, 20.0, torch.zeros(2, 9, 128))


# --- the kernels' decompositions in float64 (csrc/fit_attention.cu) ---------------

MODEL_HEADS, MODEL_DIM = 2, 64  # the FiT kernels take head_dim 64
OUT_MUL = 127.0 / 2.5


def _joint(seed, frames, patches):
    """A joint (1, 1 + F * P, 3W) qkv (the global row first), as numpy."""
    return _inputs(seed, 1, 1 + frames * patches, 3 * MODEL_HEADS * MODEL_DIM)


@pytest.fixture(scope="module")
def pallas_space():
    """For P = 20 (one key tile) and 70 (a ragged second tile): the joint qkv
    of 2 frames, _packed_gkv_kernel in interpret mode on its frame groups, and
    K4's space attention (_space_attention_packed, the concat CLS join) on it."""
    cases, scale = {}, MODEL_DIM ** -0.5
    for patches in (20, 70):
        joint = _joint(patches, 2, patches)
        groups = joint[:, 1:].reshape(2, patches, -1)
        gkv = np.repeat(joint[:, 0], 2, axis=0)
        gkv_ref = jax_gkv(jnp.asarray(groups), jnp.asarray(gkv), MODEL_HEADS, scale,
                          interpret=True)
        int8_ref = jax_fit_block._space_attention_packed(jnp.asarray(joint), MODEL_HEADS, 2,
                                                         patches, scale, OUT_MUL, cls_concat=True)
        cases[patches] = joint, np.asarray(gkv_ref), np.asarray(int8_ref)
    return cases



@pytest.mark.parametrize("rows", [64, 32])
@pytest.mark.parametrize("patches", [20, 70])
@pytest.mark.parametrize("mode", ["float", "int8"])
def test_space_f32_tiling_matches_plain_and_pallas(pallas_space, mode, patches, rows):
    """space_f32_kernel's tiling at both row tiers (64-key tiles, key 0 the
    global row in the first): in float mode against attention_gkv_plain and
    _packed_gkv_kernel in interpret mode, in int8 mode (weights exps * (out_mul
    / denom)) against the plain int8 core and K4's space attention, over out_mul."""
    joint, gkv_ref, int8_ref = pallas_space[patches]
    groups = torch.from_numpy(joint[:, 1:].reshape(2, patches, -1))
    gkv = torch.from_numpy(joint[:, 0]).repeat(2, 1)
    scale = MODEL_DIM ** -0.5
    if mode == "float":
        model = _f32_forward_model(groups, MODEL_HEADS, scale, False, None, rows, gkv=gkv)
        plain = A.attention_gkv_plain(groups, gkv, MODEL_HEADS, scale)
        ref = gkv_ref
    else:
        model = _f32_forward_model(groups, MODEL_HEADS, scale, False, None, rows, OUT_MUL,
                                   gkv) / OUT_MUL
        plain = A.fit_rows_attention_int8_plain(torch.from_numpy(joint), MODEL_HEADS, 2, "space",
                                                OUT_MUL).reshape(2, patches, -1) / OUT_MUL
        ref = int8_ref.reshape(2, patches, -1) / OUT_MUL
    assert not torch.isnan(model).any()
    np.testing.assert_allclose(model.numpy(), plain.double().numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(model.numpy(), ref, atol=1e-5, rtol=1e-5)


def _time_rows_model(qkv, gkv, heads, frames, scale, vec, out_mul=1.0):
    """time_rows_kernel in float64, lane for lane: a lane holds `vec` dims of
    one head (8 in bf16, 4 in fp32), a head is a group of 64 / vec lanes; each
    logit is the lane's partial dot (its dims in ascending order) reduced by
    the xor-shuffle tree within the group (offsets 1, 2, 4 (, 8)), every lane
    of the group left with the same sum; K and V sit in the frame tier's
    register slots (4, 8 or 16), the slots past the frame count NaN, so that a
    read of one shows; denom sums the global key first, then the frames in
    ascending order; o = (e_0 norm) v_global + (e_g norm) v_g, g ascending."""
    batch, n, triple = qkv.shape
    width, patches = triple // 3, n // frames
    lanes = MODEL_DIM // vec
    tier = next(t for t in (4, 8, 16) if frames <= t)
    x = qkv.double().reshape(batch, frames, patches, 3, heads, lanes, vec)
    g = gkv.double().reshape(batch, 1, 3, heads, lanes, vec)
    q = x[:, :, :, 0] * scale                                     # (B, F, P, H, lanes, vec)
    k = torch.full((batch, tier, patches, heads, lanes, vec), float("nan"), dtype=torch.float64)
    v = k.clone()
    k[:, :frames], v[:, :frames] = x[:, :, :, 1], x[:, :, :, 2]

    def group_sum(part):                                          # (..., lanes)
        offset = 1
        while offset < lanes:
            part = part + part[..., torch.arange(lanes) ^ offset]
            offset <<= 1
        assert torch.equal(part, part[..., :1].expand_as(part))  # every lane the same bits
        return part[..., 0]

    def dot(key):                                                 # key (B, 1 or P, H, lanes, vec)
        part = torch.zeros(q.shape[:-1], dtype=torch.float64)
        for d in range(vec):
            part = part + q[..., d] * key[:, None, ..., d]
        return group_sum(part)                                    # (B, F, P, H)

    logits = [dot(g[:, :, 1])] + [dot(k[:, j]) for j in range(frames)]
    peak = torch.stack(logits).amax(0)
    exps = [torch.exp(l - peak) for l in logits]
    denom = exps[0]
    for e in exps[1:]:
        denom = denom + e
    norm = out_mul / denom
    out = (exps[0] * norm)[..., None, None] * g[:, :, 2][:, None]
    for j in range(frames):
        out = out + (exps[j + 1] * norm)[..., None, None] * v[:, j][:, None]
    return out.reshape(batch, n, width)


TIME_PATCHES = 3


@pytest.fixture(scope="module")
def pallas_time():
    """For F = 1, 3, 4, 16 (the tiers, full and partly used): the joint qkv,
    _time_attention_kernel in interpret mode on its rows and global row, and
    K4's time attention (_time_attention_mxu) on it."""
    cases, scale = {}, MODEL_DIM ** -0.5
    for frames in (1, 3, 4, 16):
        joint = _inputs(40 + frames, 2, 1 + frames * TIME_PATCHES, 3 * MODEL_HEADS * MODEL_DIM)
        float_ref = jax_time(jnp.asarray(joint[:, 1:]), jnp.asarray(joint[:, 0]), MODEL_HEADS,
                             frames, scale, interpret=True)
        int8_ref = jax_fit_block._time_attention_mxu(jnp.asarray(joint), MODEL_HEADS, frames,
                                                     TIME_PATCHES, scale, OUT_MUL)
        cases[frames] = joint, np.asarray(float_ref), np.asarray(int8_ref)
    return cases


@pytest.mark.parametrize("vec", [8, 4])
@pytest.mark.parametrize("frames", [1, 3, 4, 16])
@pytest.mark.parametrize("mode", ["float", "int8"])
def test_time_rows_mapping_matches_plain_and_pallas(pallas_time, mode, frames, vec):
    """time_rows_kernel's lane mapping (bf16's 8 lanes a head, fp32's 16) and
    reduction order: in float mode against time_attention_plain and
    _time_attention_kernel in interpret mode, in int8 mode against the plain
    int8 core and K4's _time_attention_mxu, over out_mul."""
    joint, float_ref, int8_ref = pallas_time[frames]
    qkv, gkv = torch.from_numpy(joint[:, 1:]), torch.from_numpy(joint[:, 0])
    scale = MODEL_DIM ** -0.5
    if mode == "float":
        model = _time_rows_model(qkv, gkv, MODEL_HEADS, frames, scale, vec)
        plain = A.time_attention_plain(qkv, gkv, MODEL_HEADS, frames, scale)
        ref = float_ref
    else:
        model = _time_rows_model(qkv, gkv, MODEL_HEADS, frames, scale, vec, OUT_MUL) / OUT_MUL
        plain = A.fit_rows_attention_int8_plain(torch.from_numpy(joint), MODEL_HEADS, frames,
                                                "time", OUT_MUL) / OUT_MUL
        ref = int8_ref / OUT_MUL
    assert not torch.isnan(model).any()
    np.testing.assert_allclose(model.numpy(), plain.double().numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(model.numpy(), ref, atol=1e-5, rtol=1e-5)


CLS_WARPS, CLS_UNROLL = 8, 8  # fit_attention.cu: kWarps, cls_rows_kernel's kUnroll


def _cls_rows_model(qkv, heads, scale, out_mul):
    """cls_rows_kernel in float64 with the kernel's roundings to qkv's dtype T
    (q = T(T(q) * T(scale)), weights T(exps * (out_mul / denom))), lane for
    lane: a lane holds vec = 16 / sizeof(T) dims of a head, a group of 64 / vec
    lanes one key; the kernel's loops deal the keys to the groups (each key
    must land on exactly one), each logit is the lane's partial dot (dims
    ascending) reduced by xor-shuffles within the group (every lane the same
    bits); P.V: each group sums its keys' w_j v_j in ascending order, the
    groups of a warp add by xor-shuffles over the group index, the warps in
    order. Returns (B, 1, W) before the int8 rounding, and the weights over
    out_mul (B, N, H)."""
    batch, seq, triple = qkv.shape
    width = triple // 3
    vec = 16 // qkv.element_size()
    lanes = MODEL_DIM // vec
    per_warp = 32 // lanes
    groups = CLS_WARPS * per_warp
    owner = [-1] * seq
    for warp in range(CLS_WARPS):
        for mine in range(per_warp):
            for j0 in range(warp * per_warp, seq, groups * CLS_UNROLL):
                for u in range(CLS_UNROLL):
                    j = j0 + mine + u * groups
                    if j < seq:
                        assert owner[j] == -1, f"key {j} dealt twice"
                        owner[j] = warp * per_warp + mine
    assert min(owner) >= 0, "a key was dealt to no group"
    owner = torch.tensor(owner)
    scale_t = torch.tensor(scale, dtype=qkv.dtype)
    x = qkv.reshape(batch, seq, 3, heads, lanes, vec)
    q = (x[:, 0, 0] * scale_t).double()                           # (B, H, lanes, vec)
    k, v = x[:, :, 1].double(), x[:, :, 2].double()               # (B, N, H, lanes, vec)

    def xor_tree(part, n):                                        # (..., n) -> (...)
        offset = 1
        while offset < n:
            part = part + part[..., torch.arange(n) ^ offset]
            offset <<= 1
        assert torch.equal(part, part[..., :1].expand_as(part))
        return part[..., 0]

    partial = torch.zeros(batch, seq, heads, lanes, dtype=torch.float64)
    for d in range(vec):
        partial = partial + q[:, None, ..., d] * k[..., d]
    logits = xor_tree(partial, lanes)                             # (B, N, H)
    exps = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    weights = (exps * (out_mul / exps.sum(dim=1, keepdim=True))).to(qkv.dtype).double()
    acc = torch.zeros(batch, groups, heads, lanes, vec, dtype=torch.float64)
    for j in range(seq):                                          # each group's keys ascending
        acc[:, owner[j]] += weights[:, j, :, None, None] * v[:, j]
    warp_sums = xor_tree(acc.reshape(batch, CLS_WARPS, per_warp, heads, lanes, vec)
                         .movedim(2, -1), per_warp)               # (B, warps, H, lanes, vec)
    out = warp_sums[:, 0]
    for w in range(1, CLS_WARPS):
        out = out + warp_sums[:, w]
    return out.reshape(batch, 1, width), weights / out_mul


@pytest.mark.parametrize("seq", [1 + 2 * 20, 1 + 4 * 49, 1 + 16 * 36])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cls_rows_mapping_matches_plain_and_pallas(dtype, seq):
    """cls_rows_kernel's lane groups (fp32's 16 lanes a key, bf16's 8) and
    reduction order, with its roundings to qkv's dtype, against
    cls_attention_plain and K4's _cls_global_row_packed on the same values,
    over out_mul: at fp32's 1e-5, and in bf16 at 2^-8 of the largest weight
    times max |v| (one weight rounded the other way to bf16, the float64
    exps against fp32's) plus 1e-5."""
    qkv = torch.from_numpy(_inputs(60 + seq, 2, seq, 3 * MODEL_HEADS * MODEL_DIM)).to(dtype)
    scale = MODEL_DIM ** -0.5
    model, weights = _cls_rows_model(qkv, MODEL_HEADS, scale, OUT_MUL)
    model = model / OUT_MUL
    plain = A.cls_attention_plain(qkv, MODEL_HEADS, scale, OUT_MUL) / OUT_MUL
    qkv_j = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                    else jnp.float32)
    ref = np.asarray(jax_fit_block._cls_global_row_packed(qkv_j, MODEL_HEADS, scale, OUT_MUL),
                     np.float32) / OUT_MUL
    atol = 1e-5
    if dtype == torch.bfloat16:
        atol += 2 ** -8 * float(weights.max()) * float(qkv.float().abs().max())
    assert not torch.isnan(model).any()
    np.testing.assert_allclose(model.numpy(), plain.double().numpy(), atol=atol, rtol=1e-5)
    np.testing.assert_allclose(model.numpy(), ref, atol=atol, rtol=1e-5)
