"""A CPU model of the tiling of S2's s8 attention kernel
(``csrc/bench_arms.cu:attention_s8_mma_kernel``) and of slice-requant's row
mapping (``slice_requant_rows_kernel``), held against the plain versions of
``fitclip_torch/bench/kernels.py`` and against the TPU script's
``make_variant`` (``scripts/bench_attn_int8.py``) in Pallas interpret mode.

The s8 model follows the kernel's data layout, not its function: q, k and v
quantized as the kernel quantizes them, QK^T as two 32-d k-steps summed in
int64 (the int32 sums are exact), each warp's 16 rows held per lane as the
m16n8 accumulators hold them (keys 8 nt + 2 t, + 1 of n8 tile nt on lane t),
the row max exact and each row's sum taken per lane in ascending key order in
fp32, then over the quad (lanes t ^ 1, then t ^ 2), the weights divided in
fp32. i8qk's P.V runs in float64 on the bf16 weights; i8qkav's packs the int8
weights into m16n8k32 A fragments register by register as the kernel does
and reads V through the kernel's [d][position] tile (position_key), in int64.
Past 208 keys the keys are swept in tiles of 64, QK^T recomputed in each of
the three passes. Tolerances: i8qk, the model and the plain version within
atol/rtol 1e-2 of the script and of each other (two bf16 ulps, the S2 tests'
bound); i8qkav, the model within 1e-2 of the script but in rows holding a
weight at a rounding boundary, and the model and the plain version within
1e-2 plus one weight step v_amax / 127 of it everywhere (the card's s8 rule's
bound); the plain version's int8 operands equal the script's.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_torch.bench import kernels as P
from fitclip_torch.ops.quant import quantize_rint

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "bench_attn_int8.py"
HEADS, HEAD_DIM = 2, 64
WIDTH = HEADS * HEAD_DIM
RESIDENT_KEYS = 208  # attention_mma.cuh:kResidentKeys
SWEEP_KEYS = 64      # 16 * kSweepSteps
# (frames, tokens): one 16-key tile and a ragged one, two n8 tiles past a
# 32-key step, and the sweep (five 64-key tiles, the last with one key).
SHAPES = [(2, 17), (2, 37), (1, 257)]


def position_key(p: int) -> int:
    """bench_arms.cu:position_key: the key at position p of V's int8 tile."""
    return (p & ~31) + (p & 16) + ((p >> 1) & 1) * 8 + ((p >> 2) & 3) * 2 + (p & 1)


# The kernel's A fragment of one 32-key step (s8_pv's a[]): register i, byte b
# holds lane (g, t)'s weight (n8 tile q of the step, accumulator r).
A_PACKING = (((0, 0), (0, 1), (1, 0), (1, 1)), ((0, 2), (0, 3), (1, 2), (1, 3)),
             ((2, 0), (2, 1), (3, 0), (3, 1)), ((2, 2), (2, 3), (3, 2), (3, 3)))


def _load_script():
    spec = importlib.util.spec_from_file_location("_bench_attn_int8_tiling", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    saved, sys.dont_write_bytecode = sys.dont_write_bytecode, True
    try:
        spec.loader.exec_module(module)
    finally:
        sys.dont_write_bytecode = saved
    module.HEADS, module.HEAD_DIM = HEADS, HEAD_DIM
    return module


@pytest.fixture(scope="module")
def script():
    return _load_script()


def _qkv(frames, seq, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(frames, seq, 3 * WIDTH)).astype(np.float32) * 0.7
    return torch.from_numpy(qkv).to(torch.bfloat16)


def _round_up(n, m):
    return -(-n // m) * m


def _head_model(q8, k8, v8, vb, logit_scale, out_scale, av8, tile):
    """One (frame, head) through the kernel's tiling. q8, k8, v8: int64 (L,
    64); vb: v in bf16; tile: keys a pass holds (208 resident, 64 swept, or
    more to hold every key). Returns the fp32 output (L, 64) and i8qkav's
    weights times 127 before rounding (else None)."""
    seq = q8.shape[0]
    rows = _round_up(seq, 64)  # blocks of four warps of 16 rows
    q = torch.zeros(rows, HEAD_DIM, dtype=torch.int64)
    q[:seq] = q8
    keys = _round_up(seq, tile)
    k = torch.zeros(keys, HEAD_DIM, dtype=torch.int64)
    k[:seq] = k8
    tiles = range(0, seq, tile)
    lane = (torch.arange(tile) % 8) // 2  # the lane t that holds each key of a tile

    def logits(key0):
        """The tile's logits; n8 tiles at and past seq are skipped (0)."""
        kt = k[key0:key0 + tile]
        acc = sum(q[:, 32 * s:32 * s + 32] @ kt[:, 32 * s:32 * s + 32].T for s in range(2))
        acc[:, (torch.arange(tile) // 8) * 8 + key0 >= seq] = 0
        return acc.to(torch.float32) * logit_scale

    def visible(key0):
        return key0 + torch.arange(tile) < seq

    peak = torch.full((rows,), -torch.inf)
    for key0 in tiles:
        peak = torch.maximum(peak, logits(key0)[:, visible(key0)].amax(dim=1))
    passes = {}
    per_lane = torch.zeros(rows, 4)
    for key0 in tiles:
        passes[key0] = logits(key0)
        e = torch.where(visible(key0), torch.exp(passes[key0] - peak[:, None]), 0.0)
        for j in range(tile):  # each lane's keys in ascending order
            per_lane[:, lane[j]] = per_lane[:, lane[j]] + e[:, j]
    denom = (per_lane[:, 0] + per_lane[:, 1]) + (per_lane[:, 2] + per_lane[:, 3])
    out = torch.zeros(rows, HEAD_DIM, dtype=torch.float64 if not av8 else torch.int64)
    w127_all = torch.zeros(rows, keys)
    if av8:
        positions = _round_up(seq, 32)
        vt = torch.zeros(HEAD_DIM, keys + 32, dtype=torch.int64)  # [d][position]
        for p in range(positions):
            if position_key(p) < seq:
                vt[:, p] = v8[position_key(p)]
    vpad = torch.zeros(keys, HEAD_DIM, dtype=torch.float64)
    vpad[:seq] = vb.double()
    for key0 in tiles:
        lt = logits(key0)
        assert torch.equal(lt, passes[key0]), "QK^T differs between passes"
        e = torch.where(visible(key0), torch.exp(lt - peak[:, None]), 0.0)
        w = e / denom[:, None]
        if not av8:
            out += w.to(torch.bfloat16).double() @ vpad[key0:key0 + tile]
            continue
        w127 = w * 127.0
        w8 = torch.round(w127).to(torch.int64)
        w127_all[:, key0:key0 + tile] = w127
        w8 = torch.cat([w8, torch.zeros(rows, 32, dtype=torch.int64)], dim=1)  # past the tile: 0
        for st in range(0, min(tile, seq - key0), 32):  # the 32-key steps below seq
            a = torch.zeros(rows, 32, dtype=torch.int64)
            for reg, packing in enumerate(A_PACKING):
                # PTX's m16n8k32 A layout: register reg of lane (g, t) holds row
                # g + 8 (reg & 1), columns 16 (reg >> 1) + 4 t + byte; the
                # packed value is accumulator r of the lane's row g + 8 (r >> 1).
                dst = torch.nonzero(torch.arange(rows) % 16 // 8 == (reg & 1)).flatten()
                for byte, (qt, r) in enumerate(packing):
                    src = dst + 8 * ((r >> 1) - (reg & 1))
                    for t in range(4):
                        j = st + 8 * qt + 2 * t + (r & 1)  # key within the tile
                        a[dst, 16 * (reg >> 1) + 4 * t + byte] = w8[src, j]
            out += a @ vt[:, key0 + st:key0 + st + 32].T
    if av8:
        return (out.to(torch.float32) * out_scale)[:seq], w127_all[:seq, :seq]
    return out.to(torch.float32)[:seq], None


def s8_model(qkv, heads, scale, block, av8, tile=None):
    """The kernel's tiling over every (frame, head): bf16 (frames, L, W)
    output and i8qkav's weights times 127 before rounding (frames, heads, L,
    L). The scales divide as the kernel and the script do, once each:
    127 / amax (PyTorch's ``127.0 / amax`` is reciprocal(amax) * 127, two
    roundings), q_amax k_amax scale / 127^2 and v_amax / 127^2."""
    frames, seq, triple = qkv.shape
    width = triple // 3
    d = width // heads
    tile = tile or (RESIDENT_KEYS if seq <= RESIDENT_KEYS else SWEEP_KEYS)
    amax = P.attn_amax_plain(qkv, block)
    out = torch.empty(frames, seq, width)
    weights = torch.zeros(frames, heads, seq, seq)
    denominator = torch.tensor(16129.0)
    for f in range(frames):
        a = amax[f // block]
        inv = torch.full_like(a, 127.0) / a
        logit_scale = a[0] * a[1] * scale / denominator
        x = qkv[f].float()
        for h in range(heads):
            cols = [slice(p * width + h * d, p * width + (h + 1) * d) for p in range(3)]
            q8, k8, v8 = (quantize_rint(x[:, c] * inv[p]).to(torch.int64)
                          for p, c in enumerate(cols))
            o, w127 = _head_model(q8, k8, v8, qkv[f][:, cols[2]], logit_scale,
                                  a[2] / denominator, av8, tile)
            out[f, :, h * d:(h + 1) * d] = o
            if av8:
                weights[f, h] = w127
    return out.to(torch.bfloat16), weights


def _rows_near_a_rounding(w127):
    """(frames, L, W): the output rows of a head with a weight w * 127 within
    1e-4 of a rounding boundary (k + 1/2). The script's sums in another order
    and its exp move w * 127 by far less (|w| <= 1, their relative error
    ~1e-7; 2e-6 seen), so only such a weight may round the other way."""
    near = ((w127 - w127.floor()) - 0.5).abs() < 1e-4
    return near.any(dim=-1).transpose(1, 2).repeat_interleave(HEAD_DIM, dim=-1)


def test_position_key_permutes_each_32_key_step():
    """Positions 4 t .. 4 t + 3 of each half step hold lane t's keys, in the
    order of the A packing: (tile q, accumulator r) -> key 8 q + 2 t + (r & 1)."""
    for step in range(3):
        keys = [position_key(32 * step + p) for p in range(32)]
        assert sorted(keys) == list(range(32 * step, 32 * step + 32))
    for reg, packing in enumerate(A_PACKING):
        for byte, (qt, r) in enumerate(packing):
            for t in range(4):
                assert position_key(16 * (reg >> 1) + 4 * t + byte) == 8 * qt + 2 * t + (r & 1)


@pytest.mark.parametrize("av8", [False, True])
@pytest.mark.parametrize("frames,seq", SHAPES)
def test_s8_model_matches_plain_and_script(script, frames, seq, av8):
    qkv = _qkv(frames, seq)
    scale = HEAD_DIM ** -0.5
    mode = "i8qkav" if av8 else "i8qk"
    model, weights = s8_model(qkv, HEADS, scale, 1, av8)
    plain = P.attention_s8_plain(qkv, HEADS, scale, 1, av8)
    ref = np.asarray(script.make_variant(mode, 1)(jnp.asarray(qkv.float().numpy(), jnp.bfloat16)),
                     np.float32)
    if not av8:
        np.testing.assert_allclose(plain.float().numpy(), ref, atol=1e-2, rtol=1e-2)
        np.testing.assert_allclose(model.float().numpy(), plain.float().numpy(), atol=1e-2,
                                   rtol=1e-2)
        np.testing.assert_allclose(model.float().numpy(), ref, atol=1e-2, rtol=1e-2)
        return
    # i8qkav: the model and the plain version quantize q, k and v as the
    # script does (127 / amax one division), so their outputs are the
    # script's but in rows with a weight at a rounding boundary, where an
    # output may move by one weight step v_amax / 127.
    step = float(P.attn_amax_plain(qkv, 1)[:, 2].max()) / 127.0
    ref = torch.from_numpy(ref)
    rows = _rows_near_a_rounding(weights)
    for out in (model, plain):
        np.testing.assert_allclose(out.float()[~rows].numpy(), ref[~rows].numpy(), atol=1e-2,
                                   rtol=1e-2)
        assert float((out.float() - ref).abs().max()) <= 1e-2 + step


@pytest.mark.parametrize("frames,seq", SHAPES)
def test_s8_plain_operands_are_the_scripts(frames, seq):
    """s8_operands_plain's int8 q, k and v are the script's, element for
    element: rint(x * (127 / amax)) clipped to +-127 with 127 / amax one fp32
    division (scripts/bench_attn_int8.py's _variant_kernel)."""
    qkv = _qkv(frames, seq)
    *ops, amax = P.s8_operands_plain(qkv, 1)
    x = jnp.asarray(qkv.float().numpy())
    for p, got in enumerate(ops):
        part = x[..., p * WIDTH:(p + 1) * WIDTH]
        a = jnp.maximum(jnp.max(jnp.abs(part), axis=(1, 2), keepdims=True), 1e-6)
        want = np.asarray(jnp.clip(jnp.round(part * (127.0 / a)), -127, 127).astype(jnp.int8))
        assert int((got.numpy() != want).sum()) == 0, ("q", "k", "v")[p]


@pytest.mark.parametrize("av8", [False, True])
def test_s8_sweep_equals_holding_every_key(av8):
    """Past 208 keys the three passes over 64-key tiles take each lane's sum
    in the order of one resident pass over all the keys: the same bits."""
    qkv = _qkv(1, 257, seed=3)
    scale = HEAD_DIM ** -0.5
    swept, w_swept = s8_model(qkv, HEADS, scale, 1, av8)
    held, w_held = s8_model(qkv, HEADS, scale, 1, av8, tile=_round_up(257, 16))
    assert torch.equal(swept, held) and torch.equal(w_swept, w_held)


@pytest.mark.parametrize("av8", [False, True])
def test_s8_model_per_block_of_frames(av8):
    """block 2 over 3 frames: one scale set for frames 0-1, another for 2."""
    qkv = _qkv(3, 17, seed=4)
    scale = HEAD_DIM ** -0.5
    model, _ = s8_model(qkv, HEADS, scale, 2, av8)
    plain = P.attention_s8_plain(qkv, HEADS, scale, 2, av8)
    step = float(P.attn_amax_plain(qkv, 2)[:, 2].max()) / 127.0 if av8 else 0.0
    assert float((model.float() - plain.float()).abs().max()) <= 1e-2 + step


# --- slice-requant's row mapping --------------------------------------------------

def slice_model(qkv, inv, out, row0, rows):
    """slice_requant_rows_kernel's mapping on the flat buffers: warp r takes
    row row0 + r % rows of clip r // rows; its vectors (8 bf16 / 4 fp32) where
    the row's source starts on 16 bytes and its destination on the vector's
    int8 width, then scalars to the end of the row. Returns how often each
    output element was written."""
    clips, n, triple = qkv.shape
    width = triple // 3
    vec = 16 // qkv.element_size()
    src, dst = qkv.reshape(-1), out.view(-1)
    written = torch.zeros(out.numel(), dtype=torch.int64)
    for r in range(clips * rows):
        clip, rr = divmod(r, rows)
        row = clip * n + row0 + rr
        s0, d0 = row * 3 * width, row * width
        aligned = (s0 * qkv.element_size()) % 16 == 0 and d0 % vec == 0
        vecs = width // vec if aligned else 0
        for lo, hi in ((0, vecs * vec), (vecs * vec, width)):
            dst[d0 + lo:d0 + hi] = quantize_rint(src[s0 + lo:s0 + hi].float() * inv)
            written[d0 + lo:d0 + hi] += 1
    return written.view(out.shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width,row0,rows", [(768, 0, 11), (768, 4, 1), (100, 2, 5), (13, 0, 11),
                                             (12, 7, 3)])
def test_slice_rows_model_matches_plain(dtype, width, row0, rows):
    """Row subsets, one row a clip (`nocls`), and widths that are no multiple
    of 8 (rows whose source is off 16 bytes go scalar; every row keeps a
    scalar tail): each element of the subset written once, equal to the
    plain path, the other rows untouched."""
    gen = torch.Generator().manual_seed(9)
    qkv = (3 * torch.randn(3, 11, 3 * width, generator=gen)).to(dtype)
    inv = 127.0 / 4.0
    model = torch.full((3, 11, width), 7, dtype=torch.int8)
    written = slice_model(qkv, inv, model, row0, rows)
    plain = P.slice_requant(qkv, inv, torch.full_like(model, 7), row0, rows)
    assert torch.equal(model, plain)
    inside = torch.zeros(3, 11, width, dtype=torch.bool)
    inside[:, row0:row0 + rows] = True
    assert bool((written[inside] == 1).all()) and bool((written[~inside] == 0).all())
    assert bool((plain[~inside] == 7).all())
