"""The Hopper kernels of fitclip_torch against their plain PyTorch versions.

The tests marked ``cuda`` need a CUDA card and nvcc; they skip elsewhere. This
file imports torch only (no JAX), so it also runs on a GPU machine without
JAX: ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py``.
The other tests check the dispatch rule on the CPU: a CPU tensor takes the
plain version and launches nothing, and a failed build raises.
"""


import numpy as np
import pytest
import torch

from fitclip_torch import _build
from fitclip_torch.ops import attention as A
from fitclip_torch.ops import block as K
from fitclip_torch.ops import fit_block as FB
from fitclip_torch.ops import s3dg_stem as S

INT8_MAX_FLIPPED = 1e-3  # share of int8 elements allowed one step off
FLOAT_TOL = 2e-2          # bf16 output against the plain version in fp32
LAYER_MAX_OVER = 5e-3     # share of a whole int8 FiT block's outputs past the float rule


def _int8(gen, *shape, device="cpu"):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(device)


def _layer_operands(width, gen, device, quick_gelu=True):
    """Random operands of one int8 layer, shaped as prepare_int8_layer makes them."""
    def vec(n, std=0.1, mean=0.0):
        return (torch.randn(n, generator=gen) * std + mean).to(device)

    def scale(n, k, gain=1.0):
        return ((torch.rand(n, generator=gen) + 0.5) * gain / (73.0 * 73.0 * k ** 0.5)).to(device)

    inv_p = 127.0 / 6.0
    kv = (-1.702 * K.LOG2E / inv_p) if quick_gelu else (0.7071067811865475 / inv_p)
    return K.Int8LayerOperands(
        vec(width, mean=1.0), vec(width), _int8(gen, 3 * width, width, device=device),
        scale(3 * width, width, 1.5), vec(3 * width),
        _int8(gen, width, width, device=device), scale(width, width), vec(width),
        vec(width, mean=1.0), vec(width), _int8(gen, 4 * width, width, device=device),
        scale(4 * width, width, 20.0), vec(4 * width, std=2.0),
        _int8(gen, width, 4 * width, device=device), scale(width, 4 * width), vec(width),
        127.0 / 4.0, 127.0 / 2.5, 127.0 / 4.0, kv, quick_gelu)


def test_cpu_tensors_take_the_plain_versions():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 64, generator=gen)
    ops = _layer_operands(64, gen, "cpu")
    counts = [fn.launches for fn in (K.ln_quant, K.int8_gemm_bias, K.int8_gemm_residual,
                                     K.int8_gemm_gelu, A.attention_int8, A.fused_attention_qkv)]
    out = K.fused_int8_layer(x, ops, heads=1)
    torch.testing.assert_close(out, K.fused_int8_layer_plain(x, ops, heads=1), rtol=0, atol=0)
    A.fused_attention_qkv(torch.randn(2, 5, 192, generator=gen), 1, 0.125)
    assert counts == [fn.launches for fn in (
        K.ln_quant, K.int8_gemm_bias, K.int8_gemm_residual, K.int8_gemm_gelu,
        A.attention_int8, A.fused_attention_qkv)]


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc, or a source that does not compile: the build raises, and
    nothing falls back to the plain versions."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_cuda_wrappers_reject_other_devices():
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.check_cuda_operand("x", torch.zeros(4, device="meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_int8_close(kernel_out, plain_out):
    diff = (kernel_out.int() - plain_out.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff != 0).float().mean()) <= INT8_MAX_FLIPPED


SHAPES = [(6304, 768), (616, 512), (37, 128)]  # ViT-B/16 32 frames, text 8 x 77, ragged


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", SHAPES)
def test_ln_quant_kernel_matches_plain(cuda, rows, width):
    gen = torch.Generator().manual_seed(1)
    gamma = (1 + 0.1 * torch.randn(width, generator=gen)).to(cuda)
    beta = (0.1 * torch.randn(width, generator=gen)).to(cuda)
    for x in (torch.randn(rows, width, generator=gen).to(cuda, torch.bfloat16),
              (3 * torch.randn(rows, width, generator=gen)).to(cuda)):
        before = K.ln_quant.launches
        out = K.ln_quant(x, gamma, beta, 127.0 / 4.0)
        _assert_int8_close(out, K.ln_quant_plain(x, gamma, beta, 127.0 / 4.0))
        assert K.ln_quant.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", SHAPES)
def test_int8_gemm_epilogues_match_plain(cuda, rows, width):
    gen = torch.Generator().manual_seed(2)
    ops = _layer_operands(width, gen, cuda)
    a, a4 = _int8(gen, rows, width, device=cuda), _int8(gen, rows, 4 * width, device=cuda)
    out = K.int8_gemm_bias(a, ops.wq, ops.qs, ops.qb, torch.bfloat16)
    ref = K.int8_gemm_bias_plain(a, ops.wq, ops.qs, ops.qb, torch.float32)
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    x = torch.randn(rows, width, generator=gen).to(cuda, torch.bfloat16)
    out = K.int8_gemm_residual(a, ops.wo, ops.os, ops.ob, x, torch.float32)
    ref = K.int8_gemm_residual_plain(a, ops.wo, ops.os, ops.ob, x, torch.float32)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    x32 = torch.randn(rows, width, generator=gen).to(cuda)
    out = K.int8_gemm_residual(a4, ops.wp, ops.ps, ops.pb, x32, torch.bfloat16)
    ref = K.int8_gemm_residual_plain(a4, ops.wp, ops.ps, ops.pb, x32, torch.float32)
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    for quick in (True, False):
        kv = (-1.702 * K.LOG2E if quick else 0.7071067811865475) / (127.0 / 6.0)
        _assert_int8_close(K.int8_gemm_gelu(a, ops.wf, ops.fs2, ops.fb2, kv, quick),
                           K.int8_gemm_gelu_plain(a, ops.wf, ops.fs2, ops.fb2, kv, quick))


@pytest.mark.cuda
@pytest.mark.parametrize("seq,causal,seq_valid,dtype,heads,head_dim", [
    (197, False, None, torch.bfloat16, 12, 64), (197, True, None, torch.bfloat16, 12, 64),
    (197, False, 150, torch.bfloat16, 12, 64),
    (577, False, None, torch.bfloat16, 12, 64),  # ViT-L/14@336: the mma sweep
    (577, False, None, torch.float32, 16, 64),   # fp32 K and V exceed 227 KB: V through L2
    (577, True, 500, torch.float32, 16, 64),
    (197, False, None, torch.bfloat16, 6, 32),   # ViT-S/16
    (197, True, 150, torch.float32, 6, 32),
    (50, False, None, torch.bfloat16, 12, 64),   # ViT-B/32: the small register tier
    (77, True, 60, torch.bfloat16, 8, 64),       # the text tower, causal, keys masked
    (257, False, None, torch.bfloat16, 16, 64),  # ViT-L/14: the sweep
    (257, True, 200, torch.bfloat16, 16, 64),
    (577, True, 300, torch.bfloat16, 16, 64),
    (9, False, None, torch.bfloat16, 2, 64),     # odd and short: pad rows and keys
    (9, True, 5, torch.bfloat16, 2, 32)])
def test_attention_kernel_matches_plain(cuda, seq, causal, seq_valid, dtype, heads, head_dim):
    gen = torch.Generator().manual_seed(3)
    qkv = (1.5 * torch.randn(2, seq, 3 * heads * head_dim, generator=gen)).to(cuda, dtype)
    scale, out_mul = head_dim ** -0.5, 127.0 / 2.5
    _assert_int8_close(A.attention_int8(qkv, heads, scale, causal, out_mul, seq_valid),
                       A.attention_int8_plain(qkv, heads, scale, causal, out_mul, seq_valid))
    before = A.fused_attention_qkv.launches
    out = A.fused_attention_qkv(qkv, heads, scale, causal)
    assert A.fused_attention_qkv.launches == before + 1
    ref = A.attention_core_plain(qkv.float(), heads, scale, causal)
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    out = A.attention_block(qkv, heads, scale, causal, seq_valid)
    ref = A.attention_core_plain(qkv.float(), heads, scale, causal, 1.0, seq_valid)
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["qkv", "int8", "block"])
@pytest.mark.parametrize("seq,causal,seq_valid,heads,head_dim", [
    (197, False, 150, 12, 64), (77, True, None, 8, 64), (577, False, None, 16, 64),
    (197, False, None, 6, 32)])
def test_attention_kernel_two_launches_bit_identical(cuda, mode, seq, causal, seq_valid, heads,
                                                     head_dim):
    """No atomics and one launch per call: every shipped mode gives the same
    bits twice, on the register-resident body and on the sweep."""
    gen = torch.Generator().manual_seed(13)
    qkv = (1.5 * torch.randn(3, seq, 3 * heads * head_dim, generator=gen)).to(cuda, torch.bfloat16)
    scale = head_dim ** -0.5
    run = {"qkv": lambda: A.fused_attention_qkv(qkv, heads, scale, causal),
           "int8": lambda: A.attention_int8(qkv, heads, scale, causal, 127.0 / 2.5, seq_valid),
           "block": lambda: A.attention_block(qkv, heads, scale, causal, seq_valid)}[mode]
    out = run()
    assert torch.equal(out, run())


@pytest.mark.cuda
def test_attention_body_rule_matches_the_kernel_entry(cuda):
    """attention_body (ops/attention.py) and the kernel entry's rule
    (fitclip_attention_body) agree, so no launch the wrapper makes is refused."""
    lib = _build.library()
    for dtype in (torch.bfloat16, torch.float32):
        for head_dim in A.HEAD_DIMS:
            for seq in range(1, 2049):
                try:
                    want = A.BODIES[A.attention_body(dtype, seq, head_dim)]
                except ValueError:
                    want = -1
                got = lib.fitclip_attention_body(_build.dtype_code(dtype), seq, head_dim)
                assert got == want, (dtype, seq, head_dim)


# The shared memory of the CUDA-core bodies that took every shape before the
# tensor-core core (bf16 and fp32 alike): K^T, V (unless read
# through L2: fp32 at head_dim 64 only) and 8 fp32 row buffers per block.
def _taken_before(dtype, seq, head_dim):
    size, lp = (2 if dtype == torch.bfloat16 else 4), seq + (seq & 1)
    align = lambda n: -(-n // 16) * 16  # noqa: E731
    smem = lambda v_global: (align(size * head_dim * lp) +  # noqa: E731
                             (0 if v_global else align(size * seq * head_dim)) + 32 * lp)
    if smem(False) <= A.SMEM_LIMIT:
        return "f32" if dtype == torch.float32 else "cuda_cores"
    if dtype == torch.float32 and head_dim == 64 and smem(True) <= A.SMEM_LIMIT:
        return "f32_v_global"
    return None


# The longest L of each fp32 forward tier (64 query rows a block, then 32),
# by head_dim: where 64 rows of logits no longer fit beside the Q tile and the
# K/V ring, and where 32 no longer do.
F32_FORWARD_TIERS = {64: {"f32_64": 680, "f32_32": 1448}, 32: {"f32_64": 776, "f32_32": 1608}}


def _f32_forward_tier(seq, head_dim):
    return next((body for body, last in F32_FORWARD_TIERS[head_dim].items() if seq <= last), None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("seq", [9, 50, 77, 197, 257, 577])
def test_attention_body_choice(dtype, seq, head_dim):
    """The wrapper's body is a function of (dtype, L, head_dim): bf16 goes to a
    tensor-core body, register-resident up to 208 keys and swept past it; fp32
    to the register-tiled CUDA-core kernel, 64 query rows a block at every
    CLIP length (the tier of 32 rows starts past 680 keys at head_dim 64)."""
    body = A.attention_body(dtype, seq, head_dim)
    before = _taken_before(dtype, seq, head_dim)
    assert before is not None
    if dtype == torch.bfloat16:
        assert body == ("mma" if seq <= A.MMA_RESIDENT_KEYS else "mma_sweep")
    else:
        assert body == _f32_forward_tier(seq, head_dim) == "f32_64"


def _rn32(x):
    """A rational rounded to the nearest float32, ties to even (normal range)."""
    from fractions import Fraction

    if x == 0:
        return Fraction(0)
    if x < 0:
        return -_rn32(-x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    e += -1 if Fraction(2) ** e > x else (1 if Fraction(2) ** (e + 1) <= x else 0)
    m = x / Fraction(2) ** (e - 23)
    whole, rest = divmod(m.numerator, m.denominator)
    if 2 * rest > m.denominator or (2 * rest == m.denominator and whole % 2):
        whole += 1
    return whole * Fraction(2) ** (e - 23)


@pytest.mark.parametrize("edge", [False, True])
def test_division_by_the_reciprocal_is_correctly_rounded(edge):
    """The mma core's dividing modes (qkv, head0, sm2div, nomax) divide each
    exp e by the row's sum d from y = RN(1 / d): q = RN(e y), r = RN(e - q d)
    (one fma, exact), RN(q + r y) (one fma). Exact arithmetic on random and
    edge-of-binade pairs 0 < e <= d: the result is RN(e / d) every time."""
    from fractions import Fraction

    rng = np.random.default_rng(int(edge))
    for _ in range(4000):
        if edge:  # significands near 2, quotients near 1 and near a binade edge
            d = float(np.float32((2 - rng.random() * 2.0 ** -rng.integers(1, 24))
                                 * 2.0 ** rng.integers(0, 10)))
            e = float(np.float32(d * (1 - rng.random() * 2.0 ** -rng.integers(1, 25))))
        else:
            d = float(np.float32(rng.uniform(1, 2) * 2.0 ** rng.integers(0, 10)))
            e = float(np.float32(d * rng.random() ** rng.choice([1, 4, 20])))
        e, d = Fraction(e), Fraction(d)
        y = _rn32(1 / d)
        q = _rn32(e * y)
        assert _rn32(q + _rn32(e - q * d) * y) == _rn32(e / d), (float(e), float(d))


def _ulp32(x):
    """The spacing of float32 values at the positive rational x (normal range)."""
    from fractions import Fraction

    e = x.numerator.bit_length() - x.denominator.bit_length()
    e += -1 if Fraction(2) ** e > x else (1 if Fraction(2) ** (e + 1) <= x else 0)
    return Fraction(2) ** (e - 23)


@pytest.mark.parametrize("edge", [False, True])
def test_gemm_divide_sequence_is_correctly_rounded(edge):
    """gemm_wgmma.cuh's div_in_range, the IEEE divide's fast sequence: r, the
    hardware reciprocal of d (taken here anywhere within 2 ulp of 1 / d), y =
    RN(r + r RN(1 - d r)), q = RN(a y), RN(q + y RN(a - d q)). Exact arithmetic
    on random and edge-of-binade pairs with both operands inside the range the
    GEMM epilogues take it in: the result is RN(a / d) every time."""
    from fractions import Fraction

    rng = np.random.default_rng(7 + int(edge))
    for _ in range(600):
        if edge:  # significands near 1 and 2, quotients near 1 and a binade edge
            d = float(np.float32((2 - rng.random() * 2.0 ** -rng.integers(1, 24))
                                 * 2.0 ** rng.integers(-30, 30)))
            a = float(np.float32(d * (1 - rng.random() * 2.0 ** -rng.integers(1, 25))
                                 * rng.choice([-1, 1])))
        else:
            d = float(np.float32(rng.uniform(1, 2) * 2.0 ** rng.integers(-30, 30)))
            a = float(np.float32(rng.uniform(-2, 2) * 2.0 ** rng.integers(-30, 30)))
        if a == 0:
            continue
        a, d = Fraction(a), Fraction(d)
        want = _rn32(a / d)
        for off in (-2, -1, 0, 1, 2):
            r = _rn32(1 / d)
            r += off * _ulp32(r)
            y = _rn32(r + r * _rn32(1 - d * r))
            q = _rn32(a * y)
            assert _rn32(q + y * _rn32(a - d * q)) == want, (float(a), float(d), off)


@pytest.mark.parametrize("head_dim", [32, 64])
def test_nosoftmax_refinement_margin(head_dim):
    """The mma core refines a nosoftmax logit x (weight bf16(x)) when x lies
    within 2^-19 m of a bf16 rounding boundary, m = sum |q_d k_d|. On the card
    tests' inputs (q, k ~ 1.5 N(0, 1) in bf16, q scaled by 1/8 in bf16) the
    fp32 bodies' order (one fma per d) and a model of the tensor cores' (each
    k16 step's exact sum added to the accumulator, truncated toward zero)
    stay within a quarter of that."""
    rng = np.random.default_rng(head_dim)

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()

    n = 100_000
    q = bf16(bf16(1.5 * rng.standard_normal((n, head_dim))) * np.float32(0.125))
    k = bf16(1.5 * rng.standard_normal((n, head_dim)))
    prod = q * k  # exact in fp32: two 8-bit significands
    serial = np.zeros(n, np.float32)
    for d in range(head_dim):
        serial = serial + prod[:, d]
    acc = np.zeros(n, np.float64)
    for step in range(head_dim // 16):
        acc = acc + prod[:, 16 * step:16 * step + 16].astype(np.float64).sum(1)
        rounded = acc.astype(np.float32)
        over = np.abs(rounded.astype(np.float64)) > np.abs(acc)
        rounded[over] = np.nextafter(rounded[over], np.float32(0))
        acc = rounded.astype(np.float64)
    m = np.abs(prod).astype(np.float64).sum(1)
    assert float((np.abs(acc - serial) / m).max()) <= 2.0 ** -21


@pytest.mark.parametrize("head_dim", [32, 64])
def test_no_bf16_attention_shape_taken_before_is_refused(head_dim):
    """Over every length: a bf16 shape that the CUDA-core kernel took is taken on a
    tensor-core body, never on an fp32 one; an fp32 shape that the CUDA-core
    bodies took (up to 806 keys at both head dims) is taken on a register-tiled
    tier, the first whose shared memory fits, and the tiers end where
    F32_FORWARD_TIERS says."""
    for seq in range(1, 2049):
        for dtype in (torch.bfloat16, torch.float32):
            before = _taken_before(dtype, seq, head_dim)
            try:
                body = A.attention_body(dtype, seq, head_dim)
            except ValueError:
                body = None
            if dtype == torch.bfloat16:
                assert body in (("mma", "mma_sweep") if before else ("mma", "mma_sweep", None))
            else:
                if before:
                    assert body is not None, (seq, head_dim)
                assert body == _f32_forward_tier(seq, head_dim), (seq, head_dim)


@pytest.mark.cuda
@pytest.mark.parametrize("quick_gelu,causal", [(True, False), (True, True), (False, False)])
def test_fused_int8_layer_kernels_match_plain(cuda, quick_gelu, causal):
    gen = torch.Generator().manual_seed(4)
    width, heads = 768, 12
    ops = _layer_operands(width, gen, cuda, quick_gelu)
    x = torch.randn(4, 197, width, generator=gen).to(cuda, torch.bfloat16)
    out = K.fused_int8_layer(x, ops, heads, causal=causal)
    ref = K.fused_int8_layer_plain(x, ops, heads, causal=causal)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,seq,heads,causal,head_dim", [
    (4, 197, 12, False, 64), (4, 77, 8, True, 64), (3, 50, 12, False, 64),
    (2, 257, 16, True, 64), (1, 577, 16, False, 64),  # every CLIP preset's L
    (4, 197, 6, False, 32), (4, 77, 8, True, 32),     # ViT-S/16's head_dim
    (2, 65, 8, False, 64), (2, 65, 8, True, 64),      # one key past a tile of 64
    (2, 209, 8, False, 64), (2, 209, 8, True, 32)])   # one key past the resident 208
def test_attention_backward_kernel_matches_plain(cuda, dtype, batch, seq, heads, causal,
                                                 head_dim):
    gen = torch.Generator().manual_seed(5)
    width, scale = heads * head_dim, head_dim ** -0.5
    qkv = (1.5 * torch.randn(batch, seq, 3 * width, generator=gen)).to(cuda, dtype)
    grad = torch.randn(batch, seq, width, generator=gen).to(cuda, dtype)
    body = A.backward_body(dtype, seq, head_dim)
    if dtype == torch.bfloat16:
        assert body == "mma"
    elif seq == 577:
        # The rows kernel's two fp32 row buffers of 32 rows fit at L = 577.
        assert body == "f32_32"
        assert A.backward_smem_bytes(seq, head_dim, "f32_32") <= A.SMEM_LIMIT
    before = A.fused_attention_qkv_backward.launches
    out = A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal)
    # At head_dim 32 the scale 32^-1/2 magnifies the bf16 rounding of dL that the
    # kernel takes from the reference: hold it to the plain version with the
    # same casts (on the same inputs) rather than to an fp32 one.
    same_casts = head_dim == 32
    ref = A.attention_backward_plain(qkv if same_casts else qkv.float(),
                                     grad if same_casts else grad.float(), heads, scale,
                                     causal).float()
    assert out.dtype == dtype and out.shape == qkv.shape
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    # No atomics: two launches give the same bits.
    assert torch.equal(out, A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal))
    assert A.fused_attention_qkv_backward.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("seq,causal", [(13, False), (77, True), (150, False), (300, True)])
def test_bf16_attention_backward_pads_ragged_lengths(cuda, seq, causal):
    """bf16 runs the tensor-core body at any L, also one not a multiple of 16:
    the zero-filled pad rows (K and V in the rows kernel, q_s and g in the
    columns kernel) keep every output finite, and a row or key past the end is
    never written over its neighbour's."""
    assert seq % 16 and A.backward_body(torch.bfloat16, seq, 64) == "mma"
    gen = torch.Generator().manual_seed(7)
    qkv = (1.5 * torch.randn(3, seq, 3 * 256, generator=gen)).to(cuda, torch.bfloat16)
    grad = torch.randn(3, seq, 256, generator=gen).to(cuda, torch.bfloat16)
    out = A.fused_attention_qkv_backward(qkv, grad, 4, 0.125, causal)
    assert bool(torch.isfinite(out.float()).all())
    ref = A.attention_backward_plain(qkv.float(), grad.float(), 4, 0.125, causal)
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,heads,causal,head_dim", [
    (1, 900, 4, False, 64), (1, 1000, 2, True, 64), (1, 1700, 2, True, 32)])
def test_bf16_attention_backward_global_body_matches_plain(cuda, batch, seq, heads, causal,
                                                           head_dim):
    """Past 848 keys at head_dim 64 (1600 at 32) bf16 reads V and g through L2
    (mma_global), under the same rules as the shared-memory body."""
    assert A.backward_body(torch.bfloat16, seq, head_dim) == "mma_global"
    gen = torch.Generator().manual_seed(8)
    width, scale = heads * head_dim, head_dim ** -0.5
    qkv = (1.5 * torch.randn(batch, seq, 3 * width, generator=gen)).to(cuda, torch.bfloat16)
    grad = torch.randn(batch, seq, width, generator=gen).to(cuda, torch.bfloat16)
    out = A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal)
    same_casts = head_dim == 32  # as in test_attention_backward_kernel_matches_plain
    ref = A.attention_backward_plain(qkv if same_casts else qkv.float(),
                                     grad if same_casts else grad.float(), heads, scale,
                                     causal).float()
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    assert torch.equal(out, A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal))


@pytest.mark.cuda
def test_attention_backward_body_rule_matches_the_kernel_entry(cuda):
    """backward_body and backward_smem_bytes (ops/attention.py) and the kernel
    entry's rule and sizes (fitclip_attention_bwd_body, _smem_bytes) agree, so
    no launch the wrapper makes is refused."""
    lib = _build.library()
    for dtype in (torch.bfloat16, torch.float32):
        for head_dim in A.HEAD_DIMS:
            for seq in range(1, 3073):
                try:
                    body = A.backward_body(dtype, seq, head_dim)
                    want = A.BACKWARD_BODIES[body]
                    assert lib.fitclip_attention_bwd_smem_bytes(seq, head_dim, want) == \
                        A.backward_smem_bytes(seq, head_dim, body)
                except ValueError:
                    want = -1
                got = lib.fitclip_attention_bwd_body(_build.dtype_code(dtype), seq, head_dim)
                assert got == want, (dtype, seq, head_dim)


F32_TOL = 2e-4  # the reference's float tolerance: fp32 kernel against its fp32 plain version

# (L, causal, seq_valid, head_dim) of the fp32 forward's card tests: short and
# ragged lengths around a 64-key tile, the text tower (causal), ViT-B/16's 197,
# the bf16 core's 208 and 209, ViT-L/14@336's 577, both sides of each tier's
# last length and the longest L each tier takes, at both head dims.
F32_FORWARD_CASES = [
    (1, False, None, 64), (63, False, None, 64), (64, True, None, 64), (65, False, 40, 64),
    (77, True, None, 64), (77, True, 60, 32), (197, False, None, 64), (197, False, 150, 32),
    (208, True, None, 64), (209, False, None, 32), (577, False, None, 64), (577, True, 500, 32),
    (680, False, None, 64), (681, True, None, 64), (776, False, 700, 32), (777, False, None, 32),
    (1448, True, None, 64), (1608, False, None, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("seq,causal,seq_valid,head_dim", F32_FORWARD_CASES)
def test_f32_attention_kernel_matches_plain(cuda, seq, causal, seq_valid, head_dim):
    """The register-tiled fp32 forward in its three modes against the plain
    version in fp32 (the int8 mode under the int8 rule), on the tier its L
    takes; every mode gives the same bits twice and counts one launch."""
    heads = 2 if seq > 600 else 4
    batch = 1 if seq > 600 else 2
    gen = torch.Generator().manual_seed(seq)
    qkv = (1.5 * torch.randn(batch, seq, 3 * heads * head_dim, generator=gen)).to(cuda)
    scale, out_mul = head_dim ** -0.5, 127.0 / 2.5
    assert A.attention_body(torch.float32, seq, head_dim) == _f32_forward_tier(seq, head_dim)
    before = A.attention_f32.launches
    runs = {
        "int8": (lambda: A.attention_int8(qkv, heads, scale, causal, out_mul, seq_valid),
                 A.attention_int8_plain(qkv, heads, scale, causal, out_mul, seq_valid)),
        "qkv": (lambda: A.fused_attention_qkv(qkv, heads, scale, causal),
                A.attention_core_plain(qkv, heads, scale, causal)),
        "block": (lambda: A.attention_block(qkv, heads, scale, causal, seq_valid),
                  A.attention_core_plain(qkv, heads, scale, causal, 1.0, seq_valid))}
    for mode, (run, ref) in runs.items():
        out = run()
        if mode == "int8":
            _assert_int8_close(out, ref)
        else:
            assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
            torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=F32_TOL)
        assert torch.equal(out, run()), mode
    assert A.attention_f32.launches == before + 6


# (batch, L, heads, causal, head_dim) of the fp32 backward's card tests: the
# same lengths, both sides of the rows kernel's tier end (32 rows a block to
# 680 keys at head_dim 64 and 776 at 32) and the longest L of each tier.
F32_BACKWARD_TIERS = {64: {"f32_32": 680, "f32_16": 1448}, 32: {"f32_32": 776, "f32_16": 1608}}
F32_BACKWARD_CASES = [
    (2, 1, 4, False, 64), (2, 63, 4, True, 64), (2, 64, 4, False, 32), (2, 65, 4, True, 64),
    (4, 77, 8, True, 64), (4, 197, 12, False, 64), (4, 197, 6, False, 32), (2, 208, 4, True, 32),
    (2, 209, 4, False, 64), (2, 296, 4, False, 64), (2, 297, 4, True, 64), (2, 360, 4, True, 32),
    (2, 361, 4, False, 32), (1, 577, 8, False, 64), (1, 577, 8, True, 32), (1, 680, 2, True, 64),
    (1, 681, 2, False, 64), (1, 776, 2, False, 32), (1, 777, 2, True, 32), (1, 1448, 2, True, 64),
    (1, 1608, 2, False, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,heads,causal,head_dim", F32_BACKWARD_CASES)
def test_f32_attention_backward_kernel_matches_plain(cuda, batch, seq, heads, causal, head_dim):
    """The register-tiled fp32 backward (rows kernel on the tier its L takes,
    then the columns kernel) against the plain version in fp32; two launches
    give the same bits (no atomics) and each counts one fp32 launch."""
    tier = next(body for body, last in F32_BACKWARD_TIERS[head_dim].items() if seq <= last)
    assert A.backward_body(torch.float32, seq, head_dim) == tier
    gen = torch.Generator().manual_seed(seq + head_dim)
    width, scale = heads * head_dim, head_dim ** -0.5
    qkv = (1.5 * torch.randn(batch, seq, 3 * width, generator=gen)).to(cuda)
    grad = torch.randn(batch, seq, width, generator=gen).to(cuda)
    before = A.attention_bwd_f32.launches
    out = A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal)
    ref = A.attention_backward_plain(qkv, grad, heads, scale, causal)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=F32_TOL)
    assert torch.equal(out, A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal))
    assert A.attention_bwd_f32.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq,heads", [(77, 8), (577, 8)])  # 577 fp32: both global variants
def test_attention_function_gradient_through_both_kernels(cuda, causal, seq, heads):
    gen = torch.Generator().manual_seed(6)
    qkv = (1.5 * torch.randn(2, seq, 3 * 512, generator=gen)).to(cuda).requires_grad_()
    grad = torch.randn(2, seq, 512, generator=gen).to(cuda)
    counts = (A.fused_attention_qkv.launches, A.fused_attention_qkv_backward.launches)
    A.fused_attention_qkv(qkv, heads, 0.125, causal).backward(grad)
    assert (A.fused_attention_qkv.launches, A.fused_attention_qkv_backward.launches) == (
        counts[0] + 1, counts[1] + 1)
    ref = A.attention_backward_plain(qkv.detach(), grad, heads, 0.125, causal)
    torch.testing.assert_close(qkv.grad, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_on_the_kernels_gives_the_same_gradients(cuda, remat):
    """Activation checkpointing over K3: the same gradients as without it; full
    remat launches each attention forward again in the backward pass, "dots"
    keeps its output."""
    from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_torch.models.clip.model import (CLIPConfig, TextConfig, VisionConfig,
                                                 init_float_params)

    config = CLIPConfig(embed_dim=64,
                        vision=VisionConfig(image_size=32, patch_size=16, width=128, layers=2,
                                            heads=2),
                        text=TextConfig(context_length=16, vocab_size=64, width=128, layers=2,
                                        heads=2))
    gen = torch.Generator().manual_seed(7)
    video = torch.randint(0, 256, (3, 2, 32, 32, 3), generator=gen, dtype=torch.uint8).to(cuda)
    text = torch.randint(1, 63, (3, 16), generator=gen).to(cuda)

    def grads(remat):
        enc = ClipVideoTextEncoder(config, num_frames=2, dtype=torch.bfloat16,
                                   fused_attention=True, remat=remat)
        init_float_params(enc.model, seed=0)
        enc.to(cuda)
        counts = (A.fused_attention_qkv.launches, A.fused_attention_qkv_backward.launches)
        loss = (enc.encode_video(video) @ enc.encode_text(text).T).square().sum()
        names, params = zip(*enc.model.named_parameters())
        out = dict(zip(names, torch.autograd.grad(loss, params)))
        return out, (A.fused_attention_qkv.launches - counts[0],
                     A.fused_attention_qkv_backward.launches - counts[1])

    ref, ref_launches = grads(False)
    got, launches = grads(remat)
    layers = 2 * 2  # two towers of two layers
    assert ref_launches == (layers, layers)
    assert launches == ((2 * layers if remat is True else layers), layers)
    for name, value in ref.items():
        torch.testing.assert_close(got[name], value, msg=name)


# --- Frozen-in-Time: csrc/fit_attention.cu and K4's composition ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("groups,seq,heads", [(8, 196, 12), (6, 9, 2), (3, 49, 4),
                                               (2, 300, 4)])  # 301 keys: the sweep
def test_gkv_attention_kernel_matches_plain(cuda, dtype, groups, seq, heads):
    gen = torch.Generator().manual_seed(8)
    width, scale = heads * 64, 64 ** -0.5
    qkv = (1.5 * torch.randn(groups, seq, 3 * width, generator=gen)).to(cuda, dtype)
    gkv = (1.5 * torch.randn(groups, 3 * width, generator=gen)).to(cuda, dtype)
    before = A.fused_attention_qkv_gkv.launches
    out = A.fused_attention_qkv_gkv(qkv, gkv, heads, scale)
    ref = A.attention_gkv_plain(qkv.float(), gkv.float(), heads, scale)
    assert out.dtype == dtype and out.shape == (groups, seq, width)
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    assert torch.equal(out, A.fused_attention_qkv_gkv(qkv, gkv, heads, scale))
    assert A.fused_attention_qkv_gkv.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,frames,patches,heads", [(2, 4, 196, 12), (3, 1, 7, 2),
                                                        (2, 16, 5, 4)])
def test_time_attention_kernel_matches_plain(cuda, dtype, batch, frames, patches, heads):
    gen = torch.Generator().manual_seed(9)
    width, scale = heads * 64, 64 ** -0.5
    qkv = (1.5 * torch.randn(batch, frames * patches, 3 * width, generator=gen)).to(cuda, dtype)
    gkv = (1.5 * torch.randn(batch, 3 * width, generator=gen)).to(cuda, dtype)
    before = A.fused_time_attention.launches
    out = A.fused_time_attention(qkv, gkv, heads, frames, scale)
    ref = A.time_attention_plain(qkv.float(), gkv.float(), heads, frames, scale)
    assert out.dtype == dtype and out.shape == (batch, frames * patches, width)
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    assert torch.equal(out, A.fused_time_attention(qkv, gkv, heads, frames, scale))
    assert A.fused_time_attention.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["time", "space"])
@pytest.mark.parametrize("frames,patches,heads", [(4, 196, 12), (2, 5, 2), (1, 9, 4),
                                                    (2, 240, 2)])  # 241 keys: the sweep
def test_fit_int8_attention_kernels_match_plain(cuda, mode, frames, patches, heads):
    gen = torch.Generator().manual_seed(10)
    width = heads * 64
    qkv = (1.5 * torch.randn(3, 1 + frames * patches, 3 * width, generator=gen)).to(
        cuda, torch.bfloat16)
    counts = (A.fit_cls_attention_int8.launches, A.fit_time_attention_int8.launches,
              A.fit_space_attention_int8.launches)
    out = FB.fit_attention_int8(qkv, heads, frames, mode, 127.0 / 2.5)
    _assert_int8_close(out, FB.fit_attention_int8_plain(qkv, heads, frames, mode, 127.0 / 2.5))
    assert torch.equal(out, FB.fit_attention_int8(qkv, heads, frames, mode, 127.0 / 2.5))
    time = int(mode == "time")
    assert (A.fit_cls_attention_int8.launches, A.fit_time_attention_int8.launches,
            A.fit_space_attention_int8.launches) == (counts[0] + 2, counts[1] + 2 * time,
                                                     counts[2] + 2 * (1 - time))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float", "int8"])
@pytest.mark.parametrize("patches", [70, 196, 700])  # 701 keys: the 32-row tier
def test_space_f32_kernel_matches_plain(cuda, mode, patches):
    """space_f32_kernel (K5 and K4's space core on an fp32 qkv) against the
    plain versions in fp32 (int8 under the int8 rule): a ragged second key
    tile, FiT base's 197 keys and, past 680 keys, the 32-row tier; two
    launches give the same bits."""
    gen = torch.Generator().manual_seed(patches)
    heads, frames = (2, 1) if patches > 600 else (4, 2)
    scale, out_mul = 64 ** -0.5, 127.0 / 2.5
    joint = (1.5 * torch.randn(2, 1 + frames * patches, 3 * heads * 64, generator=gen)).to(cuda)
    if mode == "float":
        groups = joint[:, 1:].reshape(2 * frames, patches, -1).contiguous()
        gkv = joint[:, 0].repeat_interleave(frames, dim=0).contiguous()
        before = A.fused_attention_qkv_gkv.launches
        out = A.fused_attention_qkv_gkv(groups, gkv, heads, scale)
        ref = A.attention_gkv_plain(groups, gkv, heads, scale)
        assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
        torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=F32_TOL)
        assert torch.equal(out, A.fused_attention_qkv_gkv(groups, gkv, heads, scale))
        assert A.fused_attention_qkv_gkv.launches == before + 2
    else:
        out = A.fit_space_attention_int8(joint, heads, frames, out_mul)
        _assert_int8_close(out[:, 1:], torch.round(A.fit_rows_attention_int8_plain(
            joint, heads, frames, "space", out_mul)).clamp(-127, 127).to(torch.int8))
        assert torch.equal(out, A.fit_space_attention_int8(joint, heads, frames, out_mul))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("frames", list(range(1, 17)))
def test_time_rows_kernel_frame_tiers_match_plain(cuda, dtype, frames):
    """time_rows_kernel at every frame count of its three register tiers
    (F <= 4, 8, 16), in float mode (K6) and with int8 output (K4's time core)
    on the same rows; 3 heads leave a lane group idle (bf16: 4 heads a warp;
    fp32: 2 heads a warp, the second warp of a location half idle)."""
    gen = torch.Generator().manual_seed(100 + frames)
    heads, patches = 3, 7
    scale, out_mul = 64 ** -0.5, 127.0 / 2.5
    joint = (1.5 * torch.randn(2, 1 + frames * patches, 3 * heads * 64, generator=gen)).to(
        cuda, dtype)
    rows, gkv = joint[:, 1:].contiguous(), joint[:, 0].contiguous()
    out = A.fused_time_attention(rows, gkv, heads, frames, scale)
    ref = A.time_attention_plain(rows.float(), gkv.float(), heads, frames, scale)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    assert torch.equal(out, A.fused_time_attention(rows, gkv, heads, frames, scale))
    out = A.fit_time_attention_int8(joint, heads, frames, out_mul)
    _assert_int8_close(out[:, 1:], torch.round(A.fit_rows_attention_int8_plain(
        joint, heads, frames, "time", out_mul)).clamp(-127, 127).to(torch.int8))
    assert torch.equal(out, A.fit_time_attention_int8(joint, heads, frames, out_mul))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seq,heads", [(1, 3), (2, 3), (33, 3), (785, 12), (3137, 2)])
def test_cls_rows_kernel_matches_plain(cuda, dtype, seq, heads):
    """cls_rows_kernel (K4's CLS row) in bf16 and fp32: one key, fewer keys than
    a block's lane groups, a ragged unrolled round, FiT base's 785 keys and 16
    frames' 3137, under the int8 rule against cls_attention_plain; two
    launches give the same bits and count two."""
    gen = torch.Generator().manual_seed(seq)
    out_mul = 127.0 / 2.5
    qkv = (1.5 * torch.randn(3, seq, 3 * heads * 64, generator=gen)).to(cuda, dtype)
    before = A.fit_cls_attention_int8.launches
    out = A.fit_cls_attention_int8(qkv, heads, out_mul)
    plain = torch.round(A.cls_attention_plain(qkv, heads, 64 ** -0.5, out_mul)).clamp(-127, 127)
    _assert_int8_close(out[:, :1], plain.to(torch.int8))
    assert not out[:, 1:].any()  # row 0 alone is written
    assert torch.equal(out, A.fit_cls_attention_int8(qkv, heads, out_mul))
    assert A.fit_cls_attention_int8.launches == before + 2


@pytest.mark.cuda
def test_cls_rows_kernel_refuses_what_its_vectors_do_not_take(cuda):
    """The C entry refuses (without a launch) a qkv pointer off 16 bytes, and an
    output pointer or clip stride that is not a whole int8 vector (8 bytes
    from bf16, 4 from fp32)."""
    heads, seq = 2, 9
    for dtype, vec in ((torch.bfloat16, 8), (torch.float32, 4)):
        qkv = torch.zeros(2, seq, 3 * heads * 64 + 16, dtype=dtype, device=cuda)
        out = torch.zeros(2, seq, heads * 64 + 16, dtype=torch.int8, device=cuda)
        code = _build.dtype_code(dtype)
        cases = [(qkv.data_ptr() + 8, out.data_ptr(), seq * heads * 64),
                 (qkv.data_ptr(), out.data_ptr() + vec // 2, seq * heads * 64),
                 (qkv.data_ptr(), out.data_ptr(), seq * heads * 64 + vec // 2)]
        for qkv_ptr, out_ptr, stride in cases:
            with pytest.raises(RuntimeError, match="fitclip_fit_cls_attention"):
                _build.call("fitclip_fit_cls_attention", qkv_ptr, code, out_ptr, stride, 2, seq,
                            heads, 64, 0.125, 1.0)


def _fit_operands(width, gen, device):
    """Random operands of one FiT block: the time half from one K1 layer's,
    the space half and the MLP (exact GELU) from another's."""
    a = _layer_operands(width, gen, device, quick_gelu=False)
    b = _layer_operands(width, gen, device, quick_gelu=False)
    return FB.FitLayerOperands(
        a.ln1_weight, a.ln1_bias, a.wq, a.qs, a.qb, a.wo, a.os, a.ob,
        b.ln1_weight, b.ln1_bias, b.wq, b.qs, b.qb, b.wo, b.os, b.ob,
        a.ln2_weight, a.ln2_bias, a.wf, a.fs2, a.fb2, a.wp, a.ps, a.pb,
        a.inv_q, a.inv_o, b.inv_q, b.inv_o, a.inv_f, a.kv)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [4, 1])
def test_fused_fit_int8_layer_kernels_match_plain(cuda, frames):
    gen = torch.Generator().manual_seed(11)
    width, heads = 768, 12
    ops = _fit_operands(width, gen, cuda)
    x = torch.randn(2, 1 + frames * 196, width, generator=gen).to(cuda, torch.bfloat16)
    out = FB.fused_fit_int8_layer(x, ops, heads, frames)
    ref = FB.fused_fit_int8_layer_plain(x, ops, heads, frames)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=FLOAT_TOL, rtol=FLOAT_TOL)


# --- S3D-G: csrc/s3dg_stem.cu (K7) and the int8 sites of the fast forward ------

def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(torch.float32).tiny)))
                      - 7)


def _stem_operands(shape, gen, device):
    x = torch.rand(*shape, generator=gen).to(device, torch.bfloat16)
    kernel = (0.05 * torch.randn(2, 4, 4, 24, 64, generator=gen)).to(device, torch.bfloat16)
    bias = (0.1 * torch.randn(64, generator=gen)).to(device, torch.bfloat16)
    return x, kernel, bias


def test_stem_on_a_cpu_tensor_takes_the_plain_version():
    x, kernel, bias = _stem_operands((1, 2, 8, 8, 3), torch.Generator().manual_seed(12), "cpu")
    before = S.s3dg_stem.launches
    torch.testing.assert_close(S.s3dg_stem(x, kernel, bias), S.s3dg_stem_plain(x, kernel, bias),
                               rtol=0, atol=0)
    assert S.s3dg_stem.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 32, 32, 3), (1, 6, 36, 44, 3), (1, 2, 224, 224, 3),
                                   (1, 2, 8, 8, 3), (3, 8, 64, 240, 3)])
def test_stem_kernel_matches_plain(cuda, shape):
    """Within one bf16 ulp of the plain fp32 result on all but 1e-3 of the outputs,
    and the same bits on a second launch: s3dg_stem_wgmma_kernel at a width of 4
    mod 8 (8-byte copies), one conv column tile, and at 240 columns (four
    warpgroup tiles) with more pooled rows than blocks (runs cut mid (clip,
    time): a prologue and carry at each cut)."""
    x, kernel, bias = _stem_operands(shape, torch.Generator().manual_seed(13), cuda)
    before = S.s3dg_stem.launches
    out = S.s3dg_stem(x, kernel, bias)
    ref = S.s3dg_stem_plain(x, kernel, bias).float()
    b, t, h, w, _ = shape
    assert out.dtype == torch.bfloat16 and out.shape == (b, t // 2, h // 4, w // 4, 64)
    diff = (out.float() - ref).abs()
    assert float((diff > _bf16_ulp(ref)).float().mean()) <= INT8_MAX_FLIPPED
    assert torch.equal(out, S.s3dg_stem(x, kernel, bias))
    assert S.s3dg_stem.launches == before + 2


@pytest.mark.cuda
def test_stem_kernel_takes_kept_operands(cuda):
    """The fast forward's kept operands (stem_operands) give the same bits as
    packing them in the call."""
    x, kernel, bias = _stem_operands((2, 4, 32, 40, 3), torch.Generator().manual_seed(16), cuda)
    packed = S.stem_operands(kernel, bias)
    assert torch.equal(S.s3dg_stem(x, kernel, bias, packed=packed), S.s3dg_stem(x, kernel, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 5, 32, 32, 3), (1, 4, 30, 32, 3), (1, 4, 32, 34, 3),
                                   (1, 4, 32, 248, 3)])
def test_stem_kernel_rejects_shapes_it_does_not_take(cuda, shape):
    x, kernel, bias = _stem_operands((1, 2, 8, 8, 3), torch.Generator().manual_seed(14), cuda)
    before = S.s3dg_stem.launches
    with pytest.raises(ValueError):
        S.s3dg_stem(torch.zeros(shape, dtype=torch.bfloat16, device=cuda), kernel, bias)
    assert S.s3dg_stem.launches == before


@pytest.mark.cuda
def test_mil_nce_int8_encode_runs_the_stem_and_int8_gemm_kernels(cuda):
    """The int8 MIL-NCE encode on the card: one stem launch, 15 int8 GEMM launches
    (7 blocks x (merged, b3) + fc), and the plain versions' embedding."""
    from fitclip_torch.models.mil_nce import load_mil_nce_encoder
    from fitclip_torch.models.s3dg_fast import s3dg_fast_apply

    enc = load_mil_nce_encoder(dtype="int8", device="cuda", seed=0).encoder
    video = torch.randint(0, 256, (2, 16, 224, 224, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(15)).to(cuda)
    with torch.no_grad():
        enc.calibrate(video)
        counts = (S.s3dg_stem.launches, K.int8_gemm_bias.launches)
        out = enc.encode_video(video)
        torch.cuda.synchronize()
        assert (S.s3dg_stem.launches - counts[0], K.int8_gemm_bias.launches - counts[1]) == (1, 15)
        plain = s3dg_fast_apply(enc.video, enc._prepare_video(video), torch.bfloat16, int8=True,
                                plain=True)
    cos = torch.nn.functional.cosine_similarity(out.float(), plain.float(), dim=-1)
    assert out.shape == (2, 512) and float(cos.min()) > 0.999


# --- the float layer (K2), K8 and the static int8 dense ---------------------

def _float_operands(width, gen, device):
    """Random bf16 operands of one float layer, shaped as prepare_bf16_layer makes them."""
    def vec(n, std=0.1, mean=0.0):
        return (torch.randn(n, generator=gen) * std + mean).to(device)

    def weight(n, k):
        return (torch.randn(n, k, generator=gen) * k ** -0.5).to(device, torch.bfloat16)

    return K.Bf16LayerOperands(
        vec(width, mean=1.0), vec(width), weight(3 * width, width), vec(3 * width),
        weight(width, width), vec(width), vec(width, mean=1.0), vec(width),
        weight(4 * width, width), vec(4 * width), weight(width, 4 * width), vec(width))


def test_cpu_tensors_take_the_plain_float_layer():
    gen = torch.Generator().manual_seed(5)
    ops = _float_operands(64, gen, "cpu")
    x = torch.randn(2, 5, 64, generator=gen).bfloat16()
    wrappers = (K.ln_cast, K.bf16_gemm_bias, K.bf16_gemm_residual, K.bf16_gemm_gelu,
                A.attention_block)
    counts = [fn.launches for fn in wrappers]
    out = K.fused_bf16_layer(x, ops, heads=1, quick_gelu=False)
    torch.testing.assert_close(out, K.fused_bf16_layer_plain(x, ops, heads=1, quick_gelu=False),
                               rtol=0, atol=0)
    assert counts == [fn.launches for fn in wrappers]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", SHAPES)
def test_ln_cast_kernel_matches_plain(cuda, rows, width):
    gen = torch.Generator().manual_seed(6)
    gamma = (1 + 0.1 * torch.randn(width, generator=gen)).to(cuda)
    beta = (0.1 * torch.randn(width, generator=gen)).to(cuda)
    for x in (torch.randn(rows, width, generator=gen).to(cuda, torch.bfloat16),
              (3 * torch.randn(rows, width, generator=gen)).to(cuda)):
        before = K.ln_cast.launches
        out = K.ln_cast(x, gamma, beta, torch.bfloat16, 1e-6)
        assert out.dtype == torch.bfloat16 and K.ln_cast.launches == before + 1
        ref = K.layer_norm_plain(x, gamma, beta, 1e-6)
        torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", SHAPES)
def test_bf16_gemm_epilogues_match_plain(cuda, rows, width):
    gen = torch.Generator().manual_seed(7)
    ops = _float_operands(width, gen, cuda)
    a = torch.randn(rows, width, generator=gen).to(cuda, torch.bfloat16)
    a4 = torch.randn(rows, 4 * width, generator=gen).to(cuda, torch.bfloat16)

    def close(out, ref):
        torch.testing.assert_close(out.float(), ref.float(), atol=FLOAT_TOL, rtol=FLOAT_TOL)

    close(K.bf16_gemm_bias(a, ops.wq, ops.qb), K._dense_plain(a, ops.wq, ops.qb))
    x = torch.randn(rows, width, generator=gen).to(cuda, torch.bfloat16)
    out = K.bf16_gemm_residual(a, ops.wo, ops.ob, x, torch.float32)
    assert out.dtype == torch.float32
    close(out, K.bf16_gemm_residual_plain(a, ops.wo, ops.ob, x, torch.float32))
    x32 = torch.randn(rows, width, generator=gen).to(cuda)
    close(K.bf16_gemm_residual(a4, ops.wp, ops.pb, x32, torch.bfloat16),
          K.bf16_gemm_residual_plain(a4, ops.wp, ops.pb, x32, torch.float32))
    for quick in (True, False):
        h = K._dense_plain(a, ops.wf, ops.fb)
        ref = h * torch.sigmoid(1.702 * h) if quick else K.exact_gelu_plain(h)
        close(K.bf16_gemm_gelu(a, ops.wf, ops.fb, quick), ref)


# --- the wgmma GEMMs (csrc/gemm_wgmma.cuh) at ragged and narrow shapes ------

_INT8_RAGGED = [(m, n, k) for m in (1, 37, 6304) for n in (8, 64, 304, 2304)
                for k in (48, 480, 528, 3072)]
# S3D-G's int8 sites (models/s3dg.py BLOCKS: merged and b3 of mixed_4b, 4c, 4f, 5c at
# 2 clips of 16 frames, the fc on 2 rows).
_S3DG_SITES = [(1568, 304, 480), (1568, 64, 480), (1568, 296, 512), (1568, 448, 528),
               (196, 624, 832), (196, 128, 832), (2, 512, 1024)]


def _int8_gemm_operands(gen, m, n, k, cuda):
    a, w = _int8(gen, m, k, device=cuda), _int8(gen, n, k, device=cuda)
    unit = (torch.rand(n, generator=gen) + 0.5) / (73.0 * 73.0 * k ** 0.5)
    return a, w, unit.to(cuda), (0.1 * torch.randn(n, generator=gen)).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", _INT8_RAGGED)
def test_int8_gemm_ragged_shapes_match_plain(cuda, m, n, k):
    """Every epilogue and dtype pair of fitclip_int8_gemm at ragged M, N and K:
    bias and residual bit-identical to the plain versions (the same roundings),
    the fc epilogues (both GELUs and the five bench modes) under the int8 rule."""
    from fitclip_torch.bench import kernels as P

    gen = torch.Generator().manual_seed(m * 7 + n * 3 + k)
    a, w, unit, bias = _int8_gemm_operands(gen, m, n, k, cuda)
    for out_dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(K.int8_gemm_bias(a, w, unit, bias, out_dtype),
                           K.int8_gemm_bias_plain(a, w, unit, bias, out_dtype))
    for res_dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(m, n, generator=gen).to(cuda, res_dtype)
        for out_dtype in (torch.bfloat16, torch.float32):
            assert torch.equal(K.int8_gemm_residual(a, w, unit, bias, x, out_dtype),
                               K.int8_gemm_residual_plain(a, w, unit, bias, x, out_dtype))
    fs2, fb2 = unit * 20.0, (2.0 * torch.randn(n, generator=gen)).to(cuda)
    for quick in (True, False):
        kv = (-1.702 * K.LOG2E if quick else 0.7071067811865475) / (127.0 / 6.0)
        _assert_int8_close(K.int8_gemm_gelu(a, w, fs2, fb2, kv, quick),
                           K.int8_gemm_gelu_plain(a, w, fs2, fb2, kv, quick))
    for act in ("sigmoid", "bf16", "fold", "fold16", "sigmoid_cast"):
        scale, shift, kv = ((fs2, fb2, -1.702 * K.LOG2E / (127.0 / 6.0)) if act in ("fold", "fold16")
                            else (unit, bias, 1.0 if act == "sigmoid_cast" else 127.0 / 6.0))
        _assert_int8_close(getattr(P, f"int8_gemm_{act}")(a, w, scale, shift, kv),
                           P.int8_gemm_act_plain(a, w, scale, shift, kv, act=act))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", _S3DG_SITES)
def test_int8_gemm_s3dg_site_shapes_match_plain(cuda, m, n, k):
    gen = torch.Generator().manual_seed(n + k)
    a, w, unit, bias = _int8_gemm_operands(gen, m, n, k, cuda)
    assert torch.equal(K.int8_gemm_bias(a, w, unit, bias, torch.bfloat16),
                       K.int8_gemm_bias_plain(a, w, unit, bias, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(m, n, k) for m in (1, 37, 6304) for n in (8, 64, 304, 2304)
                                   for k in (8, 40, 768)])
def test_bf16_gemm_ragged_shapes_match_plain(cuda, m, n, k):
    """Every epilogue of fitclip_bf16_gemm at ragged M, N and K (a multiple of 8)
    under the float rule against the plain version in fp32."""
    gen = torch.Generator().manual_seed(m * 5 + n * 3 + k)
    a = torch.randn(m, k, generator=gen).to(cuda, torch.bfloat16)
    w = (torch.randn(n, k, generator=gen) * k ** -0.5).to(cuda, torch.bfloat16)
    bias = (0.1 * torch.randn(n, generator=gen)).to(cuda)

    def close(out, ref):
        torch.testing.assert_close(out.float(), ref.float(), atol=FLOAT_TOL, rtol=FLOAT_TOL)

    h = K._dense_plain(a, w, bias)
    close(K.bf16_gemm_bias(a, w, bias), h)
    for res_dtype, out_dtype in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        x = torch.randn(m, n, generator=gen).to(cuda, res_dtype)
        out = K.bf16_gemm_residual(a, w, bias, x, out_dtype)
        assert out.dtype == out_dtype
        close(out, K.bf16_gemm_residual_plain(a, w, bias, x, torch.float32))
    close(K.bf16_gemm_gelu(a, w, bias, True), h * torch.sigmoid(1.702 * h))
    close(K.bf16_gemm_gelu(a, w, bias, False), K.exact_gelu_plain(h))


@pytest.mark.cuda
def test_gemm_two_launches_bit_identical(cuda):
    gen = torch.Generator().manual_seed(23)
    a, w, unit, bias = _int8_gemm_operands(gen, 6304, 3072, 768, cuda)
    kv = -1.702 * K.LOG2E / (127.0 / 6.0)
    assert torch.equal(K.int8_gemm_gelu(a, w, unit * 20.0, bias, kv, True),
                       K.int8_gemm_gelu(a, w, unit * 20.0, bias, kv, True))
    a16 = torch.randn(6304, 3072, generator=gen).to(cuda, torch.bfloat16)
    w16 = (torch.randn(768, 3072, generator=gen) / 55.0).to(cuda, torch.bfloat16)
    x32 = torch.randn(6304, 768, generator=gen).to(cuda)
    for fn in (lambda: K.bf16_gemm_bias(a16, w16, bias[:768]),
               lambda: K.bf16_gemm_residual(a16, w16, bias[:768], x32, torch.bfloat16)):
        assert torch.equal(fn(), fn())


@pytest.mark.cuda
def test_gemms_refuse_what_tma_does_not_take(cuda):
    """A pointer off 16 bytes or a K whose rows are not a multiple of 16 bytes
    (or is 0) raises ValueError before any launch."""
    gen = torch.Generator().manual_seed(29)
    a, w, unit, bias = _int8_gemm_operands(gen, 64, 32, 64, cuda)
    shifted = torch.zeros(64 * 64 + 1, dtype=torch.int8, device=cuda)[1:].view(64, 64)
    bad_k = torch.zeros(64, 40, dtype=torch.int8, device=cuda)
    before = K.int8_gemm_bias.launches
    for args in ((shifted, w), (a, shifted[:32]), (bad_k, bad_k[:32]),
                 (a[:, :0].contiguous(), w[:, :0].contiguous())):
        with pytest.raises(ValueError):
            K.int8_gemm_bias(*args, unit, bias, torch.bfloat16)
    assert K.int8_gemm_bias.launches == before
    a16 = torch.zeros(64, 64, dtype=torch.bfloat16, device=cuda)
    shifted16 = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(64, 64)
    for a_, w_ in ((shifted16, a16[:32]), (a16[:, :12].contiguous(), a16[:32, :12].contiguous())):
        with pytest.raises(ValueError):
            K.bf16_gemm_bias(a_, w_, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,causal,seq_valid", [(197, False, None), (77, True, None),
                                                  (197, False, 150), (77, True, 60)])
def test_block_attention_kernel_matches_plain(cuda, seq, causal, seq_valid):
    gen = torch.Generator().manual_seed(8)
    heads = 12
    qkv = (1.5 * torch.randn(2, seq, 3 * heads * 64, generator=gen)).to(cuda, torch.bfloat16)
    before = A.attention_block.launches
    out = A.attention_block(qkv, heads, 0.125, causal, seq_valid)
    assert out.dtype == torch.bfloat16 and A.attention_block.launches == before + 1
    ref = A.attention_core_plain(qkv.float(), heads, 0.125, causal, 1.0, seq_valid)
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("quick_gelu,causal,seq_valid", [(True, False, None), (True, True, None),
                                                         (False, False, None), (False, False, 150)])
def test_fused_bf16_layer_kernels_match_plain(cuda, quick_gelu, causal, seq_valid):
    gen = torch.Generator().manual_seed(9)
    width, heads = 768, 12
    ops = _float_operands(width, gen, cuda)
    x = torch.randn(4, 197, width, generator=gen).to(cuda, torch.bfloat16)
    out = K.fused_bf16_layer(x, ops, heads, causal, quick_gelu, 1e-6, seq_valid)
    ref = K.fused_bf16_layer_plain(x, ops, heads, causal, quick_gelu, 1e-6, seq_valid)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.cuda
def test_fused_bf16_layer_refuses_fp32_on_the_card(cuda):
    gen = torch.Generator().manual_seed(10)
    ops = _float_operands(128, gen, cuda)
    with pytest.raises(TypeError, match="K2"):
        K.fused_bf16_layer(torch.zeros(1, 5, 128, device=cuda), ops, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,width,heads,causal", [(2, 197, 768, 12, False),
                                                         (3, 77, 512, 8, True)])
def test_k8_matches_plain(cuda, batch, seq, width, heads, causal):
    gen = torch.Generator().manual_seed(11)
    x_q = _int8(gen, batch, seq, width, device=cuda)
    w_q = _int8(gen, 3 * width, width, device=cuda)
    scale = ((torch.rand(3 * width, generator=gen) + 0.5) * 1.5 / (73.0 * 73.0 * width ** 0.5)).to(
        cuda)
    bias = (0.1 * torch.randn(3 * width, generator=gen)).to(cuda)
    counts = (A.fused_int8_qkv_attention.launches, K.int8_gemm_bias.launches,
              A.fused_attention_qkv.launches)
    out = A.fused_int8_qkv_attention(x_q, w_q, scale, bias, heads, 0.125, causal)
    assert (A.fused_int8_qkv_attention.launches, K.int8_gemm_bias.launches,
            A.fused_attention_qkv.launches) == (counts[0] + 1, counts[1], counts[2])
    # The plain version in fp32 from the same bf16 qkv (K8 rounds qkv to out_dtype).
    qkv = K.int8_gemm_bias_plain(x_q.view(-1, width), w_q, scale, bias, torch.bfloat16)
    ref = A.attention_core_plain(qkv.float().view(batch, seq, -1), heads, 0.125, causal)
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    torch.testing.assert_close(out, A.fused_int8_qkv_attention_plain(
        x_q, w_q, scale, bias, heads, 0.125, causal), atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.cuda
def test_static_int8_dense_takes_the_int8_gemm_on_the_card(cuda):
    from fitclip_torch.ops import quant

    gen = torch.Generator().manual_seed(12)
    x = (2 * torch.randn(3, 197, 768, generator=gen)).to(cuda, torch.bfloat16)
    w_q = _int8(gen, 3072, 768, device=cuda)
    scale = (torch.rand(3072, generator=gen) / 100).to(cuda)
    bias, act = torch.randn(3072, generator=gen).to(cuda), torch.tensor([6.0], device=cuda)
    before = K.int8_gemm_bias.launches
    out = quant.int8_dense_static(x, w_q, scale, bias, act)
    assert K.int8_gemm_bias.launches == before + 1 and out.dtype == torch.bfloat16
    x_q = quant.quantize_rint(x.float() * (127.0 / 6.0)).view(-1, 768)
    ref = quant.int_matmul(x_q, w_q) * ((act / 127.0) * scale) + bias
    torch.testing.assert_close(out.float(), ref.view(3, 197, 3072), atol=FLOAT_TOL,
                               rtol=FLOAT_TOL)


# --- the repaired faults: fp32 patch embeddings, forward-only FiT attention ---

@pytest.fixture
def cuda_defaults():
    """The card with PyTorch's own TF32 defaults (cuDNN convolutions may use
    TF32, matmuls may not), restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
def test_fp32_encoders_match_the_cpu_with_tf32_at_its_default(cuda_defaults):
    """The fp32 patch embeddings run without TF32 on the card: an fp32 CLIP
    and an fp32 FiT encode_video agree with the same encoder on the CPU."""
    import copy

    from fitclip_torch.convert.from_jax import fit_params_from_jax
    from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_torch.models.clip.model import (CLIPConfig, TextConfig, VisionConfig,
                                                 init_float_params)
    from fitclip_torch.models.frozen_in_time.encoder import (FrozenInTimeConfig,
                                                             FrozenInTimeVideoTextEncoder)
    from fitclip_torch.models.frozen_in_time.load import init_fit_params

    gen = torch.Generator().manual_seed(16)
    clip = ClipVideoTextEncoder(
        CLIPConfig(embed_dim=64, vision=VisionConfig(image_size=64, patch_size=16, width=128,
                                                     layers=2, heads=2),
                   text=TextConfig(context_length=16, vocab_size=64, width=128, layers=1,
                                   heads=2)), num_frames=2)
    init_float_params(clip.model, seed=0)
    fit_cfg = FrozenInTimeConfig.tiny_test()
    fit = FrozenInTimeVideoTextEncoder(fit_cfg, num_frames=fit_cfg.num_frames)
    # Seeded weights: the module's denses are allocated uninitialized.
    fit.load_state_dict(fit_params_from_jax(init_fit_params(fit_cfg, seed=0), fit_cfg))
    for enc, size, frames in ((clip, 64, 2), (fit, fit_cfg.img_size, fit_cfg.num_frames)):
        video = torch.randint(0, 256, (2, frames, size, size, 3), generator=gen,
                              dtype=torch.uint8)
        with torch.no_grad():
            ref = enc.encode_video(video)
            out = copy.deepcopy(enc).to(cuda_defaults).encode_video(video.to(cuda_defaults))
        assert torch.backends.cudnn.allow_tf32  # the global default, restored
        torch.testing.assert_close(out.cpu(), ref, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_fit_attention_kernels_refuse_a_gradient(cuda):
    gen = torch.Generator().manual_seed(17)
    qkv = torch.randn(2, 9, 3 * 2 * 64, generator=gen).to(cuda).requires_grad_()
    gkv = torch.randn(2, 3 * 2 * 64, generator=gen).to(cuda)
    for call in (lambda: A.fused_attention_qkv_gkv(qkv, gkv, 2, 0.125),
                 lambda: A.fused_time_attention(qkv, gkv, 2, 3, 0.125)):
        with pytest.raises(RuntimeError, match="forward only"):
            call()
        with torch.no_grad():
            assert call().shape == (2, 9, 128)


# --- the ablation bench arms (fitclip_torch/bench): kernel modes and arms -----

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["one", "fold", "cast"])
def test_ln_quant_bench_modes_match_plain(cuda, mode):
    from fitclip_torch.bench import kernels as P

    gen = torch.Generator().manual_seed(18)
    rows, width = 6304, 768
    gamma = (1 + 0.1 * torch.randn(width, generator=gen)).to(cuda)
    beta = (0.1 * torch.randn(width, generator=gen)).to(cuda)
    wrapper = getattr(P, f"ln_quant_{mode}")
    for x in (torch.randn(rows, width, generator=gen).to(cuda, torch.bfloat16),
              (3 * torch.randn(rows, width, generator=gen)).to(cuda)):
        before = wrapper.launches
        out = wrapper(x, gamma, beta, 127.0 / 4.0)
        assert wrapper.launches == before + 1
        _assert_int8_close(out, P.ln_quant_variant_plain(x, gamma, beta, 127.0 / 4.0, 1e-5,
                                                         mode))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["sigmoid", "bf16", "fold", "fold16", "sigmoid_cast"])
def test_int8_gemm_bench_epilogues_match_plain(cuda, act):
    from fitclip_torch.bench import kernels as P

    gen = torch.Generator().manual_seed(19)
    rows, width = 6304, 768
    a, w = _int8(gen, rows, width, device=cuda), _int8(gen, 4 * width, width, device=cuda)
    if act in ("fold", "fold16"):  # folded: t = acc * fs2 + fb2, kv the exp2 multiplier
        scale = ((torch.rand(4 * width, generator=gen) + 0.5) * 20.0 / (73.0 * 73.0 * width ** 0.5))
        bias, kv = 2.0 * torch.randn(4 * width, generator=gen), -1.702 * K.LOG2E / (127.0 / 6.0)
    else:  # unfolded: h = acc * fs + fb, kv = inv_p
        scale = (torch.rand(4 * width, generator=gen) + 0.5) / (73.0 * 73.0 * width ** 0.5)
        bias, kv = 0.1 * torch.randn(4 * width, generator=gen), 127.0 / 6.0
    if act == "sigmoid_cast":
        kv = 1.0
    scale, bias = scale.to(cuda), bias.to(cuda)
    wrapper = getattr(P, f"int8_gemm_{act}")
    before = wrapper.launches
    out = wrapper(a, w, scale, bias, kv)
    assert wrapper.launches == before + 1
    _assert_int8_close(out, P.int8_gemm_act_plain(a, w, scale, bias, kv, act=act))


_BENCH_MODES = ["div", "fold2", "sm2", "sm2div", "nomax", "cast", "head0", "bf16logits",
                "nosoftmax"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,seq,causal,seq_valid", [
    *((m, 197, False, None) for m in _BENCH_MODES),
    # the masked keys and the sweep; nosoftmax's plain weights are the masked logits
    *((m, 77, True, 60) for m in _BENCH_MODES if m != "nosoftmax"),
    *((m, 577, False, 300) for m in _BENCH_MODES if m != "nosoftmax"),
    ("nosoftmax", 577, False, None)])
def test_attention_bench_modes_match_plain(cuda, mode, seq, causal, seq_valid):
    from fitclip_torch.bench import kernels as P

    gen = torch.Generator().manual_seed(20)
    heads, batch = 12, 4
    qkv = (1.5 * torch.randn(batch, seq, 3 * heads * 64, generator=gen)).to(cuda, torch.bfloat16)
    out_mul = 127.0 / 8.0 if mode == "cast" else 127.0 / 2.5
    scale = 0.125
    if mode in ("sm2", "sm2div"):  # q arrives pre-scaled by D^-1/2 log2e
        qkv[..., :heads * 64] *= 0.125 * K.LOG2E
    if mode == "cast":  # att truncated to int8 without inv: keep it in range
        qkv[..., 2 * heads * 64:] *= 40.0
    wrapper = getattr(P, f"attention_{mode}")
    before = wrapper.launches
    out = wrapper(qkv, heads, scale, causal, out_mul, seq_valid)
    assert wrapper.launches == before + 1
    ref = P.attention_variant_plain(qkv, heads, scale, causal, out_mul, seq_valid, mode)
    if out.dtype == torch.int8:
        _assert_int8_close(out, ref)
    else:  # the plain version's casts (weights to bf16) on the same inputs
        torch.testing.assert_close(out.float(), ref.float(), atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.cuda
def test_slice_requant_and_amax_match_plain(cuda):
    from fitclip_torch.bench import kernels as P

    gen = torch.Generator().manual_seed(21)
    for dtype in (torch.bfloat16, torch.float32):
        qkv = (2 * torch.randn(3, 785, 3 * 768, generator=gen)).to(cuda, dtype)
        out = P.slice_requant(qkv, 127.0 / 4.0)
        assert torch.equal(out, P.slice_requant_plain(qkv, 127.0 / 4.0))
        cls = P.slice_requant(qkv, 127.0 / 4.0, torch.zeros_like(out), rows=1)
        assert torch.equal(cls[:, :1], out[:, :1]) and not cls[:, 1:].any()
    qkv = (0.7 * torch.randn(5, 197, 3 * 768, generator=gen)).to(cuda, torch.bfloat16)
    for block in (1, 2):
        assert torch.equal(P.attn_amax(qkv, block), P.attn_amax_plain(qkv, block))


# The LayerNorm kernel (csrc/ln_quant.cu, ln_rows_kernel) in every mode: K1's
# ln_quant, K2's ln_cast and S1's one, fold and cast, on the encode's rows
# (32 clips x 4 frames x 197), every width class of the kernel (384: 2 vectors
# a lane on half the lanes, 1024: 4 on all) and row counts that are no
# multiple of a CTA's four rows.
LN_SHAPES = [(25216, 768), (6304, 384), (6301, 1024), (4099, 384), (37, 1024), (618, 512)]
LN_MODES = ["two", "one", "fold", "cast", "ln_cast"]


def _ln_modes(mode):
    """(kernel wrapper, plain version) of a LayerNorm mode, both (x, gamma, beta, inv)."""
    from fitclip_torch.bench import kernels as P

    if mode == "ln_cast":
        return (lambda x, g, b, inv: K.ln_cast(x, g, b, torch.bfloat16),
                lambda x, g, b, inv: K.layer_norm_plain(x, g, b))
    if mode == "two":
        return K.ln_quant, K.ln_quant_plain
    return (getattr(P, f"ln_quant_{mode}"),
            lambda x, g, b, inv: P.ln_quant_variant_plain(x, g, b, inv, K.LN_EPS, mode))


def _assert_ln_close(mode, out, ref):
    if mode == "ln_cast":
        assert out.dtype == torch.bfloat16
        torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    else:
        _assert_int8_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", LN_MODES)
@pytest.mark.parametrize("rows,width", LN_SHAPES)
def test_ln_kernel_modes_match_plain(cuda, rows, width, mode):
    gen = torch.Generator().manual_seed(23)
    gamma = (1 + 0.1 * torch.randn(width, generator=gen)).to(cuda)
    beta = (0.1 * torch.randn(width, generator=gen)).to(cuda)
    kernel, plain = _ln_modes(mode)
    counter = K.ln_cast if mode == "ln_cast" else kernel
    for x in (torch.randn(rows, width, generator=gen).to(cuda, torch.bfloat16),
              (3 * torch.randn(rows, width, generator=gen) + 1).to(cuda)):
        before = counter.launches
        out = kernel(x, gamma, beta, 127.0 / 4.0)
        assert counter.launches == before + 1 and out.shape == x.shape
        _assert_ln_close(mode, out, plain(x, gamma, beta, 127.0 / 4.0))


def _ln_edge_rows(width, dtype, gen):
    """4096 ordinary rows and, among them, a constant row (var = 0), a row on a
    common offset of 1e3 and two rows whose outputs fall on the .5 boundaries
    of the quantization (gamma 1, beta 0, inv = sqrt(var + eps) of those rows:
    LN(x) * inv is k + 0.5 up to rounding); returns x and inv."""
    x = torch.randn(4096, width, generator=gen)
    half = torch.arange(width // 2) % 20 + 0.5
    ties = torch.cat([half, -half])
    x[100] = 0.75
    x[700] = 1e3 + torch.randn(width, generator=gen)
    x[1200] = ties[torch.randperm(width, generator=gen)]
    x[3000] = ties[torch.randperm(width, generator=gen)]
    inv = float((ties.double() ** 2).mean().add(1e-5).sqrt())
    return x.to(dtype), inv


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["two", "fold", "cast", "ln_cast"])
def test_ln_kernel_two_pass_modes_on_edge_rows(cuda, mode, dtype):
    """The constant row gives beta (0) exactly; the offset row and the tie rows
    stay within the int8 and float rules."""
    gen = torch.Generator().manual_seed(24)
    x, inv = _ln_edge_rows(768, dtype, gen)
    x = x.to(cuda)
    gamma, beta = torch.ones(768, device=cuda), torch.zeros(768, device=cuda)
    kernel, plain = _ln_modes(mode)
    out = kernel(x, gamma, beta, inv)
    assert not out[100].any()
    _assert_ln_close(mode, out, plain(x, gamma, beta, inv))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", LN_MODES)
def test_ln_kernel_two_launches_bit_identical(cuda, mode):
    gen = torch.Generator().manual_seed(25)
    kernel, _ = _ln_modes(mode)
    gamma = (1 + 0.1 * torch.randn(768, generator=gen)).to(cuda)
    beta = (0.1 * torch.randn(768, generator=gen)).to(cuda)
    for x in (torch.randn(25216, 768, generator=gen).to(cuda, torch.bfloat16),
              (3 * torch.randn(6304, 768, generator=gen)).to(cuda)):
        assert torch.equal(kernel(x, gamma, beta, 127.0 / 4.0), kernel(x, gamma, beta, 127.0 / 4.0))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [0, 100, 1032])
def test_ln_kernel_refuses_widths_it_does_not_take(cuda, width):
    x = torch.zeros(4, width, device=cuda, dtype=torch.bfloat16)
    ones = torch.ones(width, device=cuda)
    for call in (lambda: K.ln_quant(x, ones, ones, 1.0),
                 lambda: K.ln_cast(x, ones, ones, torch.bfloat16)):
        with pytest.raises(ValueError, match="multiples of 8"):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 2, 3])
def test_amax_pass_matches_plain_on_edge_values(cuda, block):
    """7 frames (no multiple of 2 or 3) of 197 x 3 x 768 bf16: a single large
    value at the last element (v's), an all-zero q in frame 4 (the 1e-6
    floor where frame 4 is a block alone), then a NaN in frame 3's k, which
    its block's k scale carries (torch.equal is false on NaN: compared with
    torch.isnan). One launch a call."""
    from fitclip_torch.bench import kernels as P

    gen = torch.Generator().manual_seed(26)
    qkv = 0.7 * torch.randn(7, 197, 3 * 768, generator=gen)
    qkv[-1, -1, -1] = 40.0
    qkv[4, :, :768] = 0.0
    qkv = qkv.to(cuda, torch.bfloat16)
    before = P.attn_amax.launches
    out = P.attn_amax(qkv, block)
    assert P.attn_amax.launches == before + 1
    assert torch.equal(out, P.attn_amax_plain(qkv, block)) and float(out[-1, 2]) == 40.0
    if block == 1:
        assert float(out[4, 0]) == float(torch.tensor(1e-6))
    qkv[3, 5, 768 + 7] = float("nan")
    out, ref = P.attn_amax(qkv, block), P.attn_amax_plain(qkv, block)
    nan = torch.isnan(ref)
    assert int(nan.sum()) == 1 and bool(nan[3 // block, 1])
    assert torch.equal(torch.isnan(out), nan) and torch.equal(out[~nan], ref[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("av8,block", [(False, 1), (True, 1), (True, 2)])
def test_s8_attention_matches_plain(cuda, av8, block):
    from fitclip_torch.bench import kernels as P

    gen = torch.Generator().manual_seed(22)
    heads = 12
    qkv = (0.7 * torch.randn(6, 197, 3 * heads * 64, generator=gen)).to(cuda, torch.bfloat16)
    wrapper = P.attention_i8qkav if av8 else P.attention_i8qk
    before = wrapper.launches
    out = wrapper(qkv, P.attn_amax(qkv, block), heads, 0.125, block)
    assert wrapper.launches == before + 1 and out.dtype == torch.bfloat16
    ref = P.attention_s8_plain(qkv, heads, 0.125, block, av8).float()
    if av8:
        _assert_s8_close(out, ref, P.attn_amax_plain(qkv, block)[:, 2].max())
    else:
        torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)


# The longest L the s8 kernel replaced (bench_arms.cu:attention_s8_kernel, a
# shared row buffer of 64 rows of fp32 logits) fitted in a block: 488 keys for
# i8qk, 480 for i8qkav. The register-resident kernel takes at least those.
S8_LONGEST_OLD = {False: 488, True: 480}


@pytest.mark.cuda
@pytest.mark.parametrize("av8", [False, True])
@pytest.mark.parametrize("seq", [17, 197, 257, "longest"])
@pytest.mark.parametrize("block", [1, 2])
def test_s8_attention_lengths_match_plain(cuda, av8, seq, block):
    """Both s8 arms from one 16-key tile (17) through the register-resident
    tier (197) to the sweep (257 and the longest length the old kernel took),
    per block of 1 and 2 frames, 3 frames (no multiple of 2), 4 heads."""
    from fitclip_torch.bench import kernels as P

    seq = S8_LONGEST_OLD[av8] if seq == "longest" else seq
    gen = torch.Generator().manual_seed(27)
    heads = 4
    qkv = (0.7 * torch.randn(3, seq, 3 * heads * 64, generator=gen)).to(cuda, torch.bfloat16)
    wrapper = P.attention_i8qkav if av8 else P.attention_i8qk
    out = wrapper(qkv, P.attn_amax(qkv, block), heads, 0.125, block)
    ref = P.attention_s8_plain(qkv, heads, 0.125, block, av8).float()
    if av8:
        _assert_s8_close(out, ref, P.attn_amax_plain(qkv, block)[:, 2].max())
    else:
        torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width,row0,rows", [(768, 0, None), (768, 5, 1), (768, 100, 37),
                                             (101, 0, None), (101, 3, 20), (12, 1, 2)])
def test_slice_requant_rows_equal_plain(cuda, dtype, width, row0, rows):
    """slice_requant_rows_kernel: every row of a subset equal to the plain
    version (the same fp32 product, rounded half to even), the rows outside
    it untouched; widths that are no multiple of 8 (some rows then start off
    16 bytes and take the scalar loop, all take a scalar tail)."""
    from fitclip_torch.bench import kernels as P

    gen = torch.Generator().manual_seed(28)
    qkv = (3 * torch.randn(3, 157, 3 * width, generator=gen)).to(cuda, dtype)
    rows = 157 - row0 if rows is None else rows
    before = P.slice_requant.launches
    out = P.slice_requant(qkv, 127.0 / 4.0, torch.full((3, 157, width), 7, dtype=torch.int8,
                                                       device=cuda), row0, rows)
    assert P.slice_requant.launches == before + 1
    sub = slice(row0, row0 + rows)
    assert torch.equal(out[:, sub], P.slice_requant_plain(qkv[:, sub], 127.0 / 4.0))
    assert bool((out[:, :row0] == 7).all()) and bool((out[:, row0 + rows:] == 7).all())


def _assert_s8_close(kernel_out, plain_out, v_amax):
    """The float rule, with i8qkav's int8 weights under the int8 rule: a weight
    rint(w * 127) may round the other way (the softmax sums in another order),
    which moves an output by up to one step v_amax / 127, on at most
    INT8_MAX_FLIPPED of the elements."""
    diff = (kernel_out.float() - plain_out).abs()
    over = diff > FLOAT_TOL + FLOAT_TOL * plain_out.abs()
    assert float(over.float().mean()) <= INT8_MAX_FLIPPED
    assert float(diff.max()) <= FLOAT_TOL + float(v_amax) / 127.0


def _nosoftmax_fp64(qkv, heads, scale):
    """nosoftmax with its logits summed in fp64 (then rounded to bf16 as the
    weights), and P.V in fp64: the mode's function without fp32's sums."""
    batch, seq, triple = qkv.shape
    w = triple // 3

    def split(t):
        return t.reshape(batch, seq, heads, w // heads).transpose(1, 2).double()

    q = split(qkv[..., :w] * torch.tensor(scale, dtype=qkv.dtype, device=qkv.device))
    logits = q @ split(qkv[..., w:2 * w]).transpose(-1, -2)
    out = logits.to(torch.bfloat16).double() @ split(qkv[..., 2 * w:])
    return out.transpose(1, 2).reshape(batch, seq, w).to(qkv.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [197, 577])
def test_nosoftmax_is_no_further_from_fp64_logits_than_plain(cuda, seq):
    """nosoftmax's weights are bf16(logits), so a logit summed within fp32's
    error of a bf16 rounding boundary moves its row's outputs by a whole bf16
    step of the logit. The kernel refines such logits in the fp32 bodies'
    order: against logits summed in fp64 it misses the float rule on no more
    outputs than the plain version (fp32 logits) does, on the inputs of
    test_attention_bench_modes_match_plain."""
    from fitclip_torch.bench import kernels as P

    gen = torch.Generator().manual_seed(20)
    heads, batch = 12, 4
    qkv = (1.5 * torch.randn(batch, seq, 3 * heads * 64, generator=gen)).to(cuda, torch.bfloat16)
    exact = _nosoftmax_fp64(qkv, heads, 0.125).float()

    def misses(out):
        diff = (out.float() - exact).abs()
        return int((diff > FLOAT_TOL + FLOAT_TOL * exact.abs()).sum())

    kernel = misses(P.attention_nosoftmax(qkv, heads, 0.125, False, 1.0))
    plain = misses(P.attention_variant_plain(qkv, heads, 0.125, False, 1.0, None, "nosoftmax"))
    print(f"nosoftmax L={seq}: outputs past the float rule against fp64 logits: "
          f"kernel {kernel}, plain {plain} of {qkv.numel() // 3}")
    assert kernel <= plain


def _attention_fp64(qkv, heads, scale):
    """The qkv-mode attention of qkv's values in float64: no rounding between steps."""
    batch, seq, triple = qkv.shape
    width = triple // 3
    x = qkv.double().reshape(batch, seq, 3, heads, width // heads).permute(2, 0, 3, 1, 4)
    weights = torch.softmax((x[0] * scale) @ x[1].transpose(-1, -2), -1)
    return (weights @ x[2]).transpose(1, 2).reshape(batch, seq, width)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,head_dim", [(6, 32), (12, 64)])
def test_bf16_attention_is_no_further_from_fp64_than_plain(cuda, heads, head_dim):
    """The bf16 forward (qkv mode) against the function in float64 on the same
    bf16 inputs, over 20 seeds at 32 x 197: it puts no more outputs past the
    float rule than the plain version with the same casts does. At head_dim 32
    both miss it on a few outputs (the bf16 casts' own error, magnified by the
    scale 32^-1/2), so a check of that shape against the fp32 plain version
    depends on its inputs; ``-s`` prints the counts."""
    scale = head_dim ** -0.5
    kernel = plain = 0
    for seed in range(20):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        qkv = (1.5 * torch.randn(32, 197, 3 * heads * head_dim, generator=gen, device=cuda)).to(
            torch.bfloat16)
        exact = _attention_fp64(qkv, heads, scale)
        rule = FLOAT_TOL + FLOAT_TOL * exact.abs()
        misses = [int(((out.double() - exact).abs() > rule).sum())
                  for out in (A.fused_attention_qkv(qkv, heads, scale),
                              A.attention_core_plain(qkv, heads, scale, False))]
        kernel, plain = kernel + misses[0], plain + misses[1]
    print(f"head_dim {head_dim}: outputs past the float rule against fp64, 20 seeds x "
          f"{32 * 197 * heads * head_dim}: kernel {kernel}, plain with the same casts {plain}")
    assert kernel <= plain


@pytest.mark.cuda
def test_block_layer_arms_match_their_plain_twins(cuda):
    from fitclip_torch.bench import block_layer as S1

    gen = torch.Generator().manual_seed(23)
    layer = S1.layer_block(S1.make_layer_params(np.random.default_rng(0)), S1.HEADS, cuda)
    x = torch.randn(4, 197, 768, generator=gen).to(cuda, torch.bfloat16)
    with torch.no_grad():
        full = S1.run_arm(x, S1.arm_operands(layer, "full"), "full")
        outs = {}
        for mode in S1.ARMS:
            ops = S1.arm_operands(layer, mode)
            outs[mode] = (S1.run_arm(x.clone(), ops, mode), S1.run_arm(x, ops, mode, plain=True))
        skew = S1.SkewSchedule(chunks=2)(x, S1.arm_operands(layer, "full"))
    missed = [f"{mode}: max |diff| {float((out.float() - ref.float()).abs().max()):.4f}"
              for mode, (out, ref) in outs.items()
              if not torch.allclose(out.float(), ref.float(), atol=FLOAT_TOL, rtol=FLOAT_TOL)]
    assert not missed, "; ".join(missed)
    assert torch.equal(skew, full)


def _block_rule_misses(out, ref, x):
    """Why a whole int8 FiT block ``out`` on input x misses its plain twin
    ``ref``, or None. An int8 activation that rounds the other way carries
    whole steps through the later GEMMs, so at most LAYER_MAX_OVER of the
    outputs may be past the float rule; each row's update (output - x, which x
    would dominate) keeps a cosine above 0.999."""
    out, ref, x = out.float(), ref.float(), x.float()
    cos = float(torch.nn.functional.cosine_similarity((out - x).flatten(0, -2),
                                                      (ref - x).flatten(0, -2), dim=-1).min())
    over = float(((out - ref).abs() > FLOAT_TOL + FLOAT_TOL * ref.abs()).float().mean())
    if bool(torch.isfinite(out).all()) and cos > 0.999 and over <= LAYER_MAX_OVER:
        return None
    return f"min row cosine of the update {cos:.6f}, {over:.2e} past the float rule"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "i8qk", "i8qkav", "bf16logits", "nosoftmax",
                                  "nopack"])
def test_attn_int8_arms_match_their_plain_twins(cuda, mode):
    from fitclip_torch.bench import attn_int8 as S2

    from fitclip_torch.bench import kernels as P

    qkv = S2.make_qkv(8, cuda)
    with torch.no_grad():
        out = S2.run_arm(qkv, mode)
        ref = S2.run_arm(qkv, mode, plain=True).float()
    if mode == "i8qkav":
        _assert_s8_close(out, ref, P.attn_amax_plain(qkv, 1)[:, 2].max())
    else:
        torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)


@pytest.mark.cuda
def test_fit_block_arms_match_their_plain_twins(cuda):
    from fitclip_torch.bench import fit_block as S3

    gen = torch.Generator().manual_seed(24)
    ops = _fit_operands(768, gen, cuda)
    x = torch.randn(2, 1 + 4 * 196, 768, generator=gen).to(cuda, torch.bfloat16)
    with torch.no_grad():
        outs = {mode: (S3.run_arm(x, ops, mode, 12, 4), S3.run_arm(x, ops, mode, 12, 4, plain=True))
                for mode in S3.ARMS}
    missed = {mode: _block_rule_misses(out, ref, x) for mode, (out, ref) in outs.items()}
    assert not any(missed.values()), missed
    # A planted wrong arm: `nocls` (only the CLS row differs) held as `full`.
    assert _block_rule_misses(outs["nocls"][0], outs["full"][1], x) is not None


def _small_int8_clip(cuda):
    """A seeded int8 CLIP small enough to capture fast (width 128, head_dim 64,
    2 + 2 layers), calibrated on the card."""
    from fitclip_torch.convert.from_jax import params_from_jax, params_to_jax
    from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_torch.models.clip.model import (CLIPConfig, CLIPModel, TextConfig, VisionConfig,
                                                 init_float_params)
    from fitclip_torch.ops.quant import quantize_clip_params

    config = CLIPConfig(embed_dim=64,
                        vision=VisionConfig(image_size=64, patch_size=16, width=128, layers=2,
                                            heads=2),
                        text=TextConfig(context_length=16, vocab_size=512, width=128, layers=2,
                                        heads=2))
    state = init_float_params(CLIPModel(config), 3).state_dict()
    enc = ClipVideoTextEncoder(config, num_frames=2, dtype=torch.bfloat16, quantized=True,
                               fused_attention=True, device="cpu")
    enc.model.load_state_dict(params_from_jax(quantize_clip_params(params_to_jax(state, config)),
                                              config))
    enc = enc.to(cuda)
    gen = torch.Generator().manual_seed(5)
    video = torch.randint(0, 256, (4, 2, 64, 64, 3), generator=gen, dtype=torch.uint8)
    enc.calibrate(video.to(cuda), torch.randint(1, 511, (4, 16), generator=gen).to(cuda))
    return enc, video, torch.randint(1, 511, (8, 16), generator=gen)


@pytest.mark.cuda
def test_bucket_graphs_replay_k1_and_the_batcher_keeps_each_row(cuda):
    """Each bucket's graph records K1's seven launches a layer (the wrappers'
    counts move at capture, not at replay); a replay equals the eager kernel
    path; 48 concurrent requests through the batcher over the graphs each get
    their own row, although every replay overwrites its bucket's output."""
    import threading

    from fitclip_torch.serving.batcher import BatchServer
    from fitclip_torch.serving.graphs import BucketGraphs

    wrappers = (K.ln_quant, K.int8_gemm_bias, K.int8_gemm_residual, K.int8_gemm_gelu,
                A.attention_int8)
    enc, video, ids = _small_int8_clip(cuda)
    with torch.no_grad():
        towers = {"text": (lambda t: enc.encode_text(t).float(), ids, (16,), torch.int64),
                  "video": (lambda v: enc.encode_video(v).float(), video, (2, 64, 64, 3),
                            torch.uint8)}
        for name, (fn, inputs, item_shape, dtype) in towers.items():
            graphs = BucketGraphs(fn, item_shape, dtype, (1, 2, 4), cuda, name=name).warm()
            before = [w.launches for w in wrappers]
            graphs.capture()
            captured = [w.launches - b for w, b in zip(wrappers, before)]
            assert captured == [3 * 2 * n for n in (2, 1, 2, 1, 1)], (name, captured)
            eager = fn(inputs[:4].to(cuda))
            counts = [w.launches for w in wrappers]
            replayed = graphs(inputs[:4].to(cuda)).clone()
            assert [w.launches for w in wrappers] == counts  # a replay calls no wrapper
            torch.testing.assert_close(replayed, eager, rtol=0, atol=0)

            server = BatchServer(graphs, item_shape, inputs.numpy().dtype, bucket_sizes=(1, 2, 4),
                                 max_wait_ms=1, device=cuda).start()
            rows = [i % inputs.shape[0] for i in range(48)]
            results = [None] * len(rows)

            def client(i):
                results[i] = server.submit(inputs[rows[i]].numpy()).result(timeout=60)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(len(rows))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            server.stop()
            single = torch.cat([fn(inputs[i:i + 1].to(cuda)) for i in range(inputs.shape[0])])
            got = torch.from_numpy(np.stack(results))
            want = single.cpu()[rows]
            cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
            assert float(cos.min()) > 0.9999, (name, float(cos.min()))
            assert server.stats.batches < len(rows) and server.stats.requests == len(rows)
