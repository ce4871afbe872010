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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("seq", [9, 50, 77, 197, 257, 577])
def test_attention_body_choice(dtype, seq, head_dim):
    """The wrapper's body is a function of (dtype, L, head_dim): bf16 goes to a
    tensor-core body, register-resident up to 208 keys and swept past it; fp32
    stays on the CUDA-core body it took before."""
    body = A.attention_body(dtype, seq, head_dim)
    before = _taken_before(dtype, seq, head_dim)
    assert before is not None
    if dtype == torch.bfloat16:
        assert body == ("mma" if seq <= A.MMA_RESIDENT_KEYS else "mma_sweep")
    else:
        assert body == before


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
    tensor-core body, never on an fp32 one; fp32 keeps its body and its limit."""
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
                assert body == before, (seq, head_dim)


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
        # fp32 K^T and V^T of L = 577 exceed a block's shared memory: the
        # global body keeps one operand there and reads the other through L2.
        assert body == "f32_global"
        assert A.backward_smem_bytes(seq, head_dim, "f32") > A.SMEM_LIMIT
        assert A.backward_smem_bytes(seq, head_dim, "f32_global") <= A.SMEM_LIMIT
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
@pytest.mark.parametrize("shape", [(2, 4, 32, 32, 3), (1, 6, 36, 44, 3), (1, 2, 224, 224, 3)])
def test_stem_kernel_matches_plain(cuda, shape):
    """Within one bf16 ulp of the plain fp32 result on all but 1e-3 of the outputs,
    and the same bits on a second launch."""
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
