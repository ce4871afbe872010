"""The Hopper kernels of fitclip_torch against their plain PyTorch versions.

The tests marked ``cuda`` need a CUDA card and nvcc; they skip elsewhere. This
file imports torch only (no JAX), so it also runs on a GPU machine without
JAX: ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py``.
The other tests check the dispatch rule on the CPU: a CPU tensor takes the
plain version and launches nothing, and a failed build raises.
"""

import pytest
import torch

from fitclip_torch import _build
from fitclip_torch.ops import attention as A
from fitclip_torch.ops import block as K
from fitclip_torch.ops import fit_block as FB
from fitclip_torch.ops import s3dg_stem as S

INT8_MAX_FLIPPED = 1e-3  # share of int8 elements allowed one step off
FLOAT_TOL = 2e-2          # bf16 output against the plain version in fp32


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
@pytest.mark.parametrize("seq,causal,seq_valid", [
    (197, False, None), (197, True, None), (197, False, 150),
    (577, False, None)])  # ViT-L/14@336: K and V need 148 KB of shared memory
def test_attention_kernel_matches_plain(cuda, seq, causal, seq_valid):
    gen = torch.Generator().manual_seed(3)
    heads, head_dim = 12, 64
    qkv = (1.5 * torch.randn(2, seq, 3 * heads * head_dim, generator=gen)).to(
        cuda, torch.bfloat16)
    scale, out_mul = head_dim ** -0.5, 127.0 / 2.5
    _assert_int8_close(A.attention_int8(qkv, heads, scale, causal, out_mul, seq_valid),
                       A.attention_int8_plain(qkv, heads, scale, causal, out_mul, seq_valid))
    out = A.fused_attention_qkv(qkv, heads, scale, causal)
    ref = A.attention_core_plain(qkv.float(), heads, scale, causal)
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)


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
@pytest.mark.parametrize("batch,seq,heads,causal", [
    (4, 197, 12, False), (4, 77, 8, True), (3, 50, 12, False), (2, 257, 16, True),
    (1, 577, 16, False)])  # every CLIP preset's L
def test_attention_backward_kernel_matches_plain(cuda, dtype, batch, seq, heads, causal):
    gen = torch.Generator().manual_seed(5)
    width, scale = heads * 64, 64 ** -0.5
    qkv = (1.5 * torch.randn(batch, seq, 3 * width, generator=gen)).to(cuda, dtype)
    grad = torch.randn(batch, seq, width, generator=gen).to(cuda, dtype)
    if dtype == torch.float32 and seq == 577:
        # fp32 K^T and V^T of L = 577 exceed a block's shared memory (the
        # forward kernel refuses the same shape).
        with pytest.raises(ValueError, match="shared memory"):
            A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal)
        return
    before = A.fused_attention_qkv_backward.launches
    out = A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal)
    ref = A.attention_backward_plain(qkv.float(), grad.float(), heads, scale, causal)
    assert out.dtype == dtype and out.shape == qkv.shape
    torch.testing.assert_close(out.float(), ref, atol=FLOAT_TOL, rtol=FLOAT_TOL)
    # No atomics: two launches give the same bits.
    assert torch.equal(out, A.fused_attention_qkv_backward(qkv, grad, heads, scale, causal))
    assert A.fused_attention_qkv_backward.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_attention_function_gradient_through_both_kernels(cuda, causal):
    gen = torch.Generator().manual_seed(6)
    qkv = (1.5 * torch.randn(2, 77, 3 * 512, generator=gen)).to(cuda).requires_grad_()
    grad = torch.randn(2, 77, 512, generator=gen).to(cuda)
    counts = (A.fused_attention_qkv.launches, A.fused_attention_qkv_backward.launches)
    A.fused_attention_qkv(qkv, 8, 0.125, causal).backward(grad)
    assert (A.fused_attention_qkv.launches, A.fused_attention_qkv_backward.launches) == (
        counts[0] + 1, counts[1] + 1)
    ref = A.attention_backward_plain(qkv.detach(), grad, 8, 0.125, causal)
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
@pytest.mark.parametrize("groups,seq,heads", [(8, 196, 12), (6, 9, 2), (3, 49, 4)])
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
@pytest.mark.parametrize("frames,patches,heads", [(4, 196, 12), (2, 5, 2), (1, 9, 4)])
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
