"""The transformer layers for inference: int8 W8A8 (port of
``fitclip_tpu/ops/block.py:fused_int8_layer``, K1) and its float twin (port of
``fused_bf16_layer``, K2).

The TPU kernel ``_layer_kernel`` (K1) runs a whole pre-LN residual block in
one call, with the layer's weights resident in 100 MB of VMEM. An H100 SM has
227 KB of shared memory, so on Hopper the layer is a fixed set of three
kernels, launched seven times per layer:

1. ``ln_quant`` (``csrc/ln_quant.cu``): fp32 LayerNorm, then static quantize
   to int8. Bound by memory: one read of the row, one int8 write.
2. ``int8_gemm_*`` (``csrc/int8_gemm.cu``): int8 x int8 -> int32 on the
   tensor cores (wgmma fed by TMA, ``csrc/gemm_wgmma.cuh``), with the dequant/bias epilogue (QKV), the residual
   epilogue (out-projection into the fp32 residual, final projection back to
   x's dtype) or the folded fc epilogue (dequant and requant as one affine,
   QuickGELU or exact GELU, int8). Bound by compute at M = B * L >= 6k rows.
3. ``attention_int8`` (``ops/attention.py``): per-head softmax attention with
   the requant multiplier in the normalizer, int8 output.

The mid-layer residual stays fp32 from the out-projection to the final add
and is rounded to x's dtype once, as in the TPU kernel. Divides are exact:
the CPU interpret reference of the TPU kernel divides exactly too.

The float layer (``fused_bf16_layer``) replaces ``_bf16_layer_kernel`` with
the same seven launches per layer, in bf16 on the card:

1. ``ln_cast`` (``csrc/ln_quant.cu``): fp32 LayerNorm rounded to x's dtype.
2. ``bf16_gemm_*`` (``csrc/bf16_gemm.cu``): bf16 x bf16 -> fp32 on the tensor
   cores (the same wgmma mainloop), bias added after the accumulate, with the bias epilogue
   (QKV, bf16), the residual epilogue (out-projection into the fp32 residual,
   MLP projection back to x's dtype) or the GELU epilogue (QuickGELU or the
   exact GELU of ``block.py:_exact_gelu``, bf16).
3. ``attention_block`` (``ops/attention.py``): the per-head core with weights
   exps * (1 / denom), output in qkv's dtype.

Each wrapper calls its operator (``fitclip::ln_quant``, ... ;
``_build.define_op``): for a CUDA tensor the kernel's launch, which raises
rather than fall back, for a CPU tensor the plain PyTorch version, and for a
fake tensor shapes only, so that an exported tower holds the operators.
``fused_int8_layer_plain`` runs the same composition through the plain
versions on any device.
"""

import dataclasses
from typing import NamedTuple, Optional

import torch

from fitclip_torch import _build
from fitclip_torch.ops.attention import (attention_block, attention_block_plain,
                                         attention_int8, attention_int8_plain)
from fitclip_torch.ops.quant import QUANT_EPS, int_matmul, quantize_rint

LN_EPS = 1e-5
LOG2E = 1.4426950408889634

_BIAS, _RESIDUAL, _GELU = 0, 1, 2  # csrc/int8_gemm.cu epilogues


# --- ln_quant -------------------------------------------------------------

def layer_norm_plain(x, weight, bias, eps: float = LN_EPS) -> torch.Tensor:
    """fp32 LayerNorm statistics and arithmetic (block.py:_ln), fp32 output."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    return centered * torch.rsqrt(var + eps) * weight + bias


def ln_quant_plain(x, weight, bias, inv: float, eps: float = LN_EPS):
    return quantize_rint(layer_norm_plain(x, weight, bias, eps) * inv)


def ln_quant(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, inv: float,
             eps: float = LN_EPS) -> torch.Tensor:
    """(rows, W) bf16/fp32 -> int8 (rows, W): clip(rint(LN(x) * inv)).
    Replaces the _ln + _quant prologues of block.py:_layer_kernel."""
    return _LN_QUANT(x, weight, bias, float(inv), float(eps))


def _ln_quant_cuda(x, weight, bias, inv, eps):
    out = ln_quant_launch(x, weight, bias, inv, eps, 0)
    ln_quant.launches += 1
    return out


# The widths csrc/ln_quant.cu takes: multiples of 8 (whole 16-byte vectors of
# a bf16 row), up to 4 vectors of 8 a lane (ViT-L/14's 1024).
LN_MAX_WIDTH = 1024


def _check_ln_operands(x, weight, bias) -> None:
    _build.check_cuda_operand("x", x, ndim=2)
    for name, t in (("weight", weight), ("bias", bias)):
        _build.check_cuda_operand(name, t, torch.float32, 1)
    width = x.shape[1]
    if width % 8 or not 0 < width <= LN_MAX_WIDTH:
        raise ValueError(f"the LayerNorm kernel takes widths that are multiples of 8 up to "
                         f"{LN_MAX_WIDTH}, not {width}")


def ln_quant_launch(x, weight, bias, inv, eps, mode: int) -> torch.Tensor:
    """One launch of csrc/ln_quant.cu's int8 kernel in ``mode`` (0: the
    shipped two-pass LN; 1-3: the modes of fitclip_torch/bench)."""
    rows, width = x.shape
    _check_ln_operands(x, weight, bias)
    out = torch.empty(rows, width, dtype=torch.int8, device=x.device)
    _build.call("fitclip_ln_quant", x.data_ptr(), _build.dtype_code(x.dtype),
                weight.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, width,
                float(inv), float(eps), int(mode))
    return out


ln_quant.launches = 0
_LN_QUANT = _build.define_op(
    "ln_quant(Tensor x, Tensor weight, Tensor bias, float inv, float eps) -> Tensor",
    _ln_quant_cuda, ln_quant_plain,
    lambda x, weight, bias, inv, eps: x.new_empty(x.shape, dtype=torch.int8))


# --- int8 GEMM ------------------------------------------------------------

def int8_gemm_bias_plain(a, w, scale, bias, out_dtype):
    return (int_matmul(a, w) * scale + bias).to(out_dtype)


def int8_gemm_residual_plain(a, w, scale, bias, residual, out_dtype):
    return (residual.float() + (int_matmul(a, w) * scale + bias)).to(out_dtype)


def int8_gemm_gelu_plain(a, w, fs2, fb2, kv: float, quick_gelu: bool):
    t = int_matmul(a, w) * fs2 + fb2
    if quick_gelu:
        g = t / (1.0 + torch.exp2(t * kv))
    else:
        z = t * kv
        az = z.abs()
        u = 1.0 / (1.0 + 0.3275911 * az)
        poly = u * (0.254829592 + u * (-0.284496736 + u * (
            1.421413741 + u * (-1.453152027 + u * 1.061405429))))
        pe = poly * torch.exp2((-LOG2E) * az * az)
        erf = torch.where(z < 0.0, pe - 1.0, 1.0 - pe)
        g = 0.5 * t * (1.0 + erf)
    return quantize_rint(g)


def _gemm(a, w, scale, bias, epilogue, out, residual=None, kv=0.0, act=0):
    """One launch of csrc/int8_gemm.cu; act is the fc epilogue's Act code
    (0: exact GELU, 1: QuickGELU; 2-6: the epilogues of fitclip_torch/bench)."""
    _build.check_cuda_operand("a", a, torch.int8, 2)
    _build.check_cuda_operand("w", w, torch.int8, 2)
    for name, t in (("scale", scale), ("bias", bias)):
        _build.check_cuda_operand(name, t, torch.float32, 1)
    (m, k), n = a.shape, w.shape[0]
    if w.shape[1] != k or k <= 0 or k % 16 or scale.numel() != n or bias.numel() != n:
        raise ValueError(f"int8_gemm: a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"{scale.numel()} scales, {bias.numel()} biases "
                         "(w is (N, K) with K a positive multiple of 16)")
    _build.check_cuda_operand("out", out, ndim=2)
    res_ptr, res_code = 0, 0
    if residual is not None:
        _build.check_cuda_operand("residual", residual, ndim=2)
        if residual.shape != (m, n):
            raise ValueError(f"residual {tuple(residual.shape)} must be ({m}, {n})")
        res_ptr, res_code = residual.data_ptr(), _build.dtype_code(residual.dtype)
    out_code = 0 if out.dtype == torch.int8 else _build.dtype_code(out.dtype)
    _build.call("fitclip_int8_gemm", a.data_ptr(), w.data_ptr(), m, n, k, epilogue,
                scale.data_ptr(), bias.data_ptr(), res_ptr, res_code, out.data_ptr(),
                out_code, float(kv), int(act))


def _gemm_out(a, w, dtype):
    """The (M, N) output of a GEMM of a (M, K) by w (N, K), real or fake."""
    return a.new_empty(a.shape[0], w.shape[0], dtype=dtype)


def int8_gemm_bias(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """int8 a (M, K) x int8 w (N, K)^T -> acc * scale + bias in out_dtype."""
    return _INT8_GEMM_BIAS(a, w, scale, bias, out_dtype)


def _int8_gemm_bias_cuda(a, w, scale, bias, out_dtype):
    out = _gemm_out(a, w, out_dtype)
    _gemm(a, w, scale, bias, _BIAS, out)
    int8_gemm_bias.launches += 1
    return out


int8_gemm_bias.launches = 0
_INT8_GEMM_BIAS = _build.define_op(
    "int8_gemm_bias(Tensor a, Tensor w, Tensor scale, Tensor bias, ScalarType out_dtype) -> Tensor",
    _int8_gemm_bias_cuda, int8_gemm_bias_plain,
    lambda a, w, scale, bias, out_dtype: _gemm_out(a, w, out_dtype))


def int8_gemm_residual(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, residual: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """residual + (acc * scale + bias), added in fp32, in out_dtype."""
    return _INT8_GEMM_RESIDUAL(a, w, scale, bias, residual, out_dtype)


def _int8_gemm_residual_cuda(a, w, scale, bias, residual, out_dtype):
    out = _gemm_out(a, w, out_dtype)
    _gemm(a, w, scale, bias, _RESIDUAL, out, residual=residual)
    int8_gemm_residual.launches += 1
    return out


int8_gemm_residual.launches = 0
_INT8_GEMM_RESIDUAL = _build.define_op(
    "int8_gemm_residual(Tensor a, Tensor w, Tensor scale, Tensor bias, Tensor residual, "
    "ScalarType out_dtype) -> Tensor",
    _int8_gemm_residual_cuda, int8_gemm_residual_plain,
    lambda a, w, scale, bias, residual, out_dtype: _gemm_out(a, w, out_dtype))


def int8_gemm_gelu(a: torch.Tensor, w: torch.Tensor, fs2: torch.Tensor,
                   fb2: torch.Tensor, kv: float, quick_gelu: bool) -> torch.Tensor:
    """The folded fc epilogue: t = acc * fs2 + fb2, GELU, rint/clip -> int8."""
    return _INT8_GEMM_GELU(a, w, fs2, fb2, float(kv), bool(quick_gelu))


def _int8_gemm_gelu_cuda(a, w, fs2, fb2, kv, quick_gelu):
    out = _gemm_out(a, w, torch.int8)
    _gemm(a, w, fs2, fb2, _GELU, out, kv=kv, act=int(quick_gelu))
    int8_gemm_gelu.launches += 1
    return out


int8_gemm_gelu.launches = 0
_INT8_GEMM_GELU = _build.define_op(
    "int8_gemm_gelu(Tensor a, Tensor w, Tensor fs2, Tensor fb2, float kv, bool quick_gelu) "
    "-> Tensor",
    _int8_gemm_gelu_cuda, int8_gemm_gelu_plain,
    lambda a, w, fs2, fb2, kv, quick_gelu: _gemm_out(a, w, torch.int8))


# --- the layer ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Int8LayerOperands:
    """One layer's operands, folded once from its weights and act scales
    (block.py:_dense_operands and the fs2/fb2/kv/invs folding of
    fused_int8_layer). int8 weights are (N, K): output rows, K contiguous."""
    ln1_weight: torch.Tensor
    ln1_bias: torch.Tensor
    wq: torch.Tensor
    qs: torch.Tensor
    qb: torch.Tensor
    wo: torch.Tensor
    os: torch.Tensor
    ob: torch.Tensor
    ln2_weight: torch.Tensor
    ln2_bias: torch.Tensor
    wf: torch.Tensor
    fs2: torch.Tensor
    fb2: torch.Tensor
    wp: torch.Tensor
    ps: torch.Tensor
    pb: torch.Tensor
    inv_q: float
    inv_o: float
    inv_f: float
    kv: float
    quick_gelu: bool


def dense_operands(dense):
    """int8 dense (weight_q, scale, bias, act_scale) -> (weight_q, folded
    out_scale, bias, act_inv as an fp32 scalar tensor)."""
    act = torch.clamp_min(dense.act_scale.float().reshape(()), QUANT_EPS)
    out_scale = (act / 127.0) * dense.scale.float()
    return dense.weight_q, out_scale, dense.bias.float(), 127.0 / act


def prepare_int8_layer(block, quick_gelu: bool) -> Int8LayerOperands:
    """Fold a quantized residual block's parameters (ln_1, attn.in_proj,
    attn.out_proj, ln_2, mlp_fc, mlp_proj) into the layer's operands. Must be
    redone whenever an act_scale changes."""
    with torch.no_grad():
        wq, qs, qb, inv_q = dense_operands(block.attn.in_proj)
        wo, osc, ob, inv_o = dense_operands(block.attn.out_proj)
        wf, fs, fb, inv_f = dense_operands(block.mlp_fc)
        wp, ps, pb, inv_p = dense_operands(block.mlp_proj)
        # Dequant and requant collapse into one affine; kv is the exp2
        # exponent multiplier (QuickGELU) or the erf argument scale.
        fs2 = fs * inv_p
        fb2 = fb * inv_p
        kv = (-1.702 * LOG2E / inv_p) if quick_gelu else (0.7071067811865475 / inv_p)
        return Int8LayerOperands(
            block.ln_1.weight.detach().float(), block.ln_1.bias.detach().float(),
            wq, qs, qb, wo, osc, ob,
            block.ln_2.weight.detach().float(), block.ln_2.bias.detach().float(),
            wf, fs2, fb2, wp, ps, pb,
            inv_q.item(), inv_o.item(), inv_f.item(), kv.item(), quick_gelu)


class _Steps(NamedTuple):
    ln_quant: object
    gemm_bias: object
    attention: object
    gemm_residual: object
    gemm_gelu: object


_KERNELS = _Steps(ln_quant, int8_gemm_bias, attention_int8, int8_gemm_residual,
                  int8_gemm_gelu)
_PLAIN = _Steps(ln_quant_plain, int8_gemm_bias_plain, attention_int8_plain,
                int8_gemm_residual_plain, int8_gemm_gelu_plain)


def attention_half(x2, ops: Int8LayerOperands, batch, seq, heads, causal, ln_eps, seq_valid,
                   steps: _Steps) -> torch.Tensor:
    """x2 (B * L, W) -> the fp32 mid-layer residual x2 + proj(attention(LN1(x2)))."""
    width = x2.shape[1]
    h1 = steps.ln_quant(x2, ops.ln1_weight, ops.ln1_bias, ops.inv_q, ln_eps)
    qkv = steps.gemm_bias(h1, ops.wq, ops.qs, ops.qb, x2.dtype)
    att = steps.attention(qkv.view(batch, seq, 3 * width), heads, (width // heads) ** -0.5,
                          causal, ops.inv_o, seq_valid)
    return steps.gemm_residual(att.view(batch * seq, width), ops.wo, ops.os, ops.ob, x2,
                               torch.float32)


def mlp_half(x32, ops: Int8LayerOperands, ln_eps, steps: _Steps, out_dtype) -> torch.Tensor:
    """The fp32 residual x32 (B * L, W) -> x32 + MLP(LN2(x32)) in out_dtype."""
    h2 = steps.ln_quant(x32, ops.ln2_weight, ops.ln2_bias, ops.inv_f, ln_eps)
    h = steps.gemm_gelu(h2, ops.wf, ops.fs2, ops.fb2, ops.kv, ops.quick_gelu)
    return steps.gemm_residual(h, ops.wp, ops.ps, ops.pb, x32, out_dtype)


def _layer(x, ops: Int8LayerOperands, heads, causal, ln_eps, seq_valid, steps: _Steps):
    batch, seq, width = x.shape
    x32 = attention_half(x.reshape(batch * seq, width), ops, batch, seq, heads, causal, ln_eps,
                         seq_valid, steps)
    return mlp_half(x32, ops, ln_eps, steps, x.dtype).view(batch, seq, width)


def fused_int8_layer(x: torch.Tensor, ops: Int8LayerOperands, heads: int,
                     causal: bool = False, ln_eps: float = LN_EPS,
                     seq_valid: Optional[int] = None) -> torch.Tensor:
    """x (B, L, W) + one layer's operands -> (B, L, W) in x's dtype, through
    the kernels' operators (their plain versions for CPU tensors). Replaces
    fitclip_tpu/ops/block.py:fused_int8_layer (_layer_kernel)."""
    return _layer(x.contiguous(), ops, heads, causal, ln_eps, seq_valid, _KERNELS)


def fused_int8_layer_plain(x: torch.Tensor, ops: Int8LayerOperands, heads: int,
                           causal: bool = False, ln_eps: float = LN_EPS,
                           seq_valid: Optional[int] = None) -> torch.Tensor:
    """The same layer through the plain PyTorch versions, on any device."""
    return _layer(x, ops, heads, causal, ln_eps, seq_valid, _PLAIN)


# --- the float layer (K2) --------------------------------------------------

def ln_cast_plain(x, weight, bias, out_dtype, eps: float = LN_EPS):
    return layer_norm_plain(x, weight, bias, eps).to(out_dtype)


def ln_cast(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype,
            eps: float = LN_EPS) -> torch.Tensor:
    """(rows, W) bf16/fp32 -> (rows, W) in out_dtype: fp32 LN(x) rounded once.
    Replaces the _ln prologues of block.py:_bf16_layer_kernel."""
    return _LN_CAST(x, weight, bias, out_dtype, float(eps))


def _ln_cast_cuda(x, weight, bias, out_dtype, eps):
    if out_dtype != torch.bfloat16:
        raise TypeError(f"ln_cast writes bfloat16 on the card (K2's compute dtype), not {out_dtype}")
    rows, width = x.shape
    _check_ln_operands(x, weight, bias)
    out = torch.empty(rows, width, dtype=out_dtype, device=x.device)
    _build.call("fitclip_ln_cast", x.data_ptr(), _build.dtype_code(x.dtype), weight.data_ptr(),
                bias.data_ptr(), out.data_ptr(), rows, width, float(eps))
    ln_cast.launches += 1
    return out


ln_cast.launches = 0
_LN_CAST = _build.define_op(
    "ln_cast(Tensor x, Tensor weight, Tensor bias, ScalarType out_dtype, float eps) -> Tensor",
    _ln_cast_cuda, ln_cast_plain,
    lambda x, weight, bias, out_dtype, eps: x.new_empty(x.shape, dtype=out_dtype))


def _dense_plain(a, w, bias):
    """acc + bias in fp32 (block.py:_bf16_layer_kernel's dense). On the card,
    call it with TF32 matmuls disabled."""
    return a.float() @ w.float().T + bias


def exact_gelu_plain(h):
    """block.py:_exact_gelu: x * Phi(x), erf by the A&S 7.1.26 polynomial."""
    z = h * 0.7071067811865475
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    erf_abs = 1.0 - poly * torch.exp(-az * az)
    erf = torch.where(z < 0.0, -erf_abs, erf_abs)
    return h * 0.5 * (1.0 + erf)


def bf16_gemm_bias_plain(a, w, bias):
    return _dense_plain(a, w, bias).to(a.dtype)


def bf16_gemm_residual_plain(a, w, bias, residual, out_dtype):
    return (residual.float() + _dense_plain(a, w, bias)).to(out_dtype)


def bf16_gemm_gelu_plain(a, w, bias, quick_gelu: bool):
    h = _dense_plain(a, w, bias)
    g = h * torch.sigmoid(1.702 * h) if quick_gelu else exact_gelu_plain(h)
    return g.to(a.dtype)


def _bf16_gemm(a, w, bias, epilogue, out, residual=None, quick_gelu=False):
    _build.check_cuda_operand("a", a, torch.bfloat16, 2)
    _build.check_cuda_operand("w", w, torch.bfloat16, 2)
    _build.check_cuda_operand("bias", bias, torch.float32, 1)
    (m, k), n = a.shape, w.shape[0]
    if w.shape[1] != k or k <= 0 or k % 8 or bias.numel() != n:
        raise ValueError(f"bf16_gemm: a {tuple(a.shape)}, w {tuple(w.shape)}, {bias.numel()} "
                         "biases (w is (N, K) with K a positive multiple of 8)")
    _build.check_cuda_operand("out", out, ndim=2)
    res_ptr, res_code = 0, 0
    if residual is not None:
        _build.check_cuda_operand("residual", residual, ndim=2)
        if residual.shape != (m, n):
            raise ValueError(f"residual {tuple(residual.shape)} must be ({m}, {n})")
        res_ptr, res_code = residual.data_ptr(), _build.dtype_code(residual.dtype)
    _build.call("fitclip_bf16_gemm", a.data_ptr(), w.data_ptr(), m, n, k, epilogue,
                bias.data_ptr(), res_ptr, res_code, out.data_ptr(), _build.dtype_code(out.dtype),
                int(quick_gelu))


def bf16_gemm_bias(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """a (M, K) x w (N, K)^T -> acc + bias, fp32 accumulate, in a's dtype."""
    return _BF16_GEMM_BIAS(a, w, bias)


def _bf16_gemm_bias_cuda(a, w, bias):
    out = _gemm_out(a, w, a.dtype)
    _bf16_gemm(a, w, bias, _BIAS, out)
    bf16_gemm_bias.launches += 1
    return out


bf16_gemm_bias.launches = 0
_BF16_GEMM_BIAS = _build.define_op(
    "bf16_gemm_bias(Tensor a, Tensor w, Tensor bias) -> Tensor",
    _bf16_gemm_bias_cuda, bf16_gemm_bias_plain, lambda a, w, bias: _gemm_out(a, w, a.dtype))


def bf16_gemm_residual(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       residual: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """residual + (acc + bias), added in fp32, in out_dtype."""
    return _BF16_GEMM_RESIDUAL(a, w, bias, residual, out_dtype)


def _bf16_gemm_residual_cuda(a, w, bias, residual, out_dtype):
    out = _gemm_out(a, w, out_dtype)
    _bf16_gemm(a, w, bias, _RESIDUAL, out, residual=residual)
    bf16_gemm_residual.launches += 1
    return out


bf16_gemm_residual.launches = 0
_BF16_GEMM_RESIDUAL = _build.define_op(
    "bf16_gemm_residual(Tensor a, Tensor w, Tensor bias, Tensor residual, ScalarType out_dtype) "
    "-> Tensor",
    _bf16_gemm_residual_cuda, bf16_gemm_residual_plain,
    lambda a, w, bias, residual, out_dtype: _gemm_out(a, w, out_dtype))


def bf16_gemm_gelu(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   quick_gelu: bool) -> torch.Tensor:
    """GELU(acc + bias) in fp32 (QuickGELU, or the exact GELU's A&S erf), in a's dtype."""
    return _BF16_GEMM_GELU(a, w, bias, bool(quick_gelu))


def _bf16_gemm_gelu_cuda(a, w, bias, quick_gelu):
    out = _gemm_out(a, w, a.dtype)
    _bf16_gemm(a, w, bias, _GELU, out, quick_gelu=quick_gelu)
    bf16_gemm_gelu.launches += 1
    return out


bf16_gemm_gelu.launches = 0
_BF16_GEMM_GELU = _build.define_op(
    "bf16_gemm_gelu(Tensor a, Tensor w, Tensor bias, bool quick_gelu) -> Tensor",
    _bf16_gemm_gelu_cuda, bf16_gemm_gelu_plain,
    lambda a, w, bias, quick_gelu: _gemm_out(a, w, a.dtype))


@dataclasses.dataclass(frozen=True)
class Bf16LayerOperands:
    """One float layer's operands (fused_bf16_layer's): weights cast once to
    the compute dtype, (N, K) with K contiguous; biases and LN vectors fp32."""
    ln1_weight: torch.Tensor
    ln1_bias: torch.Tensor
    wq: torch.Tensor
    qb: torch.Tensor
    wo: torch.Tensor
    ob: torch.Tensor
    ln2_weight: torch.Tensor
    ln2_bias: torch.Tensor
    wf: torch.Tensor
    fb: torch.Tensor
    wp: torch.Tensor
    pb: torch.Tensor


def prepare_bf16_layer(block) -> Bf16LayerOperands:
    """A float residual block's parameters (ln_1, attn.in_proj, attn.out_proj,
    ln_2, mlp_fc, mlp_proj) as the float layer's operands."""
    with torch.no_grad():
        def dense(d):
            return d.weight.detach().to(d.dtype).contiguous(), d.bias.detach().float()

        def ln(norm):
            return norm.weight.detach().float(), norm.bias.detach().float()

        return Bf16LayerOperands(*ln(block.ln_1), *dense(block.attn.in_proj),
                                 *dense(block.attn.out_proj), *ln(block.ln_2),
                                 *dense(block.mlp_fc), *dense(block.mlp_proj))


class _FloatSteps(NamedTuple):
    ln_cast: object
    gemm_bias: object
    attention: object
    gemm_residual: object
    gemm_gelu: object


_FLOAT_KERNELS = _FloatSteps(ln_cast, bf16_gemm_bias, attention_block, bf16_gemm_residual,
                             bf16_gemm_gelu)
_FLOAT_PLAIN = _FloatSteps(ln_cast_plain, bf16_gemm_bias_plain, attention_block_plain,
                           bf16_gemm_residual_plain, bf16_gemm_gelu_plain)


def _float_layer(x, ops: Bf16LayerOperands, heads, causal, quick_gelu, ln_eps, seq_valid,
                 steps: _FloatSteps):
    batch, seq, width = x.shape
    x2 = x.reshape(batch * seq, width)
    # --- attention half: qkv in x's dtype, the residual sum in fp32 ---
    h1 = steps.ln_cast(x2, ops.ln1_weight, ops.ln1_bias, x.dtype, ln_eps)
    qkv = steps.gemm_bias(h1, ops.wq, ops.qb)
    att = steps.attention(qkv.view(batch, seq, 3 * width), heads, (width // heads) ** -0.5,
                          causal, seq_valid)
    x32 = steps.gemm_residual(att.view(batch * seq, width), ops.wo, ops.ob, x2, torch.float32)
    # --- MLP half: y is rounded to x's dtype once ---
    h2 = steps.ln_cast(x32, ops.ln2_weight, ops.ln2_bias, x.dtype, ln_eps)
    h = steps.gemm_gelu(h2, ops.wf, ops.fb, quick_gelu)
    y = steps.gemm_residual(h, ops.wp, ops.pb, x32, x.dtype)
    return y.view(batch, seq, width)


def fused_bf16_layer(x: torch.Tensor, ops: Bf16LayerOperands, heads: int,
                     causal: bool = False, quick_gelu: bool = True, ln_eps: float = LN_EPS,
                     seq_valid: Optional[int] = None) -> torch.Tensor:
    """x (B, L, W) + one float layer's operands -> (B, L, W) in x's dtype,
    through the Hopper kernels (their plain versions for CPU tensors). Replaces
    fitclip_tpu/ops/block.py:fused_bf16_layer (_bf16_layer_kernel, K2). On the
    card x and the weights are bf16: the kernels take no other float type."""
    if x.device.type == "cuda" and (x.dtype != torch.bfloat16 or ops.wq.dtype != torch.bfloat16):
        raise TypeError(f"fused_bf16_layer (K2) runs in bfloat16 on the card; got x "
                        f"{x.dtype}, weights {ops.wq.dtype}")
    return _float_layer(x.contiguous(), ops, heads, causal, quick_gelu, ln_eps, seq_valid,
                        _FLOAT_KERNELS)


def fused_bf16_layer_plain(x: torch.Tensor, ops: Bf16LayerOperands, heads: int,
                           causal: bool = False, quick_gelu: bool = True,
                           ln_eps: float = LN_EPS,
                           seq_valid: Optional[int] = None) -> torch.Tensor:
    """The same layer through the plain PyTorch versions, on any device."""
    return _float_layer(x, ops, heads, causal, quick_gelu, ln_eps, seq_valid, _FLOAT_PLAIN)
