"""The int8 W8A8 transformer layer for inference (port of
``fitclip_tpu/ops/block.py:fused_int8_layer``).

The TPU kernel ``_layer_kernel`` (K1) runs a whole pre-LN residual block in
one call, with the layer's weights resident in 100 MB of VMEM. An H100 SM has
227 KB of shared memory, so on Hopper the layer is a fixed set of three
kernels, launched seven times per layer:

1. ``ln_quant`` (``csrc/ln_quant.cu``): fp32 LayerNorm, then static quantize
   to int8. Bound by memory: one read of the row, one int8 write.
2. ``int8_gemm_*`` (``csrc/int8_gemm.cu``): int8 x int8 -> int32 on the
   tensor cores (mma.sync), with the dequant/bias epilogue (QKV), the residual
   epilogue (out-projection into the fp32 residual, final projection back to
   x's dtype) or the folded fc epilogue (dequant and requant as one affine,
   QuickGELU or exact GELU, int8). Bound by compute at M = B * L >= 6k rows.
3. ``attention_int8`` (``ops/attention.py``): per-head softmax attention with
   the requant multiplier in the normalizer, int8 output.

The mid-layer residual stays fp32 from the out-projection to the final add
and is rounded to x's dtype once, as in the TPU kernel. Divides are exact:
the CPU interpret reference of the TPU kernel divides exactly too.

Each wrapper takes its plain PyTorch version for a tensor on the CPU only;
for a CUDA tensor it launches its kernel or raises. ``fused_int8_layer_plain``
runs the same composition through the plain versions on any device.
"""

import dataclasses
from typing import NamedTuple, Optional

import torch

from fitclip_torch import _build
from fitclip_torch.ops.attention import attention_int8, attention_int8_plain
from fitclip_torch.ops.quant import QUANT_EPS, int_matmul, quantize_rint

LN_EPS = 1e-5
LOG2E = 1.4426950408889634

_BIAS, _RESIDUAL, _GELU = 0, 1, 2  # csrc/int8_gemm.cu epilogues


# --- ln_quant -------------------------------------------------------------

def ln_quant_plain(x, weight, bias, inv: float, eps: float = LN_EPS):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps) * weight + bias
    return quantize_rint(y * inv)


def ln_quant(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, inv: float,
             eps: float = LN_EPS) -> torch.Tensor:
    """(rows, W) bf16/fp32 -> int8 (rows, W): clip(rint(LN(x) * inv)).
    Replaces the _ln + _quant prologues of block.py:_layer_kernel."""
    if x.device.type == "cpu":
        return ln_quant_plain(x, weight, bias, inv, eps)
    rows, width = x.shape
    _build.check_cuda_operand("x", x, ndim=2)
    for name, t in (("weight", weight), ("bias", bias)):
        _build.check_cuda_operand(name, t, torch.float32, 1)
    out = torch.empty(rows, width, dtype=torch.int8, device=x.device)
    _build.call("fitclip_ln_quant", x.data_ptr(), _build.dtype_code(x.dtype),
                weight.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, width,
                float(inv), float(eps))
    ln_quant.launches += 1
    return out


ln_quant.launches = 0


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


def _gemm(a, w, scale, bias, epilogue, out, residual=None, kv=0.0, quick_gelu=False):
    _build.check_cuda_operand("a", a, torch.int8, 2)
    _build.check_cuda_operand("w", w, torch.int8, 2)
    for name, t in (("scale", scale), ("bias", bias)):
        _build.check_cuda_operand(name, t, torch.float32, 1)
    (m, k), n = a.shape, w.shape[0]
    if w.shape[1] != k or k % 16 or scale.numel() != n or bias.numel() != n:
        raise ValueError(f"int8_gemm: a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"{scale.numel()} scales, {bias.numel()} biases "
                         "(w is (N, K) with K a multiple of 16)")
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
                out_code, float(kv), int(quick_gelu))


def int8_gemm_bias(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """int8 a (M, K) x int8 w (N, K)^T -> acc * scale + bias in out_dtype."""
    if a.device.type == "cpu":
        return int8_gemm_bias_plain(a, w, scale, bias, out_dtype)
    out = torch.empty(a.shape[0], w.shape[0], dtype=out_dtype, device=a.device)
    _gemm(a, w, scale, bias, _BIAS, out)
    int8_gemm_bias.launches += 1
    return out


int8_gemm_bias.launches = 0


def int8_gemm_residual(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, residual: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """residual + (acc * scale + bias), added in fp32, in out_dtype."""
    if a.device.type == "cpu":
        return int8_gemm_residual_plain(a, w, scale, bias, residual, out_dtype)
    out = torch.empty(a.shape[0], w.shape[0], dtype=out_dtype, device=a.device)
    _gemm(a, w, scale, bias, _RESIDUAL, out, residual=residual)
    int8_gemm_residual.launches += 1
    return out


int8_gemm_residual.launches = 0


def int8_gemm_gelu(a: torch.Tensor, w: torch.Tensor, fs2: torch.Tensor,
                   fb2: torch.Tensor, kv: float, quick_gelu: bool) -> torch.Tensor:
    """The folded fc epilogue: t = acc * fs2 + fb2, GELU, rint/clip -> int8."""
    if a.device.type == "cpu":
        return int8_gemm_gelu_plain(a, w, fs2, fb2, kv, quick_gelu)
    out = torch.empty(a.shape[0], w.shape[0], dtype=torch.int8, device=a.device)
    _gemm(a, w, fs2, fb2, _GELU, out, kv=kv, quick_gelu=quick_gelu)
    int8_gemm_gelu.launches += 1
    return out


int8_gemm_gelu.launches = 0


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


def _layer(x, ops: Int8LayerOperands, heads, causal, ln_eps, seq_valid, steps: _Steps):
    batch, seq, width = x.shape
    x2 = x.reshape(batch * seq, width)
    # --- attention half ---
    h1 = steps.ln_quant(x2, ops.ln1_weight, ops.ln1_bias, ops.inv_q, ln_eps)
    qkv = steps.gemm_bias(h1, ops.wq, ops.qs, ops.qb, x.dtype)
    att = steps.attention(qkv.view(batch, seq, 3 * width), heads, (width // heads) ** -0.5,
                          causal, ops.inv_o, seq_valid)
    x32 = steps.gemm_residual(att.view(batch * seq, width), ops.wo, ops.os, ops.ob, x2,
                              torch.float32)
    # --- MLP half ---
    h2 = steps.ln_quant(x32, ops.ln2_weight, ops.ln2_bias, ops.inv_f, ln_eps)
    h = steps.gemm_gelu(h2, ops.wf, ops.fs2, ops.fb2, ops.kv, ops.quick_gelu)
    y = steps.gemm_residual(h, ops.wp, ops.ps, ops.pb, x32, x.dtype)
    return y.view(batch, seq, width)


def fused_int8_layer(x: torch.Tensor, ops: Int8LayerOperands, heads: int,
                     causal: bool = False, ln_eps: float = LN_EPS,
                     seq_valid: Optional[int] = None) -> torch.Tensor:
    """x (B, L, W) + one layer's operands -> (B, L, W) in x's dtype, through
    the Hopper kernels (their plain versions for CPU tensors). Replaces
    fitclip_tpu/ops/block.py:fused_int8_layer (_layer_kernel)."""
    return _layer(x.contiguous(), ops, heads, causal, ln_eps, seq_valid, _KERNELS)


def fused_int8_layer_plain(x: torch.Tensor, ops: Int8LayerOperands, heads: int,
                           causal: bool = False, ln_eps: float = LN_EPS,
                           seq_valid: Optional[int] = None) -> torch.Tensor:
    """The same layer through the plain PyTorch versions, on any device."""
    return _layer(x, ops, heads, causal, ln_eps, seq_valid, _PLAIN)
