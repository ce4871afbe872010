"""The int8 Frozen-in-Time SpaceTimeBlock for inference (port of
``fitclip_tpu/ops/fit_block.py``, K4):

    t = x + proj_t(timeattn(norm3(x)))
    s = x + proj_s(attn(norm1(t)))          # residual from x, not from t
    y = s + fc2(gelu(fc1(norm2(s))))        # exact GELU (A&S erf)

The TPU kernel ``_fit_layer_pad_kernel`` runs the block in one call with its
six int8 weights resident in VMEM. On Hopper the block is a fixed composition
of the K1 kernels (``ops/block.py``) and the int8 modes of
``csrc/fit_attention.cu`` (``ops/attention.py``), 12 launches per block:

- ``ln_quant`` with eps 1e-6 before each of the three halves;
- ``int8_gemm_bias`` for the two qkv projections (bf16 out);
- per attention half, ``fit_cls_attention_int8`` (row 0 over all N rows) and
  ``fit_time_attention_int8`` or ``fit_space_attention_int8`` (rows 1..),
  writing one int8 (B, N, W) buffer with the proj's requant multiplier in the
  normalizer;
- ``int8_gemm_residual`` for the two projections (residual x, fp32 out: x32
  stays live across both halves) and for fc2 (residual s, x's dtype out);
- ``int8_gemm_gelu`` for fc1 with the exact-GELU epilogue.

The port keeps one row layout, the joint (B, 1 + F * P, W): the TPU's pad8
and split layouts and its variant strings are TPU formulations of the same
function. Divides are exact, as in the TPU kernel's CPU interpret reference.
``fused_fit_int8_layer_plain`` runs the same composition through the plain
versions on any device.
"""

import dataclasses
from typing import NamedTuple

import torch

from fitclip_torch.ops.attention import (cls_attention_plain, fit_cls_attention_int8,
                                         fit_rows_attention_int8_plain,
                                         fit_space_attention_int8, fit_time_attention_int8)
from fitclip_torch.ops.block import (dense_operands, int8_gemm_bias, int8_gemm_bias_plain,
                                     int8_gemm_gelu, int8_gemm_gelu_plain, int8_gemm_residual,
                                     int8_gemm_residual_plain, ln_quant, ln_quant_plain)
from fitclip_torch.ops.quant import quantize_rint

FIT_LN_EPS = 1e-6
_ERF_ARG = 0.7071067811865475


@dataclasses.dataclass(frozen=True)
class FitLayerOperands:
    """One SpaceTimeBlock's operands, folded once from its weights and act
    scales (fit_block.py:_layer_weight_operands). int8 weights are (N, K)."""
    ln3_weight: torch.Tensor
    ln3_bias: torch.Tensor
    wtq: torch.Tensor
    tqs: torch.Tensor
    tqb: torch.Tensor
    wtp: torch.Tensor
    tps: torch.Tensor
    tpb: torch.Tensor
    ln1_weight: torch.Tensor
    ln1_bias: torch.Tensor
    wsq: torch.Tensor
    sqs: torch.Tensor
    sqb: torch.Tensor
    wsp: torch.Tensor
    sps: torch.Tensor
    spb: torch.Tensor
    ln2_weight: torch.Tensor
    ln2_bias: torch.Tensor
    wf: torch.Tensor
    fs2: torch.Tensor
    fb2: torch.Tensor
    wp: torch.Tensor
    ps: torch.Tensor
    pb: torch.Tensor
    inv_tq: float
    inv_tp: float
    inv_sq: float
    inv_sp: float
    inv_f: float
    kv: float


def prepare_fit_int8_layer(block) -> FitLayerOperands:
    """Fold a quantized SpaceTimeBlock (norm1-3, timeattn/attn qkv and proj,
    mlp_fc1, mlp_fc2) into the layer's operands: folded out-scales,
    fs2 = fs * inv_p, fb2 = fb * inv_p, kv = 0.70710678 / inv_p."""
    with torch.no_grad():
        wtq, tqs, tqb, inv_tq = dense_operands(block.timeattn.qkv)
        wtp, tps, tpb, inv_tp = dense_operands(block.timeattn.proj)
        wsq, sqs, sqb, inv_sq = dense_operands(block.attn.qkv)
        wsp, sps, spb, inv_sp = dense_operands(block.attn.proj)
        wf, fs, fb, inv_f = dense_operands(block.mlp_fc1)
        wp, ps, pb, inv_p = dense_operands(block.mlp_fc2)

        def ln(norm):
            return norm.weight.detach().float(), norm.bias.detach().float()

        return FitLayerOperands(
            *ln(block.norm3), wtq, tqs, tqb, wtp, tps, tpb,
            *ln(block.norm1), wsq, sqs, sqb, wsp, sps, spb,
            *ln(block.norm2), wf, fs * inv_p, fb * inv_p, wp, ps, pb,
            inv_tq.item(), inv_tp.item(), inv_sq.item(), inv_sp.item(), inv_f.item(),
            (_ERF_ARG / inv_p).item())


def fit_attention_int8(qkv: torch.Tensor, heads: int, frames: int, mode: str,
                       out_mul: float) -> torch.Tensor:
    """One attention half's core on the joint (B, N, 3W) qkv -> int8 (B, N, W):
    the CLS row's global attention and the time or space attention of the
    patch rows, two launches into one buffer."""
    batch, n, triple = qkv.shape
    out = torch.empty(batch, n, triple // 3, dtype=torch.int8, device=qkv.device)
    fit_cls_attention_int8(qkv, heads, out_mul, out)
    rows = fit_time_attention_int8 if mode == "time" else fit_space_attention_int8
    return rows(qkv, heads, frames, out_mul, out)


def fit_attention_int8_plain(qkv: torch.Tensor, heads: int, frames: int, mode: str,
                             out_mul: float) -> torch.Tensor:
    scale = (qkv.shape[2] // 3 // heads) ** -0.5
    return quantize_rint(torch.cat([cls_attention_plain(qkv, heads, scale, out_mul),
                                    fit_rows_attention_int8_plain(qkv, heads, frames, mode,
                                                                  out_mul)], dim=1))


class _Steps(NamedTuple):
    ln_quant: object
    gemm_bias: object
    attention: object
    gemm_residual: object
    gemm_gelu: object


_KERNELS = _Steps(ln_quant, int8_gemm_bias, fit_attention_int8, int8_gemm_residual,
                  int8_gemm_gelu)
_PLAIN = _Steps(ln_quant_plain, int8_gemm_bias_plain, fit_attention_int8_plain,
                int8_gemm_residual_plain, int8_gemm_gelu_plain)


def _layer(x, ops: FitLayerOperands, heads: int, frames: int, steps: _Steps):
    batch, n, width = x.shape
    x2 = x.reshape(batch * n, width)

    def attention_half(h, ln_w, ln_b, inv_in, wq, qs, qb, mode, inv_out, wo, os, ob):
        h_q = steps.ln_quant(h, ln_w, ln_b, inv_in, FIT_LN_EPS)
        qkv = steps.gemm_bias(h_q, wq, qs, qb, x.dtype).view(batch, n, 3 * width)
        att = steps.attention(qkv, heads, frames, mode, inv_out)
        return steps.gemm_residual(att.view(batch * n, width), wo, os, ob, x2, torch.float32)

    t32 = attention_half(x2, ops.ln3_weight, ops.ln3_bias, ops.inv_tq, ops.wtq, ops.tqs,
                         ops.tqb, "time", ops.inv_tp, ops.wtp, ops.tps, ops.tpb)
    s32 = attention_half(t32, ops.ln1_weight, ops.ln1_bias, ops.inv_sq, ops.wsq, ops.sqs,
                         ops.sqb, "space", ops.inv_sp, ops.wsp, ops.sps, ops.spb)
    h2 = steps.ln_quant(s32, ops.ln2_weight, ops.ln2_bias, ops.inv_f, FIT_LN_EPS)
    h = steps.gemm_gelu(h2, ops.wf, ops.fs2, ops.fb2, ops.kv, False)
    return steps.gemm_residual(h, ops.wp, ops.ps, ops.pb, s32, x.dtype).view(batch, n, width)


def fused_fit_int8_layer(x: torch.Tensor, ops: FitLayerOperands, heads: int,
                         frames: int) -> torch.Tensor:
    """x (B, 1 + F*P, W) + one block's operands -> (B, 1 + F*P, W) in x's
    dtype, through the Hopper kernels (their plain versions for CPU tensors).
    Replaces fitclip_tpu/ops/fit_block.py:fused_fit_int8_layer_pad
    (_fit_layer_pad_kernel) and its joint and split twins."""
    return _layer(x.contiguous(), ops, heads, frames, _KERNELS)


def fused_fit_int8_layer_plain(x: torch.Tensor, ops: FitLayerOperands, heads: int,
                               frames: int) -> torch.Tensor:
    """The same block through the plain PyTorch versions, on any device."""
    return _layer(x, ops, heads, frames, _PLAIN)
