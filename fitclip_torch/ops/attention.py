"""Multi-head attention over the unsplit (B, L, 3 * H * D) QKV projection
output, forward and backward (port of ``fitclip_tpu/ops/attention.py``'s
``fused_attention_qkv`` custom VJP and of the per-head core of
``ops/block.py``).

Three Hopper kernels serve three wrappers:

- ``fused_attention_qkv``: K3, an ``autograd.Function``. Its forward
  (``csrc/attention.cu``, qkv mode) replaces ``attention.py:_packed_kernel``:
  weights are exps / denom, the output is in qkv's dtype. Its backward,
  ``fused_attention_qkv_backward`` (``csrc/attention_bwd.cu``), replaces
  ``attention.py:_packed_bwd_kernel``: it recomputes the softmax from the saved
  qkv, as ``_fwd`` saves only qkv. Every L the card's shared memory holds is
  served; there is no size-dependent fall back to the plain version.
- ``attention_int8``: replaces the attention core of ``block.py:_layer_kernel``
  (K1). The out-projection's requant multiplier rides the softmax normalizer
  (weights = exps * (out_mul / denom)), and the fp32 output is rounded and
  clipped to int8.

On the H100 the kernels are bound by latency and shared-memory bandwidth: at
L <= 577 one head's two (L, 64) operands fit in shared memory, so a block reads
them once for 64 rows and the (L, L) logits never reach device memory. See the
sources for the layouts.

Each wrapper takes its plain version (``attention_core_plain``,
``attention_backward_plain``) for a tensor on the CPU only; for a CUDA tensor it
launches the kernel or raises. The plain versions run on any device (the card
compares the kernels against them).

The forward is also the custom op ``fitclip::fused_attention_qkv``, so that a
selective activation-checkpoint policy (``models/clip/model.py``, remat "dots")
can see and keep its output.
"""

from typing import Optional

import torch

from fitclip_torch import _build
from fitclip_torch.ops.quant import quantize_rint

HEAD_DIM = 64  # the kernels' head_dim: every CLIP preset's
SMEM_LIMIT = 232448  # shared memory a block can use on an H100


def attention_core_plain(qkv: torch.Tensor, heads: int, scale: float, causal: bool,
                         out_mul: Optional[float] = None,
                         seq_valid: Optional[int] = None,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version of both kernels' math (``_packed_kernel`` with
    out_mul None, ``_attention_core`` otherwise). q is scaled in qkv's dtype,
    logits and softmax are fp32, the weights are cast to v's dtype, P.V
    accumulates in fp32. On the card, call it with TF32 matmuls disabled."""
    batch, seq, triple = qkv.shape
    width = triple // 3
    head_dim = width // heads

    def split(t):
        return t.reshape(batch, seq, heads, head_dim).transpose(1, 2)

    q = split(qkv[..., :width] * torch.tensor(scale, dtype=qkv.dtype, device=qkv.device))
    k = split(qkv[..., width:2 * width])
    v = split(qkv[..., 2 * width:])
    logits = q.float() @ k.float().transpose(-1, -2)
    if causal:
        keep = torch.ones(seq, seq, dtype=torch.bool, device=qkv.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    if seq_valid is not None and seq_valid < seq:
        dead = torch.arange(seq, device=qkv.device) >= seq_valid
        logits = logits.masked_fill(dead, -1e30)
    peak = logits.amax(dim=-1, keepdim=True)
    exps = torch.exp(logits - peak)
    denom = exps.sum(dim=-1, keepdim=True)
    weights = exps / denom if out_mul is None else exps * (out_mul / denom)
    out = weights.to(v.dtype).float() @ v.float()
    return out.transpose(1, 2).reshape(batch, seq, width).to(out_dtype or qkv.dtype)


def attention_int8_plain(qkv, heads, scale, causal, out_mul, seq_valid=None):
    return quantize_rint(attention_core_plain(qkv, heads, scale, causal, out_mul,
                                              seq_valid, torch.float32))


def _launch(qkv, heads, scale, causal, seq_valid, out, int8_out, out_mul):
    _build.check_cuda_operand("qkv", qkv, ndim=3)
    _build.check_cuda_operand("out", out, ndim=3)
    batch, seq, _ = qkv.shape
    head_dim = _check_head_dim(qkv, heads)
    code = _build.dtype_code(qkv.dtype)
    smem = _build.library().fitclip_attention_smem_bytes(code, seq)
    if smem > SMEM_LIMIT:
        raise ValueError(f"sequence length {seq} needs {smem} bytes of shared memory "
                         f"per block; an H100 block has {SMEM_LIMIT}")
    valid = seq if seq_valid is None else min(int(seq_valid), seq)
    if valid < 1:
        raise ValueError(f"seq_valid must be >= 1, got {seq_valid}")
    _build.call("fitclip_attention", qkv.data_ptr(), code, out.data_ptr(), int(int8_out),
                batch, seq, heads, head_dim, float(scale), int(causal), valid,
                float(out_mul))


def attention_backward_plain(qkv: torch.Tensor, grad_out: torch.Tensor, heads: int,
                             scale: float, causal: bool) -> torch.Tensor:
    """The plain version of the backward kernel (``_packed_bwd_kernel``'s math
    and casts): q is scaled in qkv's dtype; logits, weights32 and dW are fp32;
    the weights cast to v's dtype feed dV; dL = weights32 * (dW - rowsum(dW *
    weights32)) is cast to q's dtype and masked under causal; dq = dL k * scale,
    dk = dL^T q_s; dqkv is packed back in qkv's dtype. On the card, call it with
    TF32 matmuls disabled."""
    batch, seq, triple = qkv.shape
    width = triple // 3
    head_dim = width // heads

    def split(t):
        return t.reshape(batch, seq, heads, head_dim).transpose(1, 2).float()

    q_s = qkv[..., :width] * torch.tensor(scale, dtype=qkv.dtype, device=qkv.device)
    q32, k, v, g = split(q_s), split(qkv[..., width:2 * width]), split(qkv[..., 2 * width:]), \
        split(grad_out)
    logits = q32 @ k.transpose(-1, -2)
    keep = torch.ones(seq, seq, dtype=torch.bool, device=qkv.device).tril()
    if causal:
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    peak = logits.amax(dim=-1, keepdim=True)
    exps = torch.exp(logits - peak)
    weights32 = exps / exps.sum(dim=-1, keepdim=True)
    weights = weights32.to(qkv.dtype).float()
    d_v = weights.transpose(-1, -2) @ g
    d_weights = g @ v.transpose(-1, -2)
    inner = (d_weights * weights32).sum(dim=-1, keepdim=True)
    d_logits = (weights32 * (d_weights - inner)).to(qkv.dtype).float()
    if causal:
        d_logits = d_logits.masked_fill(~keep, 0.0)
    d_q = (d_logits @ k) * scale
    d_k = d_logits.transpose(-1, -2) @ q32

    def merge(t):
        return t.transpose(1, 2).reshape(batch, seq, width)

    return torch.cat([merge(d_q), merge(d_k), merge(d_v)], dim=-1).to(qkv.dtype)


def _check_head_dim(qkv, heads):
    batch, seq, triple = qkv.shape
    head_dim = triple // 3 // heads
    if head_dim != HEAD_DIM or triple != 3 * heads * head_dim:
        raise ValueError(f"the attention kernels take head_dim {HEAD_DIM}; "
                         f"got (B, L, 3*H*D) = {tuple(qkv.shape)} with {heads} heads")
    return head_dim


@torch.library.custom_op("fitclip::fused_attention_qkv", mutates_args=())
def _forward_op(qkv: torch.Tensor, heads: int, scale: float, causal: bool) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return attention_core_plain(qkv, heads, scale, causal)
    batch, seq, triple = qkv.shape
    out = torch.empty(batch, seq, triple // 3, dtype=qkv.dtype, device=qkv.device)
    _launch(qkv, heads, scale, causal, None, out, False, 0.0)
    fused_attention_qkv.launches += 1
    return out


def fused_attention_qkv_backward(qkv: torch.Tensor, grad_out: torch.Tensor, heads: int,
                                 scale: float, causal: bool = False) -> torch.Tensor:
    """(B, L, 3*H*D) qkv and the (B, L, H*D) output gradient -> dqkv in qkv's
    dtype. Replaces ``fitclip_tpu/ops/attention.py:_packed_bwd_kernel``."""
    if qkv.device.type == "cpu":
        return attention_backward_plain(qkv, grad_out, heads, scale, causal)
    grad_out = grad_out.to(qkv.dtype).contiguous()
    _build.check_cuda_operand("qkv", qkv, ndim=3)
    _build.check_cuda_operand("grad_out", grad_out, ndim=3)
    batch, seq, triple = qkv.shape
    if grad_out.shape != (batch, seq, triple // 3):
        raise ValueError(f"grad_out must be {(batch, seq, triple // 3)}, got "
                         f"{tuple(grad_out.shape)}")
    head_dim = _check_head_dim(qkv, heads)
    code = _build.dtype_code(qkv.dtype)
    smem = _build.library().fitclip_attention_bwd_smem_bytes(code, seq)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the attention backward at sequence length {seq} in {qkv.dtype} "
                         f"needs {smem} bytes of shared memory per block; an H100 block "
                         f"has {SMEM_LIMIT}")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(3, batch, heads, seq, dtype=torch.float32, device=qkv.device)
    _build.call("fitclip_attention_bwd", qkv.data_ptr(), grad_out.data_ptr(), code,
                dqkv.data_ptr(), stats.data_ptr(), batch, seq, heads, head_dim, float(scale),
                int(causal))
    fused_attention_qkv_backward.launches += 1
    return dqkv


fused_attention_qkv_backward.launches = 0


class FusedAttentionQKV(torch.autograd.Function):
    """K3: the forward kernel, and the backward kernel on the saved qkv alone
    (``attention.py:_fwd`` saves only qkv; the backward recomputes the softmax)."""

    @staticmethod
    def forward(ctx, qkv, heads, scale, causal):
        ctx.save_for_backward(qkv)
        ctx.heads, ctx.scale, ctx.causal = heads, scale, causal
        return _forward_op(qkv, heads, scale, causal)

    @staticmethod
    def backward(ctx, grad_out):
        (qkv,) = ctx.saved_tensors
        return (fused_attention_qkv_backward(qkv, grad_out, ctx.heads, ctx.scale, ctx.causal),
                None, None, None)


def fused_attention_qkv(qkv: torch.Tensor, heads: int, scale: float,
                        causal: bool = False) -> torch.Tensor:
    """(B, L, 3*H*D) -> (B, L, H*D) in qkv's dtype, differentiable. Replaces
    ``fitclip_tpu/ops/attention.py:fused_attention_qkv`` (``_packed_kernel``
    forward, ``_packed_bwd_kernel`` backward)."""
    return FusedAttentionQKV.apply(qkv, int(heads), float(scale), bool(causal))


fused_attention_qkv.launches = 0


def attention_int8(qkv: torch.Tensor, heads: int, scale: float, causal: bool,
                   out_mul: float, seq_valid: Optional[int] = None) -> torch.Tensor:
    """(B, L, 3*H*D) -> int8 (B, L, H*D): the attention core of
    ``fitclip_tpu/ops/block.py:_layer_kernel`` with the out-projection's
    requant multiplier out_mul folded into the normalizer. seq_valid masks
    the keys at and past it."""
    if qkv.device.type == "cpu":
        return attention_int8_plain(qkv, heads, scale, causal, out_mul, seq_valid)
    batch, seq, triple = qkv.shape
    out = torch.empty(batch, seq, triple // 3, dtype=torch.int8, device=qkv.device)
    _launch(qkv, heads, scale, causal, seq_valid, out, True, out_mul)
    attention_int8.launches += 1
    return out


attention_int8.launches = 0
