"""Multi-head attention over the unsplit (B, L, 3 * H * D) QKV projection
output, forward only (port of ``fitclip_tpu/ops/attention.py``'s
``fused_attention_qkv`` and of the per-head core of ``ops/block.py``).

One Hopper kernel (``csrc/attention.cu``) serves two wrappers:

- ``fused_attention_qkv``: replaces ``attention.py:_packed_kernel`` (K3,
  forward). Weights are exps / denom, the output is in qkv's dtype.
- ``attention_int8``: replaces the attention core of ``block.py:_layer_kernel``
  (K1). The out-projection's requant multiplier rides the softmax normalizer
  (weights = exps * (out_mul / denom)), and the fp32 output is rounded and
  clipped to int8.

On the H100 the kernel is bound by latency and shared-memory bandwidth: at
L <= 577 one head's K and V fit in shared memory, so a block reads them once
for 64 query rows and the (L, L) logits never reach device memory. See the
source for the layout.

Each wrapper takes its plain version, ``attention_core_plain``, for a tensor on
the CPU only; for a CUDA tensor it launches the kernel or raises. The plain
version runs on any device (the card compares the kernel against it).
"""

from typing import Optional

import torch

from fitclip_torch import _build
from fitclip_torch.ops.quant import quantize_rint

HEAD_DIM = 64  # the kernel's head_dim: every CLIP preset's


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
    batch, seq, triple = qkv.shape
    head_dim = triple // 3 // heads
    if head_dim != HEAD_DIM or triple != 3 * heads * head_dim:
        raise ValueError(f"the attention kernel takes head_dim {HEAD_DIM}; "
                         f"got (B, L, 3*H*D) = {tuple(qkv.shape)} with {heads} heads")
    code = _build.dtype_code(qkv.dtype)
    smem = _build.library().fitclip_attention_smem_bytes(code, seq)
    if smem > 232448:
        raise ValueError(f"sequence length {seq} needs {smem} bytes of shared memory "
                         "per block; an H100 block has 232448")
    valid = seq if seq_valid is None else min(int(seq_valid), seq)
    if valid < 1:
        raise ValueError(f"seq_valid must be >= 1, got {seq_valid}")
    _build.call("fitclip_attention", qkv.data_ptr(), code, out.data_ptr(), int(int8_out),
                batch, seq, heads, head_dim, float(scale), int(causal), valid,
                float(out_mul))


def fused_attention_qkv(qkv: torch.Tensor, heads: int, scale: float,
                        causal: bool = False) -> torch.Tensor:
    """(B, L, 3*H*D) -> (B, L, H*D) in qkv's dtype. Replaces
    ``fitclip_tpu/ops/attention.py:_packed_kernel`` (forward)."""
    if qkv.device.type == "cpu":
        return attention_core_plain(qkv, heads, scale, causal)
    batch, seq, triple = qkv.shape
    out = torch.empty(batch, seq, triple // 3, dtype=qkv.dtype, device=qkv.device)
    _launch(qkv, heads, scale, causal, None, out, False, 0.0)
    fused_attention_qkv.launches += 1
    return out


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
