"""Multi-head attention over the unsplit (B, L, 3 * H * D) QKV projection
output, forward and backward (port of ``fitclip_tpu/ops/attention.py``'s
``fused_attention_qkv`` custom VJP and of the per-head core of
``ops/block.py``), and Frozen-in-Time's divided attention (the section at the
end: K5, K6 and K4's int8 cores, ``csrc/fit_attention.cu``).

Three Hopper kernels serve the CLIP wrappers, and K8 is composed of two:

- ``fused_attention_qkv``: K3, an ``autograd.Function``. Its forward
  (``csrc/attention.cu``, qkv mode) replaces ``attention.py:_packed_kernel``:
  weights are exps / denom, the output is in qkv's dtype. Its backward,
  ``fused_attention_qkv_backward`` (``csrc/attention_bwd.cu``), replaces
  ``attention.py:_packed_bwd_kernel``: it recomputes the softmax from the saved
  qkv, as ``_fwd`` saves only qkv. Where the fp32 K and V of one head exceed a
  block's shared memory (L = 577, ViT-L/14@336), both read their second operand
  through L2 (the v_global body of ``attention.cu``, the f32_global body of
  ``attention_bwd.cu``), each picked by shape.
- ``attention_int8``: replaces the attention core of ``block.py:_layer_kernel``
  (K1). The out-projection's requant multiplier rides the softmax normalizer
  (weights = exps * (out_mul / denom)), and the fp32 output is rounded and
  clipped to int8.
- ``attention_block``: replaces the attention core of
  ``block.py:_bf16_layer_kernel`` (K2): weights = exps * (1 / denom), the fp32
  output rounded to qkv's dtype, as K2's out-projection casts it.
- ``fused_int8_qkv_attention``: K8, ``attention.py:_int8_qkv_attention_kernel``:
  the int8 QKV projection (K1's int8 GEMM, bias epilogue) then the qkv mode of
  the attention kernel. On Hopper the (B, L, 3W) qkv makes one round trip
  through device memory between the two launches.

On the H100 the forward attention runs one of four bodies of ``attention.cu``,
picked by ``attention_body`` from (dtype, L, head_dim) alone; the kernel entry
refuses any other:

- ``mma`` (bf16, L <= 208: every CLIP and SLIP tower, FiT's 197 keys): the
  tensor-core core of ``csrc/attention_mma.cuh``. A block copies one head's K
  and V into shared memory once for 64 query rows; each warp runs QK^T and P.V
  for 16 rows on ``mma.sync`` with every logit in registers, an exact row max
  and sum (no online softmax), and the weights rounded to bf16 in registers.
  It is bound by latency (each warp's chain of loads, exps and mma steps),
  far from its bytes bound and from the tensor cores' peak.
- ``mma_sweep`` (bf16, L > 208: ViT-L/14's 257, ViT-L/14@336's 577): the same
  core over tiles of 64 keys, QK^T recomputed in each of three passes (max,
  sum, weights and P.V), so the function stays exact.
- ``f32`` and ``f32_v_global`` (fp32): the CUDA-core bodies (tensor cores would
  take fp32 as TF32), one query row per warp against K and V in shared memory;
  where fp32 K and V exceed a block's shared memory (L = 577) K alone, with V
  read through L2.

Every bf16 mode runs on the tensor cores: K1's int8 core, K2's block mode,
K3f and K8's attention, and the bench arms' modes. FiT's space kernel (K5, K4
space) runs the same core on bf16 with a loader of its own (the global row
then the group rows).

The backward (``attention_bwd.cu``) runs one of three bodies, picked by
``backward_body`` from (dtype, L, head_dim) alone; the kernel entry refuses
any other:

- ``mma`` (bf16, any L whose q_s, g and statistics fit a block: up to 848 at
  head_dim 64): the tensor-core kernels of ``csrc/attention_bwd_mma.cuh``. A
  rows kernel (64 query rows a block, K and V in shared memory once) takes
  each row's peak, denominator and inner = rowsum(dW W32) and dQ; a columns
  kernel (64 keys a block, q_s and g of the rows that see them in shared
  memory) takes dK and dV from those statistics. Every product is an
  ``mma.sync``; no atomics, so two launches give the same bits.
  ``mma_global`` past that reads V and g through L2.
- ``f32`` and ``f32_global`` (fp32): the same two-kernel split on the CUDA
  cores, one query row or one key per warp against the head's two transposed
  operands in shared memory; where they exceed a block's shared memory (past
  L = 395 at head_dim 64) the first alone, with V and g read through L2.

head_dim is 32 or 64 (ViT-S/16's and every other preset's); the FiT kernels
take 64, FiT base's.

K5 and K6 are forward only, as in the reference ("Forward only (inference
paths)"): on CUDA they raise when autograd would need their gradient.

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

_QKV, _INT8, _BLOCK = 0, 1, 2  # csrc/attention.cu modes

HEAD_DIMS = (32, 64)  # attention.cu and attention_bwd.cu: ViT-S/16's and every other preset's
HEAD_DIM = 64  # fit_attention.cu's: FiT base's
SMEM_LIMIT = 232448  # shared memory a block can use on an H100
# attention.cu's bodies (its Body codes) and the bf16 length past which the
# logits no longer stay in registers (attention_mma.cuh: kResidentKeys).
BODIES = {"mma": 0, "mma_sweep": 1, "f32": 2, "f32_v_global": 3}
BACKWARD_BODIES = {"mma": 0, "mma_global": 1, "f32": 2, "f32_global": 3}  # attention_bwd.cu's
MMA_RESIDENT_KEYS = 208
_F32_WARPS = 8  # the fp32 bodies' warps per block (attention.cu, attention_bwd.cu)
MAX_FRAMES = 16  # the time kernel keeps each location's frames in registers


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


def _mma_smem_bytes(seq: int, head_dim: int) -> int:
    """The mma bodies' shared memory: K and V, ceil(L / 16) * 16 rows of bf16."""
    return 2 * 2 * (-(-seq // 16) * 16) * head_dim


def _f32_smem_bytes(seq: int, head_dim: int, v_global: bool) -> int:
    """The fp32 bodies': K^T, V (unless read through L2) and the row buffers."""
    lp = seq + (seq & 1)
    align = lambda n: -(-n // 16) * 16  # noqa: E731
    return (align(4 * head_dim * lp) + (0 if v_global else align(4 * seq * head_dim))
            + 4 * _F32_WARPS * lp)


def attention_body(dtype: torch.dtype, seq: int, head_dim: int) -> str:
    """The body of ``csrc/attention.cu`` that takes (dtype, L, head_dim): bf16
    runs on the tensor cores ("mma", or "mma_sweep" past MMA_RESIDENT_KEYS),
    fp32 on the CUDA cores ("f32", or "f32_v_global" where K and V overflow a
    block's shared memory). Raises where no body takes the shape. The kernel
    entry holds its launch to the same rule (``fitclip_attention_body``)."""
    if head_dim not in HEAD_DIMS or seq < 1:
        raise ValueError(f"the attention kernels take head_dim {HEAD_DIMS} and L >= 1, got "
                         f"head_dim {head_dim}, L {seq}")
    if dtype == torch.bfloat16:
        smem = _mma_smem_bytes(seq, head_dim)
        if smem <= SMEM_LIMIT:
            return "mma" if seq <= MMA_RESIDENT_KEYS else "mma_sweep"
    elif dtype == torch.float32:
        if _f32_smem_bytes(seq, head_dim, False) <= SMEM_LIMIT:
            return "f32"
        smem = _f32_smem_bytes(seq, head_dim, True)
        if head_dim == 64 and smem <= SMEM_LIMIT:
            return "f32_v_global"
    else:
        raise TypeError(f"the attention kernels take float32 or bfloat16, not {dtype}")
    raise ValueError(f"sequence length {seq} at head_dim {head_dim} in {dtype} needs {smem} "
                     f"bytes of shared memory per block; an H100 block has {SMEM_LIMIT}")


def _launch(qkv, heads, scale, causal, seq_valid, out, mode, out_mul):
    _build.check_cuda_operand("qkv", qkv, ndim=3)
    _build.check_cuda_operand("out", out, ndim=3)
    batch, seq, _ = qkv.shape
    head_dim = _check_head_dim(qkv, heads)
    body = BODIES[attention_body(qkv.dtype, seq, head_dim)]
    valid = seq if seq_valid is None else min(int(seq_valid), seq)
    if valid < 1:
        raise ValueError(f"seq_valid must be >= 1, got {seq_valid}")
    _build.call("fitclip_attention", qkv.data_ptr(), _build.dtype_code(qkv.dtype), out.data_ptr(),
                mode, batch, seq, heads, head_dim, float(scale), int(causal), valid,
                float(out_mul), body)


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


def _check_head_dim(qkv, heads, head_dims=HEAD_DIMS):
    batch, seq, triple = qkv.shape
    head_dim = triple // 3 // heads
    if head_dim not in head_dims or triple != 3 * heads * head_dim:
        raise ValueError(f"the attention kernels take head_dim {' or '.join(map(str, head_dims))}; "
                         f"got (B, L, 3*H*D) = {tuple(qkv.shape)} with {heads} heads")
    return head_dim


def backward_smem_bytes(seq: int, head_dim: int, body: str) -> int:
    """Shared memory per block of a body of ``csrc/attention_bwd.cu`` at (L,
    head_dim), the larger of its two kernels'. mma: q_s and g (q_s alone where
    g is read through L2), ceil(L / 16) * 16 rows of bf16, and four fp32
    statistics per row. f32: two transposed fp32 operands at an odd pitch (the
    first alone where the second is read through L2), three statistics and
    two row buffers per warp."""
    if body in ("mma", "mma_global"):
        rows = -(-seq // 16) * 16
        return (1 if body == "mma_global" else 2) * 2 * rows * head_dim + 4 * 4 * rows
    if body in ("f32", "f32_global"):
        lp = seq | 1
        operand = -(-4 * head_dim * lp // 16) * 16
        return ((1 if body == "f32_global" else 2) * operand + 4 * 3 * lp
                + 4 * 2 * _F32_WARPS * lp)
    raise ValueError(f"no backward body {body!r}; the bodies are {sorted(BACKWARD_BODIES)}")


def backward_body(dtype: torch.dtype, seq: int, head_dim: int) -> str:
    """The body of ``csrc/attention_bwd.cu`` that takes (dtype, L, head_dim): bf16
    runs the tensor-core kernels, fp32 the CUDA-core ones; each reads its second
    operand (V and g) through L2 where both overflow a block's shared memory
    ("mma" or "mma_global", "f32" or "f32_global"). Raises where no body takes
    the shape. The kernel entry holds its launch to the same rule
    (``fitclip_attention_bwd_body``)."""
    if head_dim not in HEAD_DIMS or seq < 1:
        raise ValueError(f"the attention backward takes head_dim {HEAD_DIMS} and L >= 1, got "
                         f"head_dim {head_dim}, L {seq}")
    if dtype == torch.bfloat16:
        candidates = ("mma", "mma_global")
    elif dtype == torch.float32:
        candidates = ("f32", "f32_global")
    else:
        raise TypeError(f"the attention backward takes float32 or bfloat16, not {dtype}")
    for body in candidates:
        smem = backward_smem_bytes(seq, head_dim, body)
        if smem <= SMEM_LIMIT:
            return body
    raise ValueError(f"the attention backward at sequence length {seq}, head_dim {head_dim} in "
                     f"{dtype} needs {smem} bytes of shared memory per block; an H100 block "
                     f"has {SMEM_LIMIT}")


@torch.library.custom_op("fitclip::fused_attention_qkv", mutates_args=())
def _forward_op(qkv: torch.Tensor, heads: int, scale: float, causal: bool) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return attention_core_plain(qkv, heads, scale, causal)
    batch, seq, triple = qkv.shape
    out = torch.empty(batch, seq, triple // 3, dtype=qkv.dtype, device=qkv.device)
    _launch(qkv, heads, scale, causal, None, out, _QKV, 0.0)
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
    body = BACKWARD_BODIES[backward_body(qkv.dtype, seq, head_dim)]
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(3, batch, heads, seq, dtype=torch.float32, device=qkv.device)
    _build.call("fitclip_attention_bwd", qkv.data_ptr(), grad_out.data_ptr(),
                _build.dtype_code(qkv.dtype), dqkv.data_ptr(), stats.data_ptr(), batch, seq,
                heads, head_dim, float(scale), int(causal), body)
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
    _launch(qkv, heads, scale, causal, seq_valid, out, _INT8, out_mul)
    attention_int8.launches += 1
    return out


attention_int8.launches = 0


def attention_block_plain(qkv, heads, scale, causal, seq_valid=None):
    return attention_core_plain(qkv, heads, scale, causal, 1.0, seq_valid)


def attention_block(qkv: torch.Tensor, heads: int, scale: float, causal: bool,
                    seq_valid: Optional[int] = None) -> torch.Tensor:
    """(B, L, 3*H*D) -> (B, L, H*D) in qkv's dtype: the attention core of
    ``fitclip_tpu/ops/block.py:_bf16_layer_kernel`` (K2), weights
    exps * (1 / denom). seq_valid masks the keys at and past it."""
    if qkv.device.type == "cpu":
        return attention_block_plain(qkv, heads, scale, causal, seq_valid)
    batch, seq, triple = qkv.shape
    out = torch.empty(batch, seq, triple // 3, dtype=qkv.dtype, device=qkv.device)
    _launch(qkv, heads, scale, causal, seq_valid, out, _BLOCK, 1.0)
    attention_block.launches += 1
    return out


attention_block.launches = 0


def fused_int8_qkv_attention_plain(x_q, weight_q, out_scale, bias, heads, scale, causal=False,
                                   out_dtype=torch.bfloat16):
    from fitclip_torch.ops.block import int8_gemm_bias_plain  # block.py imports this module

    batch, seq, width = x_q.shape
    qkv = int8_gemm_bias_plain(x_q.reshape(batch * seq, width), weight_q, out_scale, bias,
                               out_dtype)
    return attention_core_plain(qkv.view(batch, seq, -1), heads, scale, causal)


def fused_int8_qkv_attention(x_q: torch.Tensor, weight_q: torch.Tensor, out_scale: torch.Tensor,
                             bias: torch.Tensor, heads: int, scale: float, causal: bool = False,
                             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K8: int8 x_q (B, L, W), int8 weight_q (3W, W), fp32 out_scale and bias
    (3W,) -> the attention output (B, L, W) in out_dtype. qkv = (acc * out_scale
    + bias) cast to out_dtype, then the qkv-mode softmax (weights exps / denom).
    Replaces ``fitclip_tpu/ops/attention.py:fused_int8_qkv_attention``
    (``_int8_qkv_attention_kernel``); one launch count per call."""
    if x_q.device.type == "cpu":
        return fused_int8_qkv_attention_plain(x_q, weight_q, out_scale, bias, heads, scale,
                                              causal, out_dtype)
    from fitclip_torch.ops import block  # block.py imports this module

    _build.check_cuda_operand("x_q", x_q, torch.int8, 3)
    batch, seq, width = x_q.shape
    qkv = torch.empty(batch, seq, weight_q.shape[0], dtype=out_dtype, device=x_q.device)
    # K1's GEMM with the bias epilogue, counted under K8 alone.
    block._gemm(x_q.view(batch * seq, width), weight_q, out_scale, bias, block._BIAS,
                qkv.view(batch * seq, -1))
    out = torch.empty(batch, seq, width, dtype=out_dtype, device=x_q.device)
    _launch(qkv, heads, scale, causal, None, out, _QKV, 0.0)
    fused_int8_qkv_attention.launches += 1
    return out


fused_int8_qkv_attention.launches = 0


# --- Frozen-in-Time: divided attention with a global row (csrc/fit_attention.cu) ---
#
# K5 (space, float), K6 (time, float) and the three int8 attention launches of
# K4's SpaceTimeBlock. The global row is the clip's CLS qkv: a separate (G, 3W)
# or (B, 3W) gkv for K5 and K6, row 0 of the joint (B, 1 + F * P, 3W) qkv for
# K4, whose int8 outputs land in the rows of one (B, 1 + F * P, W) buffer.

def _attend_plain(q, k, v, out_mul: Optional[float]) -> torch.Tensor:
    """q (.., Sq, D), k/v (.., Sk, D) -> fp32 (.., Sq, D): fp32 logits and
    softmax, weights exps / denom (or exps * (out_mul / denom)) cast to v's
    dtype, P.V in fp32."""
    logits = q.float() @ k.float().transpose(-1, -2)
    peak = logits.amax(dim=-1, keepdim=True)
    exps = torch.exp(logits - peak)
    denom = exps.sum(dim=-1, keepdim=True)
    weights = exps / denom if out_mul is None else exps * (out_mul / denom)
    return weights.to(v.dtype).float() @ v.float()


def attention_gkv_plain(qkv: torch.Tensor, gkv: torch.Tensor, heads: int, scale: float,
                        out_mul: Optional[float] = None,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version of the space kernel: each of G groups' L rows attends
    over [gkv's key/value | the group's L rows] (``_packed_gkv_kernel``; with
    out_mul, K4's space attention). q is scaled in qkv's dtype."""
    groups, seq, triple = qkv.shape
    width = triple // 3
    head_dim = width // heads

    def split(t):
        return t.reshape(groups, -1, heads, head_dim).transpose(1, 2)

    kv = torch.cat([gkv.reshape(groups, 1, triple), qkv], dim=1)
    q = split(qkv[..., :width] * torch.tensor(scale, dtype=qkv.dtype, device=qkv.device))
    out = _attend_plain(q, split(kv[..., width:2 * width]), split(kv[..., 2 * width:]), out_mul)
    return out.transpose(1, 2).reshape(groups, seq, width).to(out_dtype or qkv.dtype)


def time_attention_plain(qkv: torch.Tensor, gkv: torch.Tensor, heads: int, frames: int,
                         scale: float, out_mul: Optional[float] = None,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version of the time kernel (``_time_attention_kernel``; with
    out_mul, K4's time attention): over (B, F * P, 3W) rows, location p of
    frame f attends over [gkv | location p of every frame]. q is scaled in
    fp32 and the weights, exps * (out_mul / denom), stay fp32."""
    batch, n, triple = qkv.shape
    width = triple // 3
    head_dim = width // heads

    def split(t):
        return t.reshape(batch, frames, n // frames, heads, head_dim).float()

    q = split(qkv[..., :width]) * scale
    k, v = split(qkv[..., width:2 * width]), split(qkv[..., 2 * width:])
    g_k, g_v = (gkv[:, None, None, off:off + width].reshape(batch, 1, 1, heads, head_dim).float()
                for off in (width, 2 * width))
    logits = torch.cat([(q * g_k).sum(-1, keepdim=True),
                        torch.einsum("bfphd,bgphd->bfphg", q, k)], dim=-1)
    exps = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    weights = exps * ((1.0 if out_mul is None else out_mul) / exps.sum(dim=-1, keepdim=True))
    out = weights[..., :1] * g_v + torch.einsum("bfphg,bgphd->bfphd", weights[..., 1:], v)
    return out.reshape(batch, n, width).to(out_dtype or qkv.dtype)


def cls_attention_plain(qkv: torch.Tensor, heads: int, scale: float,
                        out_mul: float) -> torch.Tensor:
    """The plain version of the cls kernel, fp32 (B, 1, W): row 0's attention
    over all N rows of (B, N, 3W), out_mul folded into the normalizer (K4's
    global CLS row); q is scaled in qkv's dtype."""
    batch, n, triple = qkv.shape
    width = triple // 3
    head_dim = width // heads

    def split(t):
        return t.reshape(batch, -1, heads, head_dim).transpose(1, 2)

    q = split(qkv[:, :1, :width] * torch.tensor(scale, dtype=qkv.dtype, device=qkv.device))
    out = _attend_plain(q, split(qkv[..., width:2 * width]), split(qkv[..., 2 * width:]), out_mul)
    return out.transpose(1, 2).reshape(batch, 1, width)


def _fit_check(qkv, heads, frames=1):
    _build.check_cuda_operand("qkv", qkv, ndim=3)
    _check_head_dim(qkv, heads, (HEAD_DIM,))
    if not 1 <= frames <= MAX_FRAMES:
        raise ValueError(f"the time kernel takes 1 to {MAX_FRAMES} frames, got {frames}")


def _fit_launch(name, qkv, qkv_row, gkv_ptr, gkv_stride, out, out_row, int8_out, count, frames,
                patches, heads, scale, out_mul):
    """Launch the space or time kernel. Clip c's rows start at qkv row qkv_row
    and out row out_row of clip c; strides are in elements."""
    _, n, triple = qkv.shape
    out_n, width = out.shape[1], out.shape[2]
    _build.call(name, qkv.data_ptr() + qkv_row * triple * qkv.element_size(), n * triple,
                gkv_ptr, gkv_stride, _build.dtype_code(qkv.dtype),
                out.data_ptr() + out_row * width * out.element_size(), out_n * width,
                int(int8_out), count, frames, patches, heads, HEAD_DIM, float(scale),
                float(out_mul))


def _check_space_smem(qkv, patches):
    smem = _build.library().fitclip_fit_space_smem_bytes(_build.dtype_code(qkv.dtype), patches)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{patches} rows per group need {smem} bytes of shared memory per "
                         f"block; an H100 block has {SMEM_LIMIT}")


def _refuse_gradient(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward only, as in the reference (its kernel has no "
                           "backward): call it under torch.no_grad(), or train through the "
                           "module path with fused_attention=False")


def _check_gkv(gkv, qkv):
    _build.check_cuda_operand("gkv", gkv, qkv.dtype, 2)
    if gkv.shape != (qkv.shape[0], qkv.shape[2]):
        raise ValueError(f"gkv must be {(qkv.shape[0], qkv.shape[2])}, got {tuple(gkv.shape)}")


def fused_attention_qkv_gkv(qkv: torch.Tensor, gkv: torch.Tensor, heads: int,
                            scale: float) -> torch.Tensor:
    """K5: (G, L, 3*H*D) groups and one global (G, 3*H*D) qkv row each ->
    (G, L, H*D) in qkv's dtype; softmax over [global | group]. Replaces
    ``fitclip_tpu/ops/attention.py:fused_attention_qkv_gkv``
    (``_packed_gkv_kernel``). Forward only."""
    if qkv.device.type == "cpu":
        return attention_gkv_plain(qkv, gkv, heads, scale)
    _refuse_gradient("fused_attention_qkv_gkv (K5)", qkv, gkv)
    _fit_check(qkv, heads)
    _check_gkv(gkv, qkv)
    groups, seq, triple = qkv.shape
    _check_space_smem(qkv, seq)
    out = torch.empty(groups, seq, triple // 3, dtype=qkv.dtype, device=qkv.device)
    _fit_launch("fitclip_fit_space_attention", qkv, 0, gkv.data_ptr(), triple, out, 0, False,
                groups, 1, seq, heads, scale, 1.0)
    fused_attention_qkv_gkv.launches += 1
    return out


fused_attention_qkv_gkv.launches = 0


def fused_time_attention(qkv: torch.Tensor, gkv: torch.Tensor, heads: int, frames: int,
                         scale: float) -> torch.Tensor:
    """K6: divided time attention over (B, F*P, 3*H*D) rows with one global
    (B, 3*H*D) row per clip -> (B, F*P, H*D) in qkv's dtype. Replaces
    ``fitclip_tpu/ops/attention.py:fused_time_attention``
    (``_time_attention_kernel``). Forward only."""
    if qkv.device.type == "cpu":
        return time_attention_plain(qkv, gkv, heads, frames, scale)
    _refuse_gradient("fused_time_attention (K6)", qkv, gkv)
    _fit_check(qkv, heads, frames)
    _check_gkv(gkv, qkv)
    batch, n, triple = qkv.shape
    if n % frames:
        raise ValueError(f"qkv rows {n} are not {frames} frames x P")
    out = torch.empty(batch, n, triple // 3, dtype=qkv.dtype, device=qkv.device)
    _fit_launch("fitclip_fit_time_attention", qkv, 0, gkv.data_ptr(), triple, out, 0, False,
                batch, frames, n // frames, heads, scale, 1.0)
    fused_time_attention.launches += 1
    return out


fused_time_attention.launches = 0


def _joint_out(qkv, out):
    batch, n, triple = qkv.shape
    if out is None:
        out = torch.zeros(batch, n, triple // 3, dtype=torch.int8, device=qkv.device)
    if out.shape != (batch, n, triple // 3) or out.dtype != torch.int8:
        raise ValueError(f"out must be int8 {(batch, n, triple // 3)}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    return out


def fit_rows_attention_int8_plain(qkv, heads, frames, mode, out_mul) -> torch.Tensor:
    """K4's time or space attention of the patch rows of the joint
    (B, 1 + F*P, 3W) qkv, fp32 (B, F*P, W) before rounding."""
    batch, n, triple = qkv.shape
    patches = (n - 1) // frames
    scale = (triple // 3 // heads) ** -0.5
    rows, gkv = qkv[:, 1:], qkv[:, 0]
    if mode == "time":
        return time_attention_plain(rows, gkv, heads, frames, scale, out_mul, torch.float32)
    out = attention_gkv_plain(rows.reshape(batch * frames, patches, triple),
                              gkv.repeat_interleave(frames, dim=0), heads, scale, out_mul,
                              torch.float32)
    return out.reshape(batch, n - 1, triple // 3)


def fit_time_attention_int8(qkv: torch.Tensor, heads: int, frames: int, out_mul: float,
                            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4's time attention on the joint (B, 1 + F*P, 3W) qkv (global row 0):
    writes rows 1.. of the int8 (B, 1 + F*P, W) ``out`` and returns it."""
    return _fit_rows_int8(qkv, heads, frames, out_mul, out, "time")


def fit_space_attention_int8(qkv: torch.Tensor, heads: int, frames: int, out_mul: float,
                             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4's space attention on the joint (B, 1 + F*P, 3W) qkv (global row 0):
    writes rows 1.. of the int8 (B, 1 + F*P, W) ``out`` and returns it."""
    return _fit_rows_int8(qkv, heads, frames, out_mul, out, "space")


def _fit_rows_int8(qkv, heads, frames, out_mul, out, mode):
    wrapper = fit_time_attention_int8 if mode == "time" else fit_space_attention_int8
    out = _joint_out(qkv, out)
    if qkv.device.type == "cpu":
        out[:, 1:] = quantize_rint(fit_rows_attention_int8_plain(qkv, heads, frames, mode,
                                                                 out_mul))
        return out
    _fit_check(qkv, heads, frames if mode == "time" else 1)
    _build.check_cuda_operand("out", out, torch.int8, 3)
    batch, n, triple = qkv.shape
    patches = (n - 1) // frames
    if patches * frames != n - 1:
        raise ValueError(f"qkv rows {n} are not 1 + {frames} frames x P")
    scale = (triple // 3 // heads) ** -0.5
    if mode == "time":
        _fit_launch("fitclip_fit_time_attention", qkv, 1, qkv.data_ptr(), n * triple, out, 1,
                    True, batch, frames, patches, heads, scale, out_mul)
    else:
        _check_space_smem(qkv, patches)
        _fit_launch("fitclip_fit_space_attention", qkv, 1, qkv.data_ptr(), n * triple, out, 1,
                    True, batch * frames, frames, patches, heads, scale, out_mul)
    wrapper.launches += 1
    return out


fit_time_attention_int8.launches = 0
fit_space_attention_int8.launches = 0


def fit_cls_attention_int8(qkv: torch.Tensor, heads: int, out_mul: float,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4's global CLS row: row 0 of the joint (B, N, 3W) qkv attends over all
    N rows; writes row 0 of the int8 (B, N, W) ``out`` and returns it."""
    out = _joint_out(qkv, out)
    scale = (qkv.shape[2] // 3 // heads) ** -0.5
    if qkv.device.type == "cpu":
        out[:, :1] = quantize_rint(cls_attention_plain(qkv, heads, scale, out_mul))
        return out
    _fit_check(qkv, heads)
    _build.check_cuda_operand("out", out, torch.int8, 3)
    batch, n, triple = qkv.shape
    smem = _build.library().fitclip_fit_cls_smem_bytes(n)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{n} keys need {smem} bytes of shared memory per block; an H100 "
                         f"block has {SMEM_LIMIT}")
    _build.call("fitclip_fit_cls_attention", qkv.data_ptr(), _build.dtype_code(qkv.dtype),
                out.data_ptr(), n * (triple // 3), batch, n, heads, HEAD_DIM, float(scale),
                float(out_mul))
    fit_cls_attention_int8.launches += 1
    return out


fit_cls_attention_int8.launches = 0
