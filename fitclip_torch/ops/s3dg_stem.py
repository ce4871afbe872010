"""The S3D-G space-to-depth stem (port of ``fitclip_tpu/models/s3dg_fast.py:_stem_kernel_path``
over the TPU kernel K7, ``fitclip_tpu/ops/s3dg_stem.py:_stem_kernel_v3``).

For bf16 video x (B, T, H, W, 3), T even and H, W multiples of 4, the stem
computes space_to_depth (channels (t2, h2, w2, c)), the Conv3D (2, 4, 4) 24 -> 64
with the folded BatchNorm (taps t, t+1 and h-1..h+2, w-1..w+2: the reference's
``padding=(1, 2, 2)`` then ``[1:, 1:, 1:]``), fp32 sums plus the fp32 copy of the
bf16 bias, ReLU, and the 3x3 / 2 TF-'SAME' max pool in (H, W), and returns the
pooled (B, T/2, H/4, W/4, 64) NDHWC, rounded to bf16 once.

``s3dg_stem`` launches ``csrc/s3dg_stem.cu`` for a CUDA tensor and takes the
plain version ``s3dg_stem_plain`` for a CPU tensor. The plain version is an fp32
``conv3d`` on the bf16-rounded operands, with cuDNN's TF32 off, then bias, ReLU,
pool and one cast: the kernel's arithmetic, up to the order of its sums. (The
XLA stem that the JAX tests compare with rounds twice, after the conv and after
the bias.)
"""

import torch
import torch.nn.functional as F

from fitclip_torch import _build

BN_EPS = 1e-5
STEM_CHANNELS = 64


def fold_bn(kernel: torch.Tensor, bn, dtype: torch.dtype, eps: float = BN_EPS):
    """BatchNorm folded into the conv before it, in fp32, then cast: kernel * inv
    over its output channels (last axis) and bias = shift, both in ``dtype``
    (copy of ``fitclip_tpu/models/s3dg_fast.py:_bn_affine/_folded``). ``bn`` has
    ``weight``, ``bias``, ``running_mean`` and ``running_var``. The reciprocal
    square root is 1 / sqrt, which rounds alike on the CPU and the card."""
    inv = (1.0 / torch.sqrt(bn.running_var.float() + eps)) * bn.weight.float()
    shift = bn.bias.float() - bn.running_mean.float() * inv
    return (kernel.float() * inv).to(dtype), shift.to(dtype)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T/2, H/2, W/2, 8C), channels ordered (t2, h2, w2, c)."""
    b, t, h, w, c = x.shape
    x = x.reshape(b, t // 2, 2, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, t // 2, h // 2, w // 2, 8 * c)


def pack_stem_weights(kernel: torch.Tensor) -> torch.Tensor:
    """Folded (2, 4, 4, 24, 64) THWIO kernel -> (64, 768) in the kernel's k order:
    raw frame a = 2 dt + t2, raw row r = 2 dh + h2, raw column q = 2 dw + w2, then
    the pixel channel, k = ((a * 8 + r) * 8 + q) * 3 + c."""
    k = kernel.reshape(2, 4, 4, 2, 2, 2, 3, STEM_CHANNELS)  # dt dh dw t2 h2 w2 c n
    return k.permute(7, 0, 3, 1, 4, 2, 5, 6).reshape(STEM_CHANNELS, 768).contiguous()


def _check_video(x: torch.Tensor) -> None:
    if x.dim() != 5 or x.shape[-1] != 3:
        raise ValueError(f"the stem takes (B, T, H, W, 3) video, got {tuple(x.shape)}")
    _, t, h, w, _ = x.shape
    if t % 2 or h % 4 or w % 4:
        raise ValueError(f"the stem needs T even and H, W multiples of 4, got T={t}, H={h}, "
                         f"W={w}")


def s3dg_stem_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The stem in plain PyTorch on any device: the operands rounded to x's dtype,
    fp32 arithmetic, one final cast to x's dtype."""
    _check_video(x)
    s = space_to_depth(x.float()).permute(0, 4, 1, 2, 3)          # NCDHW view
    weight = kernel.to(x.dtype).float().permute(4, 3, 0, 1, 2)  # (64, 24, 2, 4, 4)
    bias = bias.to(x.dtype)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv3d(s, weight, padding=(1, 2, 2))[:, :, 1:, 1:, 1:]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    y = torch.relu(y + bias.float()[:, None, None, None])
    y = F.max_pool3d(F.pad(y, (0, 1, 0, 1)), (1, 3, 3), (1, 2, 2))  # 'SAME' pad, 0 after ReLU
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def s3dg_stem(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """bf16 video (B, T, H, W, 3), the folded bf16 kernel (2, 4, 4, 24, 64) and bias
    (64,) -> the pooled stem (B, T/2, H/4, W/4, 64) bf16, through the Hopper kernel
    (the plain version for a CPU tensor). Raises on shapes the kernel does not take."""
    if x.device.type == "cpu":
        return s3dg_stem_plain(x, kernel, bias)
    _check_video(x)
    b, t, h, w, _ = x.shape
    _build.check_cuda_operand("x", x, torch.bfloat16, 5)
    if tuple(kernel.shape) != (2, 4, 4, 24, STEM_CHANNELS) or bias.shape != (STEM_CHANNELS,):
        raise ValueError(f"the stem kernel is (2, 4, 4, 24, 64) with 64 biases, got "
                         f"{tuple(kernel.shape)} and {tuple(bias.shape)}")
    if _build.library().fitclip_s3dg_stem_smem_bytes(w) == 0:
        raise ValueError(f"the stem kernel takes frames up to 240 pixels wide, got W={w}")
    weights = pack_stem_weights(kernel.to(torch.bfloat16))
    bias32 = bias.to(torch.bfloat16).float().contiguous()
    _build.check_cuda_operand("kernel", weights, torch.bfloat16, 2)
    _build.check_cuda_operand("bias", bias32, torch.float32, 1)
    out = torch.empty(b, t // 2, h // 4, w // 4, STEM_CHANNELS, dtype=torch.bfloat16,
                      device=x.device)
    _build.call("fitclip_s3dg_stem", x.data_ptr(), weights.data_ptr(), bias32.data_ptr(),
                out.data_ptr(), b, t, h, w)
    s3dg_stem.launches += 1
    return out


s3dg_stem.launches = 0
