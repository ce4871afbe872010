"""S3D-G (the MIL-NCE video tower) and the MIL-NCE text tower in PyTorch: port of
``fitclip_tpu/models/s3dg.py``.

The module path, the fp32 oracle that the fast eval forward (``s3dg_fast.py``)
is held against: space-to-depth stem, separable spatio-temporal convs, Inception
blocks with self-gating, TF-'SAME' max pools with ceil semantics, global mean and
FC. The public layout is NDHWC, as in the JAX package; a (B, C, T, H, W) view of
an NDHWC tensor is channels_last_3d, so cuDNN runs the convs without transposes.
Parameter names and layouts mirror the JAX tree (``conv1.conv1.kernel`` is
THWIO, dense kernels are (in, out), BatchNorm keeps torch's names), so the
converter only renames. ``int8_from`` gives the module the int8 sites of
``s3dg_fast.quantize_s3dg_fast`` under ``int8`` (the fast forward runs them).
"""

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fitclip_torch.models.clip.model import QuantDense
from fitclip_torch.ops.s3dg_stem import BN_EPS, space_to_depth

Size3 = Union[int, Tuple[int, int, int]]

# Each Inception block: (input width, b0, b1a, b1b, b2a, b2b, b3b).
BLOCKS = {
    "mixed_3b": (192, 64, 96, 128, 16, 32, 32),
    "mixed_3c": (256, 128, 128, 192, 32, 96, 64),
    "mixed_4b": (480, 192, 96, 208, 16, 48, 64),
    "mixed_4c": (512, 160, 112, 224, 24, 64, 64),
    "mixed_4d": (512, 128, 128, 256, 24, 64, 64),
    "mixed_4e": (512, 112, 144, 288, 32, 64, 64),
    "mixed_4f": (528, 256, 160, 320, 32, 128, 128),
    "mixed_5b": (832, 256, 160, 320, 32, 128, 128),
    "mixed_5c": (832, 384, 192, 384, 48, 128, 128),
}
FEATURES = 1024  # mixed_5c's output width


def triple(value: Size3) -> Tuple[int, int, int]:
    return (value, value, value) if isinstance(value, int) else tuple(value)


def conv3d_ndhwc(x: torch.Tensor, kernel: torch.Tensor, stride: Size3 = 1,
                 padding: Size3 = 0) -> torch.Tensor:
    """NDHWC x and a THWIO kernel -> NDHWC output, computed in x's dtype."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), kernel.to(x.dtype).permute(4, 3, 0, 1, 2),
                 stride=triple(stride), padding=triple(padding))
    return y.permute(0, 2, 3, 4, 1)


def max_pool_3d_tf_padding(x: torch.Tensor, kernel_size: Size3, stride: Size3) -> torch.Tensor:
    """TF-'SAME' zero padding, then -max padding for ceil-mode window placement,
    then a max pool, on NDHWC x (fitclip_tpu/models/s3dg.py:98-120)."""
    k, s = triple(kernel_size), triple(stride)
    zero_pads, ceil_pads = [], []
    for size, kd, sd in zip(x.shape[1:4], k, s):
        total = max(kd - sd, 0)
        lo, hi = total // 2, total - total // 2
        padded = size + lo + hi
        out = -(-(padded - kd) // sd) + 1
        zero_pads.append((lo, hi))
        ceil_pads.append((0, max((out - 1) * sd + kd - padded, 0)))

    def pad_arg(pads):  # F.pad takes the last dimension first: C, W, H, T
        return (0, 0, *pads[2], *pads[1], *pads[0])

    x = F.pad(x, pad_arg(zero_pads))
    if any(hi for _, hi in ceil_pads):
        x = F.pad(x, pad_arg(ceil_pads), value=torch.finfo(x.dtype).min)
    # The max over time as strided slices, then over (H, W) as a channels-last 2-D
    # pool: PyTorch's 3-D pool on the card has no channels-last kernel and would
    # copy the activation to NCDHW and back.
    t_out = (x.shape[1] - k[0]) // s[0] + 1
    y = x[:, :(t_out - 1) * s[0] + 1:s[0]]
    for dt in range(1, k[0]):
        y = torch.maximum(y, x[:, dt:dt + (t_out - 1) * s[0] + 1:s[0]])
    b, t, h, w, c = y.shape
    y = F.max_pool2d(y.reshape(b * t, h, w, c).permute(0, 3, 1, 2), k[1:], s[1:])
    return y.permute(0, 2, 3, 1).reshape(b, t, y.shape[2], y.shape[3], c)


class Conv3d(nn.Module):
    """A bias-free conv with a THWIO ``kernel``, the JAX layout."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: Size3):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(*triple(kernel_size), in_dim, out_dim))


class Linear(nn.Module):
    """A dense with an (in, out) ``kernel``, the JAX layout."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class BatchNorm3dInference(nn.Module):
    """Frozen-statistics BatchNorm (eps 1e-5): the affine is derived in fp32 and
    cast to the activation dtype."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return x * inv.to(x.dtype) + (self.bias - self.running_mean * inv).to(x.dtype)


class STConv3D(nn.Module):
    """Conv3D (+BN+ReLU), optionally factored into a spatial (1, k, k) and a
    temporal (k, 1, 1) conv, each with its own BN and ReLU."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: Size3, stride: Size3 = 1,
                 padding: Size3 = 0, separable: bool = False):
        super().__init__()
        k = triple(kernel_size)
        self.stride, self.padding, self.separable = triple(stride), triple(padding), separable
        self.conv1 = Conv3d(in_dim, out_dim, (1, k[1], k[2]) if separable else k)
        self.bn1 = BatchNorm3dInference(out_dim)
        if separable:
            self.conv2 = Conv3d(out_dim, out_dim, (k[0], 1, 1))
            self.bn2 = BatchNorm3dInference(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, p = self.stride, self.padding
        if not self.separable:
            return torch.relu(self.bn1(conv3d_ndhwc(x, self.conv1.kernel, s, p)))
        x = torch.relu(self.bn1(conv3d_ndhwc(x, self.conv1.kernel, (1, s[1], s[2]),
                                             (0, p[1], p[2]))))
        return torch.relu(self.bn2(conv3d_ndhwc(x, self.conv2.kernel, (s[0], 1, 1),
                                                (p[0], 0, 0))))


class SelfGating(nn.Module):
    """x * sigmoid(fc(mean over T, H, W)); the mean accumulates in fp32 and is cast
    to x's dtype before the FC."""

    def __init__(self, features: int):
        super().__init__()
        self.fc = Linear(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.float().mean(dim=(1, 2, 3)).to(x.dtype)
        return x * torch.sigmoid(self.fc(pooled))[:, None, None, None, :].to(x.dtype)


class InceptionBlock(nn.Module):
    """Four branches (1x1x1; 1x1x1 then separable 3x3x3, twice; 3x3x3 max pool
    then 1x1x1), each self-gated, concatenated on channels."""

    def __init__(self, in_dim: int, b0: int, b1a: int, b1b: int, b2a: int, b2b: int, b3b: int):
        super().__init__()
        self.widths = (b0, b1a, b1b, b2a, b2b, b3b)
        self.conv_b0 = STConv3D(in_dim, b0, 1)
        self.conv_b1_a = STConv3D(in_dim, b1a, 1)
        self.conv_b1_b = STConv3D(b1a, b1b, 3, padding=1, separable=True)
        self.conv_b2_a = STConv3D(in_dim, b2a, 1)
        self.conv_b2_b = STConv3D(b2a, b2b, 3, padding=1, separable=True)
        self.conv_b3_b = STConv3D(in_dim, b3b, 1)
        for i, width in enumerate((b0, b1b, b2b, b3b)):
            setattr(self, f"gating_b{i}", SelfGating(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.conv_b0(x),
                    self.conv_b1_b(self.conv_b1_a(x)),
                    self.conv_b2_b(self.conv_b2_a(x)),
                    self.conv_b3_b(max_pool_3d_tf_padding(x, 3, 1))]
        return torch.cat([getattr(self, f"gating_b{i}")(b) for i, b in enumerate(branches)],
                         dim=-1)


def int8_site_names(from_block: Optional[str]):
    """The int8 sites of quantize_s3dg_fast, as {path: (in, out)}: conv_2b when
    every site is quantized (``from_block`` None or "conv_2b"), then each block's
    merged branch stems and b3 conv from ``from_block`` on, and the FC."""
    names = list(BLOCKS)
    start = 0 if from_block in (None, "conv_2b") else names.index(from_block)
    sites = {"conv_2b": (64, 64)} if start == 0 else {}
    for name in names[start:]:
        in_dim, b0, b1a, _, b2a, _, b3b = BLOCKS[name]
        sites[f"{name}/merged"] = (in_dim, b0 + b1a + b2a)
        sites[f"{name}/b3"] = (in_dim, b3b)
    sites["fc"] = (FEATURES, 512)
    return sites


class S3DG(nn.Module):
    """The S3D-G backbone: (B, T, H, W, 3) -> (B, 512) (or (B, 1024) without the
    last layer), computed in ``dtype``."""

    def __init__(self, embedding_size: int = 512, use_space_to_depth: bool = True,
                 use_last_layer: bool = True, dtype: torch.dtype = torch.float32,
                 int8_from: Union[str, None, bool] = False):
        super().__init__()
        if embedding_size != 512 and int8_from is not False:
            raise ValueError("the int8 sites are laid out for a 512-d embedding")
        self.dtype, self.use_space_to_depth = dtype, use_space_to_depth
        self.use_last_layer = use_last_layer
        if use_space_to_depth:
            self.conv1 = STConv3D(24, 64, (2, 4, 4), stride=1, padding=(1, 2, 2))
        else:
            self.conv1 = STConv3D(3, 64, (3, 7, 7), stride=2, padding=(1, 3, 3))
        self.conv_2b = STConv3D(64, 64, 1)
        self.conv_2c = STConv3D(64, 192, 3, padding=1, separable=True)
        self.gating = SelfGating(192)
        for name, widths in BLOCKS.items():
            setattr(self, name, InceptionBlock(*widths))
        self.fc = Linear(FEATURES, embedding_size)
        self.int8 = nn.ModuleDict()
        if int8_from is not False:  # False: no int8 sites; None: every site
            for path, (in_dim, out_dim) in int8_site_names(int8_from).items():
                node = self.int8
                *parents, leaf = path.split("/")
                for part in parents:
                    if part not in node:
                        node[part] = nn.ModuleDict()
                    node = node[part]
                node[leaf] = QuantDense(in_dim, out_dim, dtype)

    @property
    def quantized(self) -> bool:
        return len(self.int8) > 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.use_space_to_depth:
            x = self.conv1(space_to_depth(x))[:, 1:, 1:, 1:, :]
        else:
            x = self.conv1(x)
        x = max_pool_3d_tf_padding(x, (1, 3, 3), (1, 2, 2))
        x = self.gating(self.conv_2c(self.conv_2b(x)))
        x = max_pool_3d_tf_padding(x, (1, 3, 3), (1, 2, 2))
        x = self.mixed_3c(self.mixed_3b(x))
        x = max_pool_3d_tf_padding(x, 3, 2)
        for name in ("mixed_4b", "mixed_4c", "mixed_4d", "mixed_4e", "mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_3d_tf_padding(x, 2, 2)
        x = self.mixed_5c(self.mixed_5b(x))
        x = x.float().mean(dim=(1, 2, 3)).to(self.dtype)
        return self.fc(x) if self.use_last_layer else x


class MilNceTextEncoder(nn.Module):
    """Word-embedding text tower: embed -> FC -> ReLU -> max over tokens -> FC, fp32."""

    def __init__(self, output_size: int = 512, vocab_size: int = 66250,
                 word_embedding_size: int = 300, hidden_size: int = 2048):
        super().__init__()
        self.word_embd = nn.Parameter(torch.zeros(vocab_size, word_embedding_size))
        self.fc1 = Linear(word_embedding_size, hidden_size)
        self.fc2 = Linear(hidden_size, output_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc1(self.word_embd[input_ids]))
        return self.fc2(x.amax(dim=1))


def nest(flat) -> dict:
    """{"a.b.c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    tree: dict = {}
    for name, value in flat.items():
        *parents, leaf = name.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def init_s3dg_params(seed: int = 0, use_space_to_depth: bool = True) -> dict:
    """A seeded S3DG tree in the JAX layout (numpy): conv and dense kernels from
    normal(2 / sqrt(fan_in)), zero biases, BatchNorm scales at one, running means
    from normal(0.1) and running variances from 1 + uniform[0, 0.5). The running
    statistics keep the embedding from vanishing; the kernels' scale, twice
    LeCun's, keeps it input-dependent through the gated ReLU layers (with LeCun's,
    two different clips embed within 1e-6 of each other)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, value in S3DG(use_space_to_depth=use_space_to_depth).state_dict().items():
        shape, leaf = tuple(value.shape), name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = math.prod(shape[:-1])
            flat[name] = rng.standard_normal(shape, np.float32) * np.float32(2.0 / math.sqrt(fan_in))
        elif leaf == "running_mean":
            flat[name] = (rng.normal(size=shape) * 0.1).astype(np.float32)
        elif leaf == "running_var":
            flat[name] = (1.0 + rng.random(shape) * 0.5).astype(np.float32)
        else:
            flat[name] = np.full(shape, 1.0 if leaf == "weight" else 0.0, np.float32)
    return nest(flat)
