"""CLIP's ModifiedResNet vision tower (RN50/RN101/RN50x4/x16/x64) in PyTorch:
port of ``fitclip_tpu/models/clip/resnet.py``.

Same math as OpenAI CLIP's ResNet: a 3-conv stem (stride-2 conv + BN + ReLU,
two more conv + BN + ReLU, then avgpool 2), Bottleneck blocks whose strided
convs are conv + avgpool (and avgpool + 1x1 conv + BN in the shortcut), and a
final QKV attention pool over the spatial positions with a mean-token query.

The tower runs NCHW in ``channels_last`` memory (the frames arrive NHWC, and
cuDNN's tensor-core convolutions take NHWC), with OIHW conv weights.
Submodules are named as OpenAI's schema names them (``layer1.0.conv1``,
``layer2.0.downsample.0`` / ``.1``, ``attnpool.q_proj``), so the module's
state dict is that schema under ``visual.``. fp32 convolutions run in full
float32 (``fp32_convolutions``), where the reference uses
``Precision.HIGHEST``; the convolutions and the attention pool's products
are cuDNN and cuBLAS, as the JAX package leaves them to XLA.

BatchNorm has two forms. Without an ``updates`` list it folds the frozen
running statistics (inference). With one, it normalizes with the biased batch
statistics (computed in fp32 over N, H, W, differentiated through) and
appends the momentum EMA of the mean and of the unbiased variance, detached,
to the list; the train step writes them into the running statistics after
the optimizer step (``apply_bn_updates``). Under a process group the batch
statistics are the global batch's (``fitclip_tpu/models/clip/resnet.py:
56-57``): the sums over each rank's rows are all-reduced, so the EMA update is
the same on every rank. The running statistics are
parameters that never require a gradient, as they are leaves of the JAX
params tree: a train-state checkpoint carries them, and the optimizer freezes
them by the encoder's ``bn_freeze_patterns``.
"""

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fitclip_torch.models.clip.model import Dense
from fitclip_torch.parallel import collectives
from fitclip_torch.utils.precision import fp32_convolutions

BNUpdates = List[Tuple["BatchNorm", torch.Tensor, torch.Tensor]]


class BatchNorm(nn.Module):
    """CLIP-ResNet BatchNorm over (N, C, H, W); see the module docstring."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1, device=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.running_mean = nn.Parameter(torch.zeros(features, device=device),
                                         requires_grad=False)
        self.running_var = nn.Parameter(torch.ones(features, device=device),
                                        requires_grad=False)

    def forward(self, x: torch.Tensor, updates: Optional[BNUpdates] = None) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        x32 = x.float()
        if updates is None:
            # The affine fold in fp32; the result in the stream dtype.
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            shift = self.bias - self.running_mean * inv
            return (x32 * inv.view(shape) + shift.view(shape)).to(x.dtype)
        axes = (0, 2, 3)
        count = x32.numel() // x32.shape[1]
        if collectives.world_size() > 1:
            # Synced over the ranks' blocks of the global batch (each rank holds
            # as many rows), in the same two passes: the global mean, then the
            # global biased variance, both through a differentiable all-reduce.
            count *= collectives.world_size()
            mean = collectives.all_reduce_sum(x32.sum(dim=axes)) / count
            var = collectives.all_reduce_sum(
                (x32 - mean.view(shape)).square().sum(dim=axes)) / count
        else:
            mean = x32.mean(dim=axes)
            var = (x32 - mean.view(shape)).square().mean(dim=axes)
        unbiased = var * (count / max(count - 1, 1))
        m = self.momentum
        updates.append((self, ((1 - m) * self.running_mean + m * mean).detach(),
                        ((1 - m) * self.running_var + m * unbiased).detach()))
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        return (x32 * inv.view(shape) + shift.view(shape)).to(x.dtype)


@torch.no_grad()
def apply_bn_updates(updates: Optional[BNUpdates]) -> None:
    """Write the EMA running statistics of a train-form forward, in place."""
    for bn, mean, var in updates or ():
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)


class Conv(nn.Module):
    """A bias-free conv with an OIHW weight, run in the activation dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 padding: int = 0, device=None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with fp32_convolutions():
            return F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                            padding=self.padding)


def _avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    return F.avg_pool2d(x, window, window)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv(inplanes, planes, 1, device=device)
        self.bn1 = BatchNorm(planes, device=device)
        self.conv2 = Conv(planes, planes, 3, padding=1, device=device)
        self.bn2 = BatchNorm(planes, device=device)
        self.conv3 = Conv(planes, planes * 4, 1, device=device)
        self.bn3 = BatchNorm(planes * 4, device=device)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.ModuleList([Conv(inplanes, planes * 4, 1, device=device),
                                             BatchNorm(planes * 4, device=device)])

    def forward(self, x: torch.Tensor, updates: Optional[BNUpdates] = None) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), updates))
        out = F.relu(self.bn2(self.conv2(out), updates))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = self.bn3(self.conv3(out), updates)
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = _avg_pool(identity, self.stride)
            conv, bn = self.downsample
            identity = bn(conv(identity), updates)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention over the spatial positions with the mean token as the
    only query: logits and softmax in fp32, the weights in v's dtype."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(spacial_dim ** 2 + 1, embed_dim, device=device))
        self.q_proj = Dense(embed_dim, embed_dim, dtype, device)
        self.k_proj = Dense(embed_dim, embed_dim, dtype, device)
        self.v_proj = Dense(embed_dim, embed_dim, dtype, device)
        self.c_proj = Dense(embed_dim, output_dim, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, output_dim)."""
        b, c = x.shape[:2]
        tokens = x.flatten(2).transpose(1, 2)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding[:tokens.shape[1]].to(tokens.dtype)
        head_dim = c // self.num_heads

        def heads(t):  # (B, L, C) -> (B, heads, L, head_dim)
            return t.reshape(b, t.shape[1], self.num_heads, head_dim).transpose(1, 2)

        q, k, v = (heads(proj(t)) for proj, t in ((self.q_proj, tokens[:, :1]),
                                                   (self.k_proj, tokens),
                                                   (self.v_proj, tokens)))
        logits = (q.float() @ k.float().transpose(-1, -2)) / (head_dim ** 0.5)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (weights @ v).transpose(1, 2).reshape(b, c)
        return self.c_proj(out)


@dataclasses.dataclass(frozen=True)
class ModifiedResNetConfig:
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    width: int = 64
    output_dim: int = 1024
    input_resolution: int = 224
    heads: int = 32  # vision_width * 32 // 64


class ModifiedResNet(nn.Module):
    def __init__(self, config: ModifiedResNetConfig, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.config, self.dtype = config, dtype
        w = config.width
        self.conv1 = Conv(3, w // 2, 3, stride=2, padding=1, device=device)
        self.bn1 = BatchNorm(w // 2, device=device)
        self.conv2 = Conv(w // 2, w // 2, 3, padding=1, device=device)
        self.bn2 = BatchNorm(w // 2, device=device)
        self.conv3 = Conv(w // 2, w, 3, padding=1, device=device)
        self.bn3 = BatchNorm(w, device=device)
        inplanes = w
        for stage, (count, planes, stride) in enumerate(zip(
                config.layers, (w, w * 2, w * 4, w * 8), (1, 2, 2, 2)), start=1):
            blocks = []
            for block in range(count):
                blocks.append(Bottleneck(inplanes, planes, stride if block == 0 else 1, device))
                inplanes = planes * 4
            setattr(self, f"layer{stage}", nn.ModuleList(blocks))
        self.attnpool = AttentionPool2d(config.input_resolution // 32, inplanes, config.heads,
                                        config.output_dim, dtype, device)

    def forward(self, images: torch.Tensor,
                updates: Optional[BNUpdates] = None) -> torch.Tensor:
        """(B, H, W, 3) normalized -> (B, output_dim). With ``updates`` the
        BatchNorms run in train form and append their EMA updates to it."""
        x = images.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), updates))
        x = _avg_pool(x, 2)
        for stage in range(1, len(self.config.layers) + 1):
            for block in getattr(self, f"layer{stage}"):
                x = block(x, updates)
        return self.attnpool(x)


def resnet_params_from_torch(sd, prefix: str = "visual.") -> dict:
    """OpenAI-schema ModifiedResNet weights -> the JAX package's tree of the
    tower (numpy; conv kernels HWIO, dense kernels (in, out)), as
    ``fitclip_tpu/models/clip/resnet.py:resnet_params_from_torch`` gives it.
    ``convert/from_jax.py:resnet_clip_params_from_jax`` maps it to this
    module's state dict."""
    out: dict = {}

    def conv(name):
        return {"kernel": np.asarray(sd[f"{prefix}{name}.weight"]).transpose(2, 3, 1, 0)}

    def bn(name):
        return {leaf: np.asarray(sd[f"{prefix}{name}.{leaf}"])
                for leaf in ("weight", "bias", "running_mean", "running_var")}

    for i in (1, 2, 3):
        out[f"conv{i}"] = conv(f"conv{i}")
        out[f"bn{i}"] = bn(f"bn{i}")

    stage = 1
    while f"{prefix}layer{stage}.0.conv1.weight" in sd:
        block = 0
        while f"{prefix}layer{stage}.{block}.conv1.weight" in sd:
            p = f"layer{stage}.{block}"
            node = {f"conv{j}": conv(f"{p}.conv{j}") for j in (1, 2, 3)}
            node.update({f"bn{j}": bn(f"{p}.bn{j}") for j in (1, 2, 3)})
            if f"{prefix}{p}.downsample.0.weight" in sd:
                node["downsample_conv"] = conv(f"{p}.downsample.0")
                node["downsample_bn"] = bn(f"{p}.downsample.1")
            out[f"layer{stage}_{block}"] = node
            block += 1
        stage += 1

    def linear(name):
        return {"kernel": np.asarray(sd[f"{prefix}attnpool.{name}.weight"]).T,
                "bias": np.asarray(sd[f"{prefix}attnpool.{name}.bias"])}

    out["attnpool"] = {
        "positional_embedding": np.asarray(sd[f"{prefix}attnpool.positional_embedding"]),
        **{name: linear(name) for name in ("q_proj", "k_proj", "v_proj", "c_proj")},
    }
    return out
