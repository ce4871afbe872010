"""ResNet-CLIP: the ModifiedResNet vision tower and CLIP's text transformer
(port of ``fitclip_tpu/models/clip/resnet_clip.py``).

Covers the named OpenAI weights RN50 / RN101 / RN50x4 / RN50x16 / RN50x64
(``config/encoder/clip_rn*.yaml``, ``open_clip_rn*.yaml``). Evaluation runs
the frozen-statistics BatchNorm (the released checkpoints' inference form);
training runs the live batch-statistics BatchNorm, whose EMA running-stat
updates the train step writes back after the optimizer step
(``encode_video_train``, ``apply_bn_updates``).

The text tower is the port's ``TextTransformer`` with QuickGELU, in the
tower's dtype; with ``fused_attention`` (the default on CUDA) its causal
attention runs the Hopper attention kernels forward and backward. The convs
are cuDNN's and the attention pool plain PyTorch, as the JAX package leaves
them to XLA. There is no int8 form, no fused layer path and no remat.
"""

import dataclasses
import math
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fitclip_torch.convert.torch_state_dict import _ln, _openai_tower_blocks
from fitclip_torch.data.frame_sampler import (RandomFromUniformIntervalsFrameSampler,
                                              UniformFrameSampler)
from fitclip_torch.models.api import PreprocessSpec
from fitclip_torch.models.clip.encoder import CLIP_MEAN, CLIP_STD, l2_normalize, prepare_frames
from fitclip_torch.models.clip.model import (Dense, LayerNormFp32, TextConfig, TextTransformer,
                                             _truncated_normal)
from fitclip_torch.models.clip.resnet import (BNUpdates, Conv, ModifiedResNet,
                                              ModifiedResNetConfig, apply_bn_updates,
                                              resnet_params_from_torch)
from fitclip_torch.models.clip.tokenizer import ClipTokenizer


@dataclasses.dataclass(frozen=True)
class ResNetCLIPConfig:
    embed_dim: int
    vision: ModifiedResNetConfig
    text: TextConfig

    @property
    def quick_gelu(self) -> bool:
        return True


RESNET_PRESETS = {
    "RN50": ResNetCLIPConfig(
        embed_dim=1024,
        vision=ModifiedResNetConfig((3, 4, 6, 3), width=64, output_dim=1024,
                                    input_resolution=224, heads=32),
        text=TextConfig(width=512, heads=8, layers=12)),
    "RN101": ResNetCLIPConfig(
        embed_dim=512,
        vision=ModifiedResNetConfig((3, 4, 23, 3), width=64, output_dim=512,
                                    input_resolution=224, heads=32),
        text=TextConfig(width=512, heads=8, layers=12)),
    "RN50x4": ResNetCLIPConfig(
        embed_dim=640,
        vision=ModifiedResNetConfig((4, 6, 10, 6), width=80, output_dim=640,
                                    input_resolution=288, heads=40),
        text=TextConfig(width=640, heads=10, layers=12)),
    "RN50x16": ResNetCLIPConfig(
        embed_dim=768,
        vision=ModifiedResNetConfig((6, 8, 18, 8), width=96, output_dim=768,
                                    input_resolution=384, heads=48),
        text=TextConfig(width=768, heads=12, layers=12)),
    "RN50x64": ResNetCLIPConfig(
        embed_dim=1024,
        vision=ModifiedResNetConfig((3, 15, 36, 10), width=128, output_dim=1024,
                                    input_resolution=448, heads=64),
        text=TextConfig(width=1024, heads=16, layers=12)),
}


class ResNetCLIPModel(nn.Module):
    """``dtype`` is the compute dtype of both towers (parameters stay fp32);
    BatchNorm statistics are fp32 either way."""

    def __init__(self, config: ResNetCLIPConfig, dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False, device=None):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.visual = ModifiedResNet(config.vision, dtype, device)
        self.text = TextTransformer(config.text, config.embed_dim, config.quick_gelu, dtype,
                                    fused_attention, device=device)

    def encode_image(self, images: torch.Tensor,
                     updates: Optional[BNUpdates] = None) -> torch.Tensor:
        return self.visual(images, updates)

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text(input_ids)


def init_resnet_clip_params(model: ResNetCLIPModel, seed: int) -> ResNetCLIPModel:
    """Seeded random init in place, with the JAX package's initializers:
    LeCun-normal (truncated) conv and dense kernels, zero biases, BatchNorm
    at weight 1, bias 0, running mean 0 and variance 1, normal(width^-0.5)
    attention-pool positions, and the text tower's as ``init_float_params``
    draws them. Drawn on a CPU torch.Generator, so a seed gives the same
    weights on every device."""
    gen = torch.Generator().manual_seed(seed)

    def put(param, value):
        param.copy_(value.to(param.device))

    def lecun(param, fan_in):
        put(param, _truncated_normal(param.shape, math.sqrt(1 / fan_in) / 0.87962566103423978,
                                     gen))

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Conv):
                lecun(module.weight, module.weight[0].numel())
            elif isinstance(module, Dense):
                lecun(module.weight, module.weight.shape[1])
                module.bias.zero_()
            elif isinstance(module, LayerNormFp32):
                module.weight.fill_(1.0)
                module.bias.zero_()
        pos, t = model.visual.attnpool.positional_embedding, model.text
        put(pos, torch.randn(pos.shape, generator=gen) * pos.shape[1] ** -0.5)
        put(t.token_embedding, torch.randn(t.token_embedding.shape, generator=gen) * 0.02)
        put(t.positional_embedding,
            torch.randn(t.positional_embedding.shape, generator=gen) * 0.01)
        put(t.text_projection,
            torch.randn(t.text_projection.shape, generator=gen) * t.config.width ** -0.5)
    return model


class ResNetClipVideoTextEncoder(nn.Module):
    """The ViT CLIP encoder's contract (frame mean of the L2-normalized frame
    embeddings) over the ResNet tower. ``encode_video`` runs the
    frozen-statistics BatchNorm; ``encode_video_train`` the batch-statistics
    one, returning the EMA updates for ``apply_bn_updates``. ``train_runner``
    reads ``trainable``, ``quantized``, ``fused_block`` and appends
    ``bn_freeze_patterns`` to the optimizer's freeze regexes."""

    trainable = True
    quantized = False
    fused_block = False
    # The running statistics update by EMA, not by gradient descent.
    bn_freeze_patterns = (r"running_(mean|var)$",)

    def __init__(self, config: ResNetCLIPConfig, num_frames: int = 4,
                 dtype: torch.dtype = torch.float32, fused_attention: bool = False,
                 device=None, bpe_path: Optional[str] = None,
                 tokenizer: Optional[ClipTokenizer] = None):
        super().__init__()
        self.config, self.dtype, self.num_frames = config, dtype, num_frames
        self.fused_attention = fused_attention
        self.mean, self.std = CLIP_MEAN, CLIP_STD
        self.model = ResNetCLIPModel(config, dtype, fused_attention, device)
        self._bpe_path, self._tokenizer = bpe_path, tokenizer
        self.preprocess = PreprocessSpec(
            num_frames=num_frames,
            image_size=config.vision.input_resolution,
            mean=CLIP_MEAN,
            std=CLIP_STD,
            train_frame_sampler=RandomFromUniformIntervalsFrameSampler(num_frames),
            eval_frame_sampler=UniformFrameSampler(num_frames),
            max_tokens=config.text.context_length,
        )

    def _frames(self, video: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """(B, T, H, W, C) -> ((B*T, H, W, C), B, T); uint8 video is normalized
        in fp32 as (x - mean * 255) * (1 / (std * 255)), then the tower casts."""
        return prepare_frames(video, torch.float32, self.mean, self.std), *video.shape[:2]

    def _pool(self, embeddings: torch.Tensor, b: int, t: int) -> torch.Tensor:
        return l2_normalize(embeddings).reshape(b, t, -1).mean(dim=1)

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, D), with the frozen statistics."""
        frames, b, t = self._frames(video)
        return self._pool(self.model.encode_image(frames), b, t)

    def encode_video_train(self, video: torch.Tensor) -> Tuple[torch.Tensor, BNUpdates]:
        """The train-form encode: batch-statistics BatchNorm. Returns
        (clip embeddings, the EMA updates); pass the updates to
        ``apply_bn_updates`` after the optimizer step."""
        frames, b, t = self._frames(video)
        updates: BNUpdates = []
        return self._pool(self.model.encode_image(frames, updates), b, t), updates

    @staticmethod
    def apply_bn_updates(updates: Optional[BNUpdates]) -> None:
        apply_bn_updates(updates)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.model.encode_text(text))

    def get_tokenizer(self) -> Callable[[Sequence[str]], np.ndarray]:
        if self._tokenizer is None:
            self._tokenizer = ClipTokenizer(bpe_path=self._bpe_path,
                                            context_length=self.config.text.context_length)
        return self._tokenizer

    def decode_text(self, ids) -> Iterator[str]:
        tokenizer = self.get_tokenizer()
        for row in np.asarray(ids):
            yield tokenizer.decode(row[row != 0])


def resnet_clip_params_from_torch(state_dict, config: ResNetCLIPConfig) -> Dict:
    """An OpenAI RN-CLIP state dict -> the JAX package's RN-CLIP tree (numpy):
    the visual tower by ``resnet_params_from_torch``, the text tower by the
    shared OpenAI tower stacker, as the JAX converter builds it."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    return {
        "visual": resnet_params_from_torch(sd),
        "text": {
            "token_embedding": sd["token_embedding.weight"],
            "positional_embedding": sd["positional_embedding"],
            "transformer": {"blocks": _openai_tower_blocks(sd, "transformer",
                                                           config.text.layers)},
            "ln_final": _ln(sd, "ln_final"),
            "text_projection": sd["text_projection"],
        },
    }
