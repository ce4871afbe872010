"""CLIP video-text encoder: per-frame image encoding with frame-mean pooling
(port of ``fitclip_tpu/models/clip/encoder.py``).

video: fold the frames into the batch, encode each frame, L2-normalize, mean
over the frames; text: encode, L2-normalize. uint8 video is normalized on the
device, or only cast when the pixel normalization is folded into the patch
embedding. An int8 encoder calibrates its static activation scales by running
both towers in dynamic-quant mode.

``encode_text`` takes token ids from ``get_tokenizer()`` (CLIP's byte-level
BPE, ``tokenizer.py``): its EOT token carries the largest id of its row.
``preprocess`` is the data layer's recipe (``models/api.py``).

``encode_video`` and ``encode_text`` are differentiable through the module
path (the train steps differentiate through them); eval callers and the
frozen teacher run them under ``torch.no_grad()``. The fused layer path
(``fused_block``: K1 for int8, K2 for a float encoder) is inference only and
runs without a graph.
"""

import functools
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from fitclip_torch.data.frame_sampler import (RandomFromUniformIntervalsFrameSampler,
                                              UniformFrameSampler)
from fitclip_torch.models.api import PreprocessSpec
from fitclip_torch.models.clip.fast_eval import encode_frames_fast, encode_text_fast
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, fold_pixel_normalization
from fitclip_torch.models.clip.tokenizer import ClipTokenizer
from fitclip_torch.ops.quant import apply_act_scales, dynamic_observing, observed_act_amax
from fitclip_torch.utils.profiling import span

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@functools.lru_cache(maxsize=None)
def _pixel_constants(mean: Tuple[float, ...], std: Tuple[float, ...], dtype: torch.dtype,
                     device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean * 255, 1 / (std * 255)) on the device, made once: a host-to-device
    copy on every call could not be captured in a CUDA graph."""
    mean_t = torch.tensor(mean, dtype=dtype, device=device) * 255.0
    return mean_t, 1.0 / (torch.tensor(std, dtype=dtype, device=device) * 255.0)


def prepare_frames(video: torch.Tensor, dtype: torch.dtype, mean, std,
                   normalization_folded: bool = False) -> torch.Tensor:
    """(B, T, H, W, C) -> (B*T, H, W, C) in dtype. uint8 video is normalized
    on the device with mean/std (in [0, 1] units), or only cast when the
    normalization is folded into the patch embedding."""
    if video.dtype == torch.uint8:
        if normalization_folded:
            video = video.to(dtype)
        else:
            mean, inv_std = _pixel_constants(tuple(mean), tuple(std), dtype, video.device)
            video = (video.to(dtype) - mean) * inv_std
    b, t = video.shape[0], video.shape[1]
    return video.reshape(b * t, *video.shape[2:])


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    x32 = x.float()
    norm = torch.linalg.vector_norm(x32, dim=dim, keepdim=True)
    return (x32 / torch.clamp_min(norm, eps if eps else 1e-30)).to(x.dtype)


class ClipVideoTextEncoder(nn.Module):
    """``quantized`` selects int8 W8A8 block denses (the model's weights must
    then come from ``quantize_clip_params``). ``fused_block`` (default:
    quantized and fused_attention) runs each layer through the fused layer
    kernels (``fast_eval``: K1 for int8, K2 in bf16 for a float encoder);
    otherwise the module path runs.
    ``pad_seq`` pads the vision sequence of the fused path with masked rows.
    ``remat`` (False, True or "dots") checkpoints each residual block in
    training (``model.py``). ``bpe_path`` names the BPE merges file (else
    ``FITCLIP_BPE_PATH``); ``tokenizer`` gives a built one instead."""

    def __init__(self, config: Optional[CLIPConfig] = None, num_frames: int = 4,
                 dtype: torch.dtype = torch.float32, fused_attention: bool = False,
                 pixel_normalization_folded: bool = False, quantized: bool = False,
                 fused_block: Optional[bool] = None, pad_seq: int = 0, device=None,
                 remat: Union[bool, str] = False, bpe_path: Optional[str] = None,
                 tokenizer: Optional[ClipTokenizer] = None):
        super().__init__()
        self.config = config or CLIPConfig.vit_b_16()
        self.dtype = dtype
        self.quantized = quantized
        self.fused_attention = fused_attention
        self.fused_block = (bool(quantized) and fused_attention
                            if fused_block is None else fused_block)
        self.pixel_normalization_folded = pixel_normalization_folded
        self.num_frames = num_frames
        self.pad_seq = pad_seq
        self.mean, self.std = CLIP_MEAN, CLIP_STD
        self.model = CLIPModel(self.config, dtype=dtype, fused_attention=fused_attention,
                               quantized=quantized, device=device, remat=remat)
        self._bpe_path, self._tokenizer = bpe_path, tokenizer
        self.preprocess = PreprocessSpec(
            num_frames=num_frames,
            image_size=self.config.vision.image_size,
            mean=CLIP_MEAN,
            std=CLIP_STD,
            train_frame_sampler=RandomFromUniformIntervalsFrameSampler(num_frames),
            eval_frame_sampler=UniformFrameSampler(num_frames),
            max_tokens=self.config.text.context_length,
        )

    def fold_pixel_normalization(self) -> "ClipVideoTextEncoder":
        """Fold this encoder's pixel normalization into the patch embedding,
        in place: uint8 video is then only cast."""
        if not self.pixel_normalization_folded:
            fold_pixel_normalization(self.model, self.mean, self.std)
            self.pixel_normalization_folded = True
        return self

    def _prepare_frames(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> (B*T, H, W, C) in the compute dtype."""
        return prepare_frames(video, self.dtype, self.mean, self.std,
                              self.pixel_normalization_folded)

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, D): the mean of the L2-normalized frame embeddings."""
        b, t = video.shape[0], video.shape[1]
        frames = self._prepare_frames(video)
        if self.fused_block:
            embeddings = encode_frames_fast(self.model, frames, pad_seq=self.pad_seq)
        else:
            embeddings = self.model.encode_image(frames)
        return l2_normalize(embeddings).reshape(b, t, -1).mean(dim=1)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        if self.fused_block:
            return l2_normalize(encode_text_fast(self.model, text))
        return l2_normalize(self.model.encode_text(text))

    @torch.no_grad()
    def collect_act_amax(self, video: torch.Tensor,
                         text: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
        """One calibration observation: run the towers through the module path
        in dynamic-quant mode (with this encoder's fused_attention) and return
        {site: (layers, 1) abs-max}. Merge several with ops.quant.merge_act_amax."""
        if not self.quantized:
            raise ValueError("calibration requires a quantized encoder")
        with dynamic_observing(self.model):
            self.model.encode_image(self._prepare_frames(video))
            amax = observed_act_amax(self.model, "visual/")
            if text is not None:
                self.model.encode_text(text)
                amax.update(observed_act_amax(self.model, "text/"))
        return amax

    def calibrate(self, video: torch.Tensor, text: Optional[torch.Tensor] = None,
                  margin: float = 1.0) -> "ClipVideoTextEncoder":
        """Post-training calibration on one batch: write the observed activation
        abs-maxes into the act_scale buffers, in place."""
        with span("calibrate"):
            apply_act_scales(self.model, self.collect_act_amax(video, text), margin=margin)
        return self

    def get_tokenizer(self) -> Callable[[Sequence[str]], np.ndarray]:
        if self._tokenizer is None:
            self._tokenizer = ClipTokenizer(bpe_path=self._bpe_path,
                                            context_length=self.config.text.context_length)
        return self._tokenizer

    def decode_text(self, ids) -> Iterator[str]:
        tokenizer = self.get_tokenizer()
        for row in np.asarray(ids):
            yield tokenizer.decode(row[row != 0])
