"""MIL-NCE (S3D-G) video-text encoder: tokenizer, converters, encoder and loader
(port of ``fitclip_tpu/models/mil_nce.py``).

Video: S3D-G over 16 consecutive frames of raw [0, 1] pixels (uint8 video is
divided by 255 in the tower's dtype), embeddings not L2-normalized. Text: the
word-embedding MLP over a lowercase regex word tokenizer on the released
``s3d_dict.npy`` vocab (ids start at 1, padded or cut to 20).

bf16 and int8 run the fast eval forward (``s3dg_fast.py``, the stem on K7; int8
adds W8A8 sites from ``int8_from`` on, on the int8 GEMM kernel) and need
``encoder.calibrate`` before an int8 ``encode_video``; fp32 runs the module path.
"""

import logging
import math
import re
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from fitclip_torch.convert.from_jax import mil_nce_params_from_jax
from fitclip_torch.convert.torch_state_dict import load_torch_state_dict
from fitclip_torch.data.frame_sampler import ConsecutiveFrameSampler
from fitclip_torch.models.api import PreprocessSpec
from fitclip_torch.models.clip.load import _DTYPES, LoadedEncoder, resolve_device
from fitclip_torch.models.s3dg import S3DG, MilNceTextEncoder, init_s3dg_params, nest
from fitclip_torch.models.s3dg_fast import quantize_s3dg_fast, s3dg_fast_apply
from fitclip_torch.ops.quant import apply_act_scales, dynamic_observing, observed_act_amax
from fitclip_torch.utils.profiling import span

LOGGER = logging.getLogger(__name__)


class MilNceTokenizer:
    """Lowercase [\\w']+ word tokenizer over a {word: id} vocab, fixed length."""

    RE_WORD = re.compile(r"[\w']+")

    def __init__(self, vocab: Mapping[str, int], max_tokens: int = 20,
                 lowercase: bool = True) -> None:
        self.vocab = dict(vocab)
        self.max_tokens = max_tokens
        self.lowercase = lowercase
        self.indices_to_tokens = {i: t for t, i in self.vocab.items()}

    @classmethod
    def from_npy(cls, vocab_path: str, **kwargs) -> "MilNceTokenizer":
        words = np.load(vocab_path)
        return cls({str(word): i + 1 for i, word in enumerate(words)}, **kwargs)

    def encode(self, text: str) -> Sequence[int]:
        if self.lowercase:
            text = text.lower()
        ids = [self.vocab[w] for w in self.RE_WORD.findall(text) if w in self.vocab]
        return ids[: self.max_tokens]

    def decode(self, ids) -> str:
        return " ".join(self.indices_to_tokens[int(i)] for i in ids if int(i) != 0)

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.max_tokens), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)
            out[row, : len(ids)] = ids
        return out


# --- checkpoint conversion (numpy, the JAX parameter tree's layout) ---------

def torch_tree_to_jax(state_dict: Mapping[str, np.ndarray]) -> dict:
    """Dot-path torch state dict -> nested tree: 5-D conv weights (O, I, kT, kH,
    kW) become THWIO ``kernel``s, 2-D linear weights transpose to (in, out), the
    word embedding keeps its (vocab, dim) layout, BatchNorm keeps its names."""
    tree: dict = {}
    for key, value in state_dict.items():
        value = np.asarray(value, dtype=np.float32)
        parts = key.split(".")
        node = tree
        for part in parts[:-2]:
            node = node.setdefault(part, {})
        if parts[-2:] == ["word_embd", "weight"]:
            node["word_embd"] = value
            continue
        node = node.setdefault(parts[-2], {}) if len(parts) > 1 else node
        leaf = parts[-1]
        if leaf == "weight" and value.ndim == 5:
            node["kernel"] = value.transpose(2, 3, 4, 1, 0)
        elif leaf == "weight" and value.ndim == 2:
            node["kernel"] = value.T
        else:
            node[leaf] = value
    return tree


def mil_nce_params_from_torch(video_state_dict: Mapping[str, np.ndarray],
                              text_state_dict: Mapping[str, np.ndarray]) -> dict:
    return {"video": torch_tree_to_jax(video_state_dict),
            "text": torch_tree_to_jax(text_state_dict)}


def init_mil_nce_params(seed: int = 0, vocab_size: int = 66250) -> dict:
    """A seeded tree: ``init_s3dg_params`` for the video tower, the text tower's
    word embedding from normal(1.0) and its FC kernels LeCun-normal (numpy)."""
    rng = np.random.default_rng(seed + 1)
    text = {}
    for name, value in MilNceTextEncoder(vocab_size=vocab_size).state_dict().items():
        shape = tuple(value.shape)
        if name == "word_embd":
            text[name] = rng.standard_normal(shape, np.float32)
        elif name.endswith("kernel"):
            text[name] = (rng.standard_normal(shape, np.float32) / np.float32(math.sqrt(shape[0])))
        else:
            text[name] = np.zeros(shape, np.float32)
    return {"video": init_s3dg_params(seed), "text": nest(text)}


class MilNceVideoTextEncoder(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32, quantized: bool = False,
                 fast: Optional[bool] = None, int8_from: Optional[str] = "mixed_4b",
                 num_frames: int = 16, max_tokens: int = 20, vocab_size: int = 66250,
                 vocab_path: Optional[str] = None):
        super().__init__()
        if quantized:
            dtype = torch.bfloat16
        self.dtype, self.quantized = dtype, quantized
        self.fast = (quantized or dtype == torch.bfloat16) if fast is None else bool(fast)
        if quantized and not self.fast:
            raise ValueError("int8 S3DG requires the fast eval forward")
        if self.fast and dtype != torch.bfloat16:
            raise ValueError("the fast S3DG forward runs in bf16")
        self.num_frames, self.max_tokens = num_frames, max_tokens
        self._tokenizer = (MilNceTokenizer.from_npy(vocab_path, max_tokens=max_tokens)
                           if vocab_path else None)
        self.preprocess = PreprocessSpec(
            num_frames=num_frames, image_size=224, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
            train_frame_sampler=ConsecutiveFrameSampler(num_frames, fps=5),
            eval_frame_sampler=ConsecutiveFrameSampler(num_frames, fps=5),
            resize_mode="bilinear", should_pad_batch=False, pad_to_min_frames=num_frames,
            max_tokens=max_tokens)
        self.video = S3DG(dtype=dtype, int8_from=int8_from if quantized else False)
        self.text = MilNceTextEncoder(vocab_size=vocab_size)

    def _prepare_video(self, video: torch.Tensor) -> torch.Tensor:
        return video.to(self.dtype) / 255.0 if video.dtype == torch.uint8 else video

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) raw pixels -> (B, 512) in the tower's dtype, not normalized."""
        video = self._prepare_video(video)
        if self.fast:
            return s3dg_fast_apply(self.video, video, self.dtype, int8=self.quantized)
        return self.video(video)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """(B, L) word ids (0 pads) -> (B, 512) fp32."""
        return self.text(text)

    @torch.no_grad()
    def collect_act_amax(self, video: torch.Tensor, text=None):
        """One calibration observation: the fast forward with every int8 site in
        dynamic-quant mode, as {"video/int8/<site>": (1, 1) abs-max}. The text
        tower is not quantized: ``text`` is ignored."""
        if not self.quantized:
            raise ValueError("calibration requires a quantized encoder")
        with dynamic_observing(self.video.int8):
            s3dg_fast_apply(self.video, self._prepare_video(video), self.dtype, int8=True)
        return {f"video/int8/{site}": amax
                for site, amax in observed_act_amax(self.video.int8).items()}

    def calibrate(self, video: torch.Tensor, text=None,
                  margin: float = 1.0) -> "MilNceVideoTextEncoder":
        """Post-training calibration on one batch, in place."""
        with span("calibrate"):
            apply_act_scales(self, self.collect_act_amax(video, text), margin=margin)
        return self

    def get_tokenizer(self) -> MilNceTokenizer:
        if self._tokenizer is None:
            raise ValueError("MIL-NCE needs a vocab (s3d_dict.npy): pass vocab_path")
        return self._tokenizer


def split_mil_nce_state_dict(full: Mapping[str, np.ndarray]):
    """A MIL-NCE checkpoint -> (video, text) state dicts: the text tower sits under
    ``text_module.`` or, in separate text checkpoints, at word_embd/fc1/fc2."""
    text = {k[len("text_module."):]: v for k, v in full.items() if k.startswith("text_module.")}
    video = {k: v for k, v in full.items() if not k.startswith("text_module.")}
    if not text:
        text = {k: v for k, v in full.items() if k.split(".")[0] in ("word_embd", "fc1", "fc2")}
        video = {k: v for k, v in full.items() if k not in text}
    return video, text


def load_mil_nce_encoder(pretrained_path: Optional[str] = None, vocab_path: Optional[str] = None,
                         dtype: str = "float32", device="cuda", seed: int = 0,
                         num_frames: int = 16, max_tokens: int = 20, fast: Optional[bool] = None,
                         int8_from: Optional[str] = "mixed_4b") -> LoadedEncoder:
    """MIL-NCE (Miech et al., CVPR 2020: S3D-G, 16 frames of 224^2, 512-d) on
    ``device``; weights from ``s3d_howto100m.pth`` or, without one, from ``seed``.
    ``dtype="int8"`` quantizes the float tree's sites from ``int8_from`` on."""
    quantized = str(dtype) == "int8"
    if not quantized and str(dtype) not in _DTYPES:
        raise ValueError(f"Unknown encoder dtype {dtype!r} — expected one of "
                         f"{sorted(_DTYPES)} or 'int8'")
    device = resolve_device(device)
    encoder = MilNceVideoTextEncoder(_DTYPES["bfloat16" if quantized else str(dtype)],
                                     quantized, fast, int8_from, num_frames, max_tokens,
                                     vocab_path=vocab_path)
    if pretrained_path:
        params = mil_nce_params_from_torch(*split_mil_nce_state_dict(
            load_torch_state_dict(pretrained_path)))
    else:
        LOGGER.warning("No checkpoint for MIL-NCE: initializing from seed %d.", seed)
        params = init_mil_nce_params(seed)
    if quantized:
        params = dict(params, video=quantize_s3dg_fast(params["video"], int8_from))
    encoder.load_state_dict(mil_nce_params_from_jax(params))
    return LoadedEncoder(encoder.to(device))
