"""Frozen-in-Time video-text encoder: SpaceTimeTransformer + DistilBERT +
linear projections (port of ``fitclip_tpu/models/frozen_in_time/encoder.py``).

video: uint8 clips get the ImageNet normalization on the device, the video
tower gives the CLS feature, ``vid_proj`` maps it to 256; text: DistilBERT
with the mask ``ids != 0`` ([PAD] is 0), ReLU on the CLS row, ``txt_proj``.
Both projections run in fp32 and both embeddings are L2-normalized with an eps
of 1e-8. Tokens come from the WordPiece tokenizer (``get_tokenizer``, a BERT
``vocab.txt``), 77 per row.

``quantized`` runs the video tower's qkv/proj/mlp denses as int8 W8A8; the
DistilBERT tower stays in the float dtype (bf16 for an int8 encoder).
``fused_block`` (default: quantized and fused_attention) runs each int8
SpaceTimeBlock through the K4 kernels (``fit_fast.py``); otherwise the module
path runs, with K5/K6 under ``fused_attention``. ``calibrate`` runs the video
tower in dynamic-quant mode with the einsum attention, as the JAX encoder
does, so the scales and their site names match the JAX ones.

The checkpoint converters work on numpy: ``frozen_in_time_params_from_torch``
maps a FrozenInTime torch state dict to the JAX parameter tree, which
``convert/from_jax.py:fit_params_from_jax`` loads into this module.
"""

import contextlib
import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from fitclip_torch.models.clip.encoder import l2_normalize
from fitclip_torch.models.frozen_in_time.distilbert import DistilBertConfig, DistilBertModel
from fitclip_torch.models.frozen_in_time.fit_fast import encode_video_features_fast
from fitclip_torch.models.frozen_in_time.video_transformer import (SpaceTimeTransformer,
                                                                    VarAttention)
from fitclip_torch.ops.quant import apply_act_scales, dynamic_observing, observed_act_amax

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
EMBED_EPS = 1e-8  # the L2 normalization's guard (frozen_in_time.py's eps)


@dataclasses.dataclass(frozen=True)
class FrozenInTimeConfig:
    projection_dim: int = 256
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    patch_size: int = 16
    img_size: int = 224
    num_frames: int = 4
    text: DistilBertConfig = DistilBertConfig()

    @staticmethod
    def tiny_test(vocab_size: int = 100) -> "FrozenInTimeConfig":
        return FrozenInTimeConfig(projection_dim=16, embed_dim=48, depth=2, num_heads=4,
                                  patch_size=16, img_size=32, num_frames=2,
                                  text=DistilBertConfig.tiny_test(vocab_size))


class FrozenInTimeVideoTextEncoder(nn.Module):
    def __init__(self, config: Optional[FrozenInTimeConfig] = None, num_frames: int = 4,
                 max_tokens: int = 77, dtype: torch.dtype = torch.float32,
                 quantized: bool = False, fused_attention: bool = False,
                 fused_block: Optional[bool] = None, vocab_path: Optional[str] = None,
                 device=None):
        super().__init__()
        self.config = config = config or FrozenInTimeConfig()
        self.dtype, self.quantized = dtype, quantized
        self.fused_attention = fused_attention
        self.fused_block = quantized and fused_attention if fused_block is None else fused_block
        self.num_frames, self.max_tokens, self.vocab_path = num_frames, max_tokens, vocab_path
        self._tokenizer = None
        self.video = SpaceTimeTransformer(config.embed_dim, config.depth, config.num_heads,
                                          config.patch_size, config.img_size, config.num_frames,
                                          dtype, fused_attention, quantized, device)
        self.text = DistilBertModel(config.text, dtype, device)
        self.vid_proj = nn.Linear(config.embed_dim, config.projection_dim, device=device)
        self.txt_proj = nn.Linear(config.text.dim, config.projection_dim, device=device)

    def _prepare_video(self, video: torch.Tensor) -> torch.Tensor:
        """uint8 (B, F, H, W, 3) -> ImageNet-normalized fp32; floats pass as they are."""
        if video.dtype == torch.uint8:
            mean = torch.tensor(IMAGENET_MEAN, device=video.device) * 255.0
            inv_std = 1.0 / (torch.tensor(IMAGENET_STD, device=video.device) * 255.0)
            video = (video.float() - mean) * inv_std
        return video

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        """(B, F, H, W, 3) -> (B, projection_dim) fp32, L2-normalized."""
        video = self._prepare_video(video)
        if self.fused_block:
            features = encode_video_features_fast(self.video, video)
        else:
            features = self.video(video)
        return l2_normalize(self.vid_proj(features.float()), eps=EMBED_EPS)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """(B, L) token ids -> (B, projection_dim) fp32, L2-normalized."""
        hidden = self.text(text, text != 0)
        return l2_normalize(self.txt_proj(torch.relu(hidden[:, 0]).float()), eps=EMBED_EPS)

    @contextlib.contextmanager
    def _einsum_attention(self):
        attentions = [m for m in self.video.modules() if isinstance(m, VarAttention)]
        saved = [m.fused for m in attentions]
        try:
            for m in attentions:
                m.fused = False
            yield
        finally:
            for m, fused in zip(attentions, saved):
                m.fused = fused

    @torch.no_grad()
    def collect_act_amax(self, video: torch.Tensor, text=None) -> Dict[str, np.ndarray]:
        """One calibration observation: the video tower in dynamic-quant mode
        with the einsum attention (each dense sees its whole input once), as
        {site: (layers, 1) abs-max}, sites named "video/blocks/attn/qkv" and so
        on. The text tower is not quantized: ``text`` is ignored."""
        if not self.quantized:
            raise ValueError("calibration requires a quantized encoder")
        with dynamic_observing(self.video), self._einsum_attention():
            self.video(self._prepare_video(video))
        return {f"video/{site}": amax for site, amax in observed_act_amax(self.video).items()}

    def calibrate(self, video: torch.Tensor, text=None,
                  margin: float = 1.0) -> "FrozenInTimeVideoTextEncoder":
        """Post-training calibration on one batch, in place."""
        apply_act_scales(self, self.collect_act_amax(video, text), margin=margin)
        return self

    def get_tokenizer(self):
        """texts -> (B, max_tokens) int32 ids ([CLS] ... [SEP], [PAD] = 0)."""
        if self._tokenizer is None:
            from fitclip_torch.text.wordpiece import WordPieceTokenizer

            inner = WordPieceTokenizer(vocab_path=self.vocab_path, max_tokens=self.max_tokens)
            self._tokenizer = lambda texts: inner(texts)["input_ids"]
            self._tokenizer.inner = inner
        return self._tokenizer


# --- checkpoint conversion (numpy, the JAX parameter tree's layout) ---------

def inflate_temporal_embed(temporal_embed: np.ndarray, target_frames: int,
                           mode: str = "zeros") -> np.ndarray:
    """A checkpoint's (frames, D) temporal embedding at target_frames: cut,
    padded with zeros, or linearly interpolated ("interp")."""
    current = temporal_embed.shape[0]
    if current == target_frames:
        return temporal_embed
    if current > target_frames:
        return temporal_embed[:target_frames]
    if mode == "zeros":
        pad = np.zeros((target_frames - current, temporal_embed.shape[1]), temporal_embed.dtype)
        return np.concatenate([temporal_embed, pad])
    if mode == "interp":
        positions = np.linspace(0, current - 1, target_frames)
        lo = np.floor(positions).astype(int)
        hi = np.minimum(lo + 1, current - 1)
        frac = (positions - lo)[:, None]
        return temporal_embed[lo] * (1 - frac) + temporal_embed[hi] * frac
    raise ValueError(f"Unknown inflation mode: {mode}")


def _linear(sd, name):
    return {"kernel": sd[f"{name}.weight"].T, "bias": sd[f"{name}.bias"]}


def _norm(sd, name):
    return {"weight": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def distilbert_params_from_torch(state_dict: Mapping[str, np.ndarray],
                                 config: DistilBertConfig) -> dict:
    """HF DistilBertModel state dict -> the DistilBERT parameter tree."""
    sd = {k.replace("distilbert.", ""): np.asarray(v, np.float32) for k, v in state_dict.items()}
    params = {"word_embeddings": sd["embeddings.word_embeddings.weight"],
              "position_embeddings": sd["embeddings.position_embeddings.weight"],
              "embeddings_layer_norm": _norm(sd, "embeddings.LayerNorm")}
    for i in range(config.n_layers):
        p = f"transformer.layer.{i}"
        params[f"layer_{i}"] = {
            **{f"attention_{n}": _linear(sd, f"{p}.attention.{n}")
               for n in ("q_lin", "k_lin", "v_lin", "out_lin")},
            "sa_layer_norm": _norm(sd, f"{p}.sa_layer_norm"),
            "ffn_lin1": _linear(sd, f"{p}.ffn.lin1"),
            "ffn_lin2": _linear(sd, f"{p}.ffn.lin2"),
            "output_layer_norm": _norm(sd, f"{p}.output_layer_norm"),
        }
    return params


def frozen_in_time_params_from_torch(state_dict: Mapping[str, np.ndarray],
                                     config: FrozenInTimeConfig,
                                     temporal_inflation: str = "zeros") -> dict:
    """FrozenInTime checkpoint (video_model.*, text_model.*, vid_proj.0.*,
    txt_proj.1.*) -> the parameter tree, with the temporal embedding brought
    to config.num_frames."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()}
    conv = sd["video_model.patch_embed.proj.weight"]  # (D, 3, p, p)
    video = {
        "patch_embed": {"kernel": conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0]),
                        "bias": sd["video_model.patch_embed.proj.bias"]},
        "cls_token": sd["video_model.cls_token"].reshape(-1),
        "pos_embed": sd["video_model.pos_embed"].reshape(-1, config.embed_dim),
        "temporal_embed": inflate_temporal_embed(
            sd["video_model.temporal_embed"].reshape(-1, config.embed_dim), config.num_frames,
            temporal_inflation),
        "norm": _norm(sd, "video_model.norm"),
    }
    for i in range(config.depth):
        p = f"video_model.blocks.{i}"
        video[f"blocks_{i}"] = {
            **{n: _norm(sd, f"{p}.{n}") for n in ("norm1", "norm2", "norm3")},
            **{a: {"qkv": _linear(sd, f"{p}.{a}.qkv"), "proj": _linear(sd, f"{p}.{a}.proj")}
               for a in ("attn", "timeattn")},
            "mlp_fc1": _linear(sd, f"{p}.mlp.fc1"),
            "mlp_fc2": _linear(sd, f"{p}.mlp.fc2"),
        }
    text_sd = {k[len("text_model."):]: v for k, v in sd.items() if k.startswith("text_model.")}
    return {"video": video, "text": distilbert_params_from_torch(text_sd, config.text),
            "vid_proj": _linear(sd, "vid_proj.0"), "txt_proj": _linear(sd, "txt_proj.1")}
