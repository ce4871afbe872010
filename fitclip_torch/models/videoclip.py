"""VideoCLIP (fairseq MMPT's MMFusionSeparate) in PyTorch: port of
``fitclip_tpu/models/videoclip.py``.

- video: consecutive ``frames_per_clip`` windows of a video each become one S3D-G
  clip feature (the fast forward on K7 in bf16 and int8, the module path in
  fp32), then VideoTokenMLP and a 6-layer BERT over [CLS] v_1..v_n [SEP] with
  the MMPT position scheme (0..n for [CLS] and the clips, max_video_len + 1 for
  the video [SEP]), then a masked mean that excludes [CLS];
- text: a 12-layer BERT over [CLS] + caption + [SEP] (the tokenizer puts an
  extra [SEP] after [CLS], which ``forward_text`` drops), masked mean without
  [CLS].

The BERT layers are post-LN with fp32 LayerNorm (eps 1e-12), fp32 logits and
softmax and exact GELU; their denses run in the fusion dtype (bf16 for a bf16
or int8 encoder), and the residual stream stays fp32, as JAX's type promotion
keeps it. No TPU kernel serves the fusion: its denses and attention are plain
PyTorch (cuBLAS on the card).
"""

import dataclasses
import logging
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fitclip_torch.convert.from_jax import videoclip_params_from_jax
from fitclip_torch.models.clip.load import _DTYPES, LoadedEncoder, resolve_device
from fitclip_torch.models.clip.model import Dense, LayerNormFp32
from fitclip_torch.convert.torch_state_dict import load_torch_state_dict
from fitclip_torch.data.frame_sampler import ConsecutiveFrameSampler
from fitclip_torch.models.api import PreprocessSpec
from fitclip_torch.models.mil_nce import torch_tree_to_jax
from fitclip_torch.models.s3dg import S3DG, init_s3dg_params
from fitclip_torch.models.s3dg_fast import quantize_s3dg_fast, s3dg_fast_apply
from fitclip_torch.ops.quant import apply_act_scales, dynamic_observing, observed_act_amax
from fitclip_torch.utils.profiling import span

LOGGER = logging.getLogger(__name__)
BERT_LN_EPS = 1e-12
MLP_LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2

    @staticmethod
    def tiny_test(vocab_size: int = 100) -> "BertConfig":
        return BertConfig(vocab_size=vocab_size, hidden_size=32, num_layers=2, num_heads=4,
                          intermediate_size=64, max_position_embeddings=64)


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        d, hidden = config.hidden_size, config.intermediate_size
        self.heads = config.num_heads
        for name in ("attention_query", "attention_key", "attention_value", "attention_output"):
            setattr(self, name, Dense(d, d, dtype))
        self.attention_layernorm = LayerNormFp32(d, torch.float32, BERT_LN_EPS)
        self.intermediate = Dense(d, hidden, dtype)
        self.output = Dense(hidden, d, dtype)
        self.output_layernorm = LayerNormFp32(d, torch.float32, BERT_LN_EPS)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        b, seq, width = x.shape
        head_dim = width // self.heads

        def heads(t):
            return t.reshape(b, seq, self.heads, head_dim).transpose(1, 2)

        q, k, v = (heads(getattr(self, f"attention_{n}")(x)) for n in ("query", "key", "value"))
        logits = (q.float() @ k.float().transpose(-1, -2)) / head_dim ** 0.5
        keep = (attention_mask > 0)[:, None, None, :]
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = (weights.float() @ v.float()).to(v.dtype).transpose(1, 2).reshape(b, seq, width)
        x = self.attention_layernorm(x + self.attention_output(attn))
        h = self.output(F.gelu(self.intermediate(x)))
        return self.output_layernorm(x + h)


class BertEncoderModel(nn.Module):
    """BERT embeddings (positions and token types added to the given inputs) and
    post-LN layers; the hidden state is fp32."""

    def __init__(self, config: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.position_embeddings = nn.Parameter(
            torch.zeros(config.max_position_embeddings, config.hidden_size))
        self.token_type_embeddings = nn.Parameter(
            torch.zeros(config.type_vocab_size, config.hidden_size))
        self.embeddings_layernorm = LayerNormFp32(config.hidden_size, torch.float32, BERT_LN_EPS)
        self.layers = nn.ModuleList(BertLayer(config, dtype) for _ in range(config.num_layers))

    def forward(self, inputs_embeds, position_ids, token_type_ids, attention_mask):
        x = (inputs_embeds.float() + self.position_embeddings[position_ids]
             + self.token_type_embeddings[token_type_ids])
        x = self.embeddings_layernorm(x)
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x


class VideoTokenMLP(nn.Module):
    """Linear -> exact GELU -> LayerNorm (eps 1e-5) -> Linear, in ``dtype``."""

    def __init__(self, feature_dim: int, hidden_size: int, dtype: torch.dtype):
        super().__init__()
        self.linear1 = Dense(feature_dim, hidden_size, dtype)
        self.layernorm = LayerNormFp32(hidden_size, dtype, MLP_LN_EPS)
        self.linear2 = Dense(hidden_size, hidden_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.layernorm(F.gelu(self.linear1(x))))


def _masked_mean(hidden: torch.Tensor, pool_mask: torch.Tensor) -> torch.Tensor:
    pool_mask = pool_mask / pool_mask.sum(dim=1, keepdim=True)
    return torch.einsum("bld,bl->bd", hidden.float(), pool_mask)


class VideoClipModel(nn.Module):
    """MMFusionSeparate: a video MMBert and a text BERT, each tower with its own
    word embeddings."""

    def __init__(self, config: BertConfig = BertConfig(), num_video_layers: int = 6,
                 max_video_len: int = 32, video_feature_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.max_video_len = config, max_video_len
        self.video_word_embeddings = nn.Parameter(torch.zeros(config.vocab_size,
                                                              config.hidden_size))
        self.text_word_embeddings = nn.Parameter(torch.zeros(config.vocab_size,
                                                             config.hidden_size))
        self.videomlp = VideoTokenMLP(video_feature_dim, config.hidden_size, dtype)
        self.video_bert = BertEncoderModel(
            dataclasses.replace(config, num_layers=num_video_layers), dtype)
        self.text_bert = BertEncoderModel(config, dtype)

    def forward_video(self, vfeats: torch.Tensor, vmasks: torch.Tensor, cls_id: int,
                      sep_id: int) -> torch.Tensor:
        """vfeats (B, n, feature_dim), vmasks (B, n) -> (B, hidden) fp32."""
        b, n = vfeats.shape[:2]
        ones = torch.ones(b, 1, dtype=torch.int64, device=vfeats.device)
        tokens = self.videomlp(vfeats).float()
        cls = self.video_word_embeddings[cls_id].expand(b, 1, -1)
        sep = self.video_word_embeddings[sep_id].expand(b, 1, -1)
        embeds = torch.cat([cls, tokens, sep], dim=1)
        positions = torch.cat([torch.arange(n + 1, device=vfeats.device),
                               torch.tensor([self.max_video_len + 1], device=vfeats.device)])
        attention_mask = torch.cat([ones, vmasks.long(), ones], dim=1)
        hidden = self.video_bert(embeds, positions[None, :], torch.zeros_like(attention_mask),
                                 attention_mask)
        pool_mask = torch.cat([torch.zeros_like(ones), vmasks.long(), ones], dim=1).float()
        return _masked_mean(hidden, pool_mask)

    def forward_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """input_ids framed [CLS] [SEP] caption [SEP]: the extra [SEP] column is dropped."""
        ids = torch.cat([input_ids[:, :1], input_ids[:, 2:]], dim=1)
        mask = torch.cat([attention_mask[:, :1], attention_mask[:, 2:]], dim=1)
        positions = torch.arange(ids.shape[1], device=ids.device)[None, :]
        hidden = self.text_bert(self.text_word_embeddings[ids], positions,
                                torch.zeros_like(ids), mask)
        pool_mask = torch.cat([torch.zeros_like(mask[:, :1]), mask[:, 1:]], dim=1).float()
        return _masked_mean(hidden, pool_mask)


class VideoClipVideoTextEncoder(nn.Module):
    CLS_ID = 101  # bert-base-uncased [CLS]
    SEP_ID = 102  # bert-base-uncased [SEP]

    def __init__(self, config: Optional[BertConfig] = None, dtype: torch.dtype = torch.float32,
                 quantized: bool = False, fast: Optional[bool] = None,
                 int8_from: Optional[str] = "mixed_4b", num_frames: int = 32,
                 max_tokens: int = 64, frames_per_clip: int = 32,
                 vocab_path: Optional[str] = None):
        super().__init__()
        self.config = config or BertConfig()
        if quantized:
            dtype = torch.bfloat16
        self.dtype, self.quantized = dtype, quantized
        self.fast = (quantized or dtype == torch.bfloat16) if fast is None else bool(fast)
        if quantized and not self.fast:
            raise ValueError("int8 S3DG requires the fast eval forward")
        if self.fast and dtype != torch.bfloat16:
            raise ValueError("the fast S3DG forward runs in bf16")
        self.num_frames, self.max_tokens, self.frames_per_clip = (num_frames, max_tokens,
                                                                  frames_per_clip)
        self.vocab_path, self._tokenizer = vocab_path, None
        self.preprocess = PreprocessSpec(
            num_frames=num_frames, image_size=224, mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
            train_frame_sampler=ConsecutiveFrameSampler(num_frames, fps=30),
            eval_frame_sampler=ConsecutiveFrameSampler(num_frames, fps=30),
            resize_mode="bilinear", should_pad_batch=False, pad_to_min_frames=num_frames,
            max_tokens=max_tokens)
        self.s3dg = S3DG(dtype=dtype, int8_from=int8_from if quantized else False)
        self.model = VideoClipModel(self.config, dtype=dtype)

    def _clips(self, video: torch.Tensor) -> torch.Tensor:
        """uint8 or [0, 1] (B, T, H, W, 3) -> (B * n, frames_per_clip, H, W, 3) fp32."""
        if video.dtype == torch.uint8:
            video = video.float() / 255.0
        b, t = video.shape[:2]
        n_clips = max(t // self.frames_per_clip, 1)
        usable = n_clips * self.frames_per_clip
        return video[:, :usable].reshape(b * n_clips, self.frames_per_clip, *video.shape[2:])

    def clip_features(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) -> (B, n_clips, 512) S3D-G clip features."""
        clips = self._clips(video)
        if self.fast:
            features = s3dg_fast_apply(self.s3dg, clips, self.dtype, int8=self.quantized)
        else:
            features = self.s3dg(clips)
        return features.reshape(video.shape[0], -1, features.shape[-1])

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) raw pixels -> (B, hidden) fp32."""
        features = self.clip_features(video)
        vmasks = torch.ones(features.shape[:2], dtype=torch.int64, device=features.device)
        return self.model.forward_video(features, vmasks, self.CLS_ID, self.SEP_ID)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        """(B, L) WordPiece ids framed [CLS] [SEP] caption [SEP] ([PAD] = 0) -> (B, hidden)."""
        return self.model.forward_text(text, (text != 0).long())

    @torch.no_grad()
    def collect_act_amax(self, video: torch.Tensor, text=None):
        """One calibration observation over the S3D-G sites, as
        {"s3dg/int8/<site>": (1, 1) abs-max}; the fusion is not quantized."""
        if not self.quantized:
            raise ValueError("calibration requires a quantized encoder")
        with dynamic_observing(self.s3dg.int8):
            s3dg_fast_apply(self.s3dg, self._clips(video), self.dtype, int8=True)
        return {f"s3dg/int8/{site}": amax
                for site, amax in observed_act_amax(self.s3dg.int8).items()}

    def calibrate(self, video: torch.Tensor, text=None,
                  margin: float = 1.0) -> "VideoClipVideoTextEncoder":
        """Post-training calibration on one batch, in place."""
        with span("calibrate"):
            apply_act_scales(self, self.collect_act_amax(video, text), margin=margin)
        return self

    def get_tokenizer(self):
        """texts -> (B, max_tokens) ids framed [CLS] [SEP] caption [SEP] ([PAD] = 0)."""
        if self._tokenizer is None:
            from fitclip_torch.text.wordpiece import WordPieceTokenizer

            inner = WordPieceTokenizer(vocab_path=self.vocab_path, max_tokens=self.max_tokens)
            self._tokenizer = lambda texts: inner(texts, prefix_sep=True)["input_ids"]
            self._tokenizer.inner = inner
        return self._tokenizer


# --- parameters (numpy, the JAX tree's layout) -------------------------------

def _bert_tower_params(sd, prefix: str, layers: int) -> dict:
    def ln(p):
        return {"weight": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}

    def lin(p):
        return {"kernel": sd[f"{p}.weight"].T, "bias": sd[f"{p}.bias"]}

    params = {
        "position_embeddings": sd[f"{prefix}.embeddings.position_embeddings.weight"],
        "token_type_embeddings": sd[f"{prefix}.embeddings.token_type_embeddings.weight"],
        "embeddings_layernorm": ln(f"{prefix}.embeddings.LayerNorm"),
    }
    for i in range(layers):
        p = f"{prefix}.encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention_query": lin(f"{p}.attention.self.query"),
            "attention_key": lin(f"{p}.attention.self.key"),
            "attention_value": lin(f"{p}.attention.self.value"),
            "attention_output": lin(f"{p}.attention.output.dense"),
            "attention_layernorm": ln(f"{p}.attention.output.LayerNorm"),
            "intermediate": lin(f"{p}.intermediate.dense"),
            "output": lin(f"{p}.output.dense"),
            "output_layernorm": ln(f"{p}.output.LayerNorm"),
        }
    return params


def videoclip_params_from_torch(state_dict, config: BertConfig = BertConfig(),
                                num_video_layers: int = 6) -> dict:
    """Released VideoCLIP checkpoint (video_encoder.bert..., videomlp...,
    text_encoder...) -> the fusion model's tree."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()}
    return {
        "video_word_embeddings": sd["video_encoder.bert.embeddings.word_embeddings.weight"],
        "text_word_embeddings": sd["text_encoder.embeddings.word_embeddings.weight"],
        "videomlp": {
            "linear1": {"kernel": sd["video_encoder.videomlp.linear1.weight"].T,
                        "bias": sd["video_encoder.videomlp.linear1.bias"]},
            "layernorm": {"weight": sd["video_encoder.videomlp.LayerNorm.weight"],
                          "bias": sd["video_encoder.videomlp.LayerNorm.bias"]},
            "linear2": {"kernel": sd["video_encoder.videomlp.linear2.weight"].T,
                        "bias": sd["video_encoder.videomlp.linear2.bias"]},
        },
        "video_bert": _bert_tower_params(sd, "video_encoder.bert", num_video_layers),
        "text_bert": _bert_tower_params(sd, "text_encoder", config.num_layers),
    }


def init_videoclip_params(config: BertConfig, seed: int = 0, num_video_layers: int = 6,
                          video_feature_dim: int = 512) -> dict:
    """A seeded tree: ``init_s3dg_params`` for the S3D-G tower; normal(0.02) word,
    position and token-type embeddings, LeCun-normal dense kernels, zero biases
    and LayerNorms at ones and zeros for the fusion (numpy)."""
    rng = np.random.default_rng(seed + 2)
    d = config.hidden_size

    def dense(fan_in, fan_out):
        return {"kernel": rng.standard_normal((fan_in, fan_out), np.float32)
                / np.float32(math.sqrt(fan_in)), "bias": np.zeros(fan_out, np.float32)}

    def normal(*shape):
        return rng.standard_normal(shape, np.float32) * np.float32(0.02)

    def norm():
        return {"weight": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    def bert(layers):
        tower = {"position_embeddings": normal(config.max_position_embeddings, d),
                 "token_type_embeddings": normal(config.type_vocab_size, d),
                 "embeddings_layernorm": norm()}
        for i in range(layers):
            tower[f"layer_{i}"] = {
                **{f"attention_{n}": dense(d, d) for n in ("query", "key", "value", "output")},
                "attention_layernorm": norm(), "intermediate": dense(d, config.intermediate_size),
                "output": dense(config.intermediate_size, d), "output_layernorm": norm()}
        return tower

    model = {"video_word_embeddings": normal(config.vocab_size, d),
             "text_word_embeddings": normal(config.vocab_size, d),
             "videomlp": {"linear1": dense(video_feature_dim, d), "layernorm": norm(),
                          "linear2": dense(d, d)},
             "video_bert": bert(num_video_layers), "text_bert": bert(config.num_layers)}
    return {"s3dg": init_s3dg_params(seed), "model": model}


def load_videoclip_encoder(model_pretrained_path: Optional[str] = None,
                           video_encoder_pretrained_path: Optional[str] = None,
                           vocab_path: Optional[str] = None, dtype: str = "float32",
                           device="cuda", seed: int = 0, num_frames: int = 32,
                           max_tokens: int = 64, fast: Optional[bool] = None,
                           int8_from: Optional[str] = "mixed_4b",
                           config: Optional[BertConfig] = None) -> LoadedEncoder:
    """VideoCLIP (Xu et al., EMNLP 2021: S3D-G clip features of 32 frames, a
    6-layer video and a 12-layer text BERT of 768) on ``device``: the fusion from
    ``checkpoint_best.pt`` and the S3D-G tower from ``s3d_howto100m.pth``, each
    from ``seed`` when not given. ``dtype="int8"`` quantizes the S3D-G sites."""
    quantized = str(dtype) == "int8"
    if not quantized and str(dtype) not in _DTYPES:
        raise ValueError(f"Unknown encoder dtype {dtype!r} — expected one of "
                         f"{sorted(_DTYPES)} or 'int8'")
    device = resolve_device(device)
    config = config or BertConfig()
    encoder = VideoClipVideoTextEncoder(config, _DTYPES["bfloat16" if quantized else str(dtype)],
                                        quantized, fast, int8_from, num_frames, max_tokens,
                                        vocab_path=vocab_path)
    if not (model_pretrained_path and video_encoder_pretrained_path):
        LOGGER.warning("No checkpoint for part of VideoCLIP: initializing it from seed %d.",
                       seed)
    params = init_videoclip_params(config, seed)
    if model_pretrained_path:
        params["model"] = videoclip_params_from_torch(
            load_torch_state_dict(model_pretrained_path), config)
    if video_encoder_pretrained_path:
        params["s3dg"] = torch_tree_to_jax(load_torch_state_dict(video_encoder_pretrained_path))
    if quantized:
        params = dict(params, s3dg=quantize_s3dg_fast(params["s3dg"], int8_from))
    encoder.load_state_dict(videoclip_params_from_jax(params))
    return LoadedEncoder(encoder.to(device))
