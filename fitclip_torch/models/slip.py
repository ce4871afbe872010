"""SLIP encoder family (facebookresearch/SLIP's CLIP/SLIP variants): port of
``fitclip_tpu/models/slip.py``.

A timm-style ViT vision tower (patch Dense with bias over unfolded patches, a
CLS token, a position embedding that includes the CLS row, LayerNorm eps 1e-6,
exact GELU, a final norm, CLS pooling) and a CLIP-style causal text
transformer (QuickGELU, eps 1e-5), with separate image and text projections.
Both towers are the CLIP ``Transformer`` (``models/clip/model.py``), so SLIP
runs the CLIP layer kernels: K1 (with the exact-GELU epilogue in the vision
tower) or K2 through ``models/slip_fast.py``, K3f or K8 on the module path.

Module names mirror the JAX parameter tree (``visual.blocks.blocks.3.attn.
in_proj`` is ``visual/blocks/blocks/attn/in_proj`` at layer 3), so
``convert/from_jax.py`` and the act-scale files map one to one.

Evaluation only, as the reference (its train sampler raises).
``encode_text`` takes CLIP BPE ids (``get_tokenizer()``): the EOT token
carries the largest id of its row.
"""

import dataclasses
import logging
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from fitclip_torch.convert.from_jax import slip_params_from_jax, slip_params_to_jax
from fitclip_torch.convert.torch_state_dict import (_dense_stack, _ln_stack,
                                                   _openai_tower_blocks, _patch_kernel)
from fitclip_torch.data.frame_sampler import UniformFrameSampler
from fitclip_torch.models.api import PreprocessSpec
from fitclip_torch.models.clip.encoder import l2_normalize, prepare_frames
from fitclip_torch.models.clip.tokenizer import ClipTokenizer
from fitclip_torch.models.clip.load import _DTYPES, LoadedEncoder, resolve_device
from fitclip_torch.models.clip.model import (Dense, LayerNormFp32, TextConfig, Transformer,
                                             _truncated_normal)
from fitclip_torch.models import slip_fast
from fitclip_torch.ops.quant import (apply_act_scales, dynamic_observing, observed_act_amax,
                                     quantize_clip_params)
from fitclip_torch.utils.profiling import span

LOGGER = logging.getLogger(__name__)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VISION_LN_EPS = 1e-6
TEXT_LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class SlipConfig:
    embed_dim: int = 512
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    image_size: int = 224
    patch_size: int = 16
    text: TextConfig = TextConfig()

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @staticmethod
    def vit_s16() -> "SlipConfig":
        return SlipConfig(vision_width=384, vision_heads=12)

    @staticmethod
    def vit_b16() -> "SlipConfig":
        return SlipConfig()

    @staticmethod
    def vit_l16() -> "SlipConfig":
        return SlipConfig(vision_width=1024, vision_layers=24, vision_heads=16)

    @staticmethod
    def tiny_test(vocab_size: int = 64) -> "SlipConfig":
        return SlipConfig(embed_dim=32, vision_width=48, vision_layers=2, vision_heads=4,
                          image_size=32, patch_size=16,
                          text=TextConfig(context_length=16, vocab_size=vocab_size, width=32,
                                          layers=2, heads=4))


class TimmViT(nn.Module):
    """timm vision_transformer semantics: returns the normed CLS token."""

    def __init__(self, config: SlipConfig, dtype: torch.dtype, fused_attention: bool = False,
                 quantized=False, device=None):
        super().__init__()
        self.config, self.dtype = config, dtype
        w, p, g = config.vision_width, config.patch_size, config.grid_size
        # (width, p*p*3) over patch vectors ordered (ph, pw, c).
        self.patch_embed = Dense(p * p * 3, w, dtype, device)
        self.cls_token = nn.Parameter(torch.zeros(w, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(g * g + 1, w, device=device))
        self.blocks = Transformer(w, config.vision_layers, config.vision_heads, False,
                                  quick_gelu=False, dtype=dtype, fused_attention=fused_attention,
                                  ln_eps=VISION_LN_EPS, quantized=quantized, device=device)
        self.norm = LayerNormFp32(w, dtype, VISION_LN_EPS, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized images -> (B, width)."""
        b, g, p = images.shape[0], self.config.grid_size, self.config.patch_size
        x = images.to(self.dtype).reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(x.reshape(b, g * g, p * p * 3))
        cls = self.cls_token.to(self.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        return self.norm(self.blocks(x)[:, 0])


class SlipModel(nn.Module):
    def __init__(self, config: SlipConfig, dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False, quantized=False, device=None):
        super().__init__()
        self.config, self.dtype, self.quantized = config, dtype, quantized
        t = config.text
        self.visual = TimmViT(config, dtype, fused_attention, quantized, device)
        self.transformer = Transformer(t.width, t.layers, t.heads, True, quick_gelu=True,
                                       dtype=dtype, fused_attention=fused_attention,
                                       ln_eps=TEXT_LN_EPS, quantized=quantized, device=device)
        self.ln_final = LayerNormFp32(t.width, dtype, TEXT_LN_EPS, device)
        self.token_embedding = nn.Parameter(torch.zeros(t.vocab_size, t.width, device=device))
        self.positional_embedding = nn.Parameter(
            torch.zeros(t.context_length, t.width, device=device))
        self.image_projection = nn.Parameter(
            torch.zeros(config.vision_width, config.embed_dim, device=device))
        self.text_projection = nn.Parameter(torch.zeros(t.width, config.embed_dim, device=device))

    def embed_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding[input_ids].to(self.dtype)
        return x + self.positional_embedding[:x.shape[1]].to(self.dtype)

    def pool_text(self, x: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """ln_final, the row of the first maximal token id (EOT), the projection."""
        eot = torch.argmax(input_ids, dim=-1)
        x = self.ln_final(x[torch.arange(x.shape[0], device=x.device), eot])
        return x @ self.text_projection.to(x.dtype)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images) @ self.image_projection.to(self.dtype)

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.pool_text(self.transformer(self.embed_text(input_ids)), input_ids)


def init_slip_params(model: SlipModel, seed: int) -> SlipModel:
    """Seeded random init of a float SlipModel, in place, with the JAX
    package's initializers: LeCun-normal dense kernels (truncated, the patch
    embedding's too), zero biases and CLS token, normal(0.02) position and token
    embeddings, normal(0.01) text positions, normal(width^-0.5) projections,
    LayerNorms at ones and zeros. Draws on a CPU torch.Generator."""
    if model.quantized:
        raise ValueError("init_slip_params takes a float model; int8 models are "
                         "quantized from one (load_slip_encoder)")
    gen = torch.Generator().manual_seed(seed)

    def put(param, value):
        param.copy_(value.to(param.device))

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Dense):
                fan_in = module.weight.shape[1]
                put(module.weight, _truncated_normal(
                    module.weight.shape, (1 / fan_in) ** 0.5 / 0.87962566103423978, gen))
                module.bias.zero_()
            elif isinstance(module, LayerNormFp32):
                module.weight.fill_(1.0)
                module.bias.zero_()
        v, cfg = model.visual, model.config
        v.cls_token.zero_()
        put(v.pos_embed, torch.randn(v.pos_embed.shape, generator=gen) * 0.02)
        put(model.token_embedding, torch.randn(model.token_embedding.shape, generator=gen) * 0.02)
        put(model.positional_embedding,
            torch.randn(model.positional_embedding.shape, generator=gen) * 0.01)
        put(model.image_projection,
            torch.randn(model.image_projection.shape, generator=gen) * cfg.vision_width ** -0.5)
        put(model.text_projection,
            torch.randn(model.text_projection.shape, generator=gen) * cfg.text.width ** -0.5)
    return model


def _raise_train_sampler(*args, **kwargs):
    raise NotImplementedError("SLIP encoders are evaluation-only (reference "
                              "slip_video_text_encoder.py:66-75)")


class SlipVideoTextEncoder(nn.Module):
    """Eval-only wrapper: the frame-mean of L2-normalized frame embeddings
    (slip_video_text_encoder.py:25-99). uint8 video is ImageNet-normalized on
    the device. ``fused_block`` (default: quantized and fused_attention) runs
    ``models/slip_fast.py`` (K1 for int8, K2 for a float encoder); otherwise
    the module path runs (K8 for static int8 with fused_attention, K3f for a
    float encoder with fused_attention)."""

    trainable = False
    train_frame_sampler = staticmethod(_raise_train_sampler)

    def __init__(self, config: Optional[SlipConfig] = None, num_frames: int = 4,
                 dtype: torch.dtype = torch.float32, fused_attention: bool = False,
                 quantized: bool = False, fused_block: Optional[bool] = None, device=None,
                 bpe_path: Optional[str] = None):
        super().__init__()
        self.config = config or SlipConfig.vit_b16()
        self._bpe_path, self._tokenizer = bpe_path, None
        self.preprocess = PreprocessSpec(
            num_frames=num_frames, image_size=self.config.image_size, mean=IMAGENET_MEAN,
            std=IMAGENET_STD, train_frame_sampler=_raise_train_sampler,
            eval_frame_sampler=UniformFrameSampler(num_frames), resize_mode="bilinear",
            max_tokens=self.config.text.context_length)
        self.dtype, self.quantized, self.num_frames = dtype, quantized, num_frames
        self.fused_attention = fused_attention
        self.fused_block = (bool(quantized) and fused_attention
                            if fused_block is None else fused_block)
        self.mean, self.std = IMAGENET_MEAN, IMAGENET_STD
        self.model = SlipModel(self.config, dtype=dtype, fused_attention=fused_attention,
                               quantized=quantized, device=device)

    def _prepare_frames(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> (B*T, H, W, C) in the compute dtype."""
        return prepare_frames(video, self.dtype, self.mean, self.std)

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, D): the mean of the L2-normalized frame embeddings."""
        b, t = video.shape[0], video.shape[1]
        frames = self._prepare_frames(video)
        if self.fused_block:
            embeddings = slip_fast.encode_frames_fast(self.model, frames)
        else:
            embeddings = self.model.encode_image(frames)
        return l2_normalize(embeddings).reshape(b, t, -1).mean(dim=1)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        if self.fused_block:
            return l2_normalize(slip_fast.encode_text_fast(self.model, text))
        return l2_normalize(self.model.encode_text(text))

    @torch.no_grad()
    def collect_act_amax(self, video: torch.Tensor,
                         text: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
        """One calibration observation: both towers through the module path in
        dynamic-quant mode; {site: (layers, 1) abs-max}."""
        if not self.quantized:
            raise ValueError("calibration requires a quantized encoder")
        with dynamic_observing(self.model):
            self.model.encode_image(self._prepare_frames(video))
            amax = observed_act_amax(self.model, "visual/")
            if text is not None:
                self.model.encode_text(text)
                amax.update(observed_act_amax(self.model, "transformer/"))
        return amax

    def calibrate(self, video: torch.Tensor, text: Optional[torch.Tensor] = None,
                  margin: float = 1.0) -> "SlipVideoTextEncoder":
        """Post-training calibration on one batch: write the observed activation
        abs-maxes into the act_scale buffers, in place."""
        with span("calibrate"):
            apply_act_scales(self.model, self.collect_act_amax(video, text), margin=margin)
        return self

    def get_tokenizer(self) -> ClipTokenizer:
        """CLIP's byte-level BPE (``bpe_path``, else ``FITCLIP_BPE_PATH``)."""
        if self._tokenizer is None:
            self._tokenizer = ClipTokenizer(bpe_path=self._bpe_path,
                                            context_length=self.config.text.context_length)
        return self._tokenizer

    def decode_text(self, ids):
        tokenizer = self.get_tokenizer()
        for row in np.asarray(ids):
            yield tokenizer.decode(row[row != 0])


# --- a SLIP checkpoint's state dict -> the port --------------------------------
# The JAX layout is built as numpy (convert/torch_state_dict.py's helpers), and
# slip_params_from_jax then maps it.

def _timm_blocks(sd, prefix: str, layers: int) -> dict:
    return {
        "attn": {"in_proj": _dense_stack(sd, prefix + ".{i}.attn.qkv.{leaf}", layers),
                 "out_proj": _dense_stack(sd, prefix + ".{i}.attn.proj.{leaf}", layers)},
        "ln_1": _ln_stack(sd, prefix + ".{i}.norm1.{leaf}", layers),
        "ln_2": _ln_stack(sd, prefix + ".{i}.norm2.{leaf}", layers),
        "mlp_fc": _dense_stack(sd, prefix + ".{i}.mlp.fc1.{leaf}", layers),
        "mlp_proj": _dense_stack(sd, prefix + ".{i}.mlp.fc2.{leaf}", layers),
    }


def slip_tree_from_torch(state_dict: Mapping[str, object], config: SlipConfig) -> dict:
    """A SLIP checkpoint's state dict ("module." already stripped) -> the JAX
    package's SLIP tree with numpy leaves. The SSL heads are dropped."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()}

    def ln(prefix):
        return {"ln": {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}}

    visual = {
        "patch_embed": {"kernel": _patch_kernel(sd["visual.patch_embed.proj.weight"]),
                        "bias": sd["visual.patch_embed.proj.bias"]},
        "cls_token": sd["visual.cls_token"].reshape(-1),
        "pos_embed": sd["visual.pos_embed"].reshape(-1, config.vision_width),
        "blocks": {"blocks": _timm_blocks(sd, "visual.blocks", config.vision_layers)},
        "norm": ln("visual.norm"),
    }
    return {
        "visual": visual,
        "transformer": {"blocks": _openai_tower_blocks(sd, "transformer", config.text.layers)},
        "ln_final": ln("ln_final"),
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "image_projection": sd["image_projection"],
        "text_projection": sd["text_projection"],
    }


def slip_params_from_torch(state_dict: Mapping[str, object],
                           config: SlipConfig) -> Dict[str, torch.Tensor]:
    """A SLIP checkpoint's state dict -> SlipModel state dict (float)."""
    return slip_params_from_jax(slip_tree_from_torch(state_dict, config), config)


SLIP_MODEL_CONFIGS = {
    "VITS16": SlipConfig.vit_s16,
    "VITB16": SlipConfig.vit_b16,
    "VITL16": SlipConfig.vit_l16,
}


def load_slip_encoder(checkpoint_path: Optional[str] = None, model: str = "SLIP_VITB16",
                      num_frames: int = 4, dtype: str = "float32", device="cuda", seed: int = 0,
                      fused_attention: Optional[bool] = None,
                      fused_block: Optional[bool] = None,
                      bpe_path: Optional[str] = None) -> LoadedEncoder:
    """A SLIP encoder on a device (config/encoder/slip_* in the JAX package).

    A released checkpoint names its factory in ``args.model``; with no
    checkpoint the weights are initialized from ``seed``. ``dtype="int8"`` is
    the W8A8 inference configuration (bf16 activations, int8 block denses
    quantized through the JAX-layout tree, as ``load_clip_encoder`` does).
    The encoder runs on CUDA unless the caller asks for another device; on
    CUDA ``fused_attention`` defaults to True and ``fused_block`` follows
    ``quantized``, on the CPU both default to False."""
    quantized = str(dtype) == "int8"
    if not quantized and str(dtype) not in _DTYPES:
        raise ValueError(f"Unknown encoder dtype {dtype!r} — expected one of "
                         f"{sorted(_DTYPES)} or 'int8'")
    device = resolve_device(device)
    if fused_attention is None:
        fused_attention = device.type == "cuda"
    state_dict = None
    if checkpoint_path:
        checkpoint = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
        if "args" in checkpoint:
            model = checkpoint["args"].model
        raw = checkpoint.get("state_dict", checkpoint)
        state_dict = {k.replace("module.", ""): v.float().numpy() for k, v in raw.items()}
    variant = model.split("_")[-1]
    if variant not in SLIP_MODEL_CONFIGS:
        raise ValueError(f"Unknown SLIP model {model!r}: expected SLIP_ or CLIP_ + one of "
                         f"{sorted(SLIP_MODEL_CONFIGS)}")
    config = SLIP_MODEL_CONFIGS[variant]()
    encoder = SlipVideoTextEncoder(config, num_frames=num_frames,
                                   dtype=_DTYPES["bfloat16" if quantized else str(dtype)],
                                   fused_attention=fused_attention, quantized=quantized,
                                   fused_block=fused_block, device="cpu", bpe_path=bpe_path)
    if state_dict is not None:
        tree = slip_tree_from_torch(state_dict, config)
    else:
        LOGGER.warning("No checkpoint for SLIP %s: initializing from seed %d.", variant, seed)
        float_model = init_slip_params(SlipModel(config), seed)
        tree = slip_params_to_jax(float_model.state_dict(), config)
    if quantized:
        tree = quantize_clip_params(tree)
    encoder.model.load_state_dict(slip_params_from_jax(tree, config))
    return LoadedEncoder(encoder.to(device))
