"""CLIP dual encoder (ViT vision tower + causal text transformer) in PyTorch:
port of ``fitclip_tpu/models/clip/model.py``.

Module names mirror the JAX parameter tree (``visual.transformer.blocks.3.
attn.in_proj`` is ``visual/transformer/blocks/attn/in_proj`` at layer 3), so
``convert/from_jax.py`` and the act-scale files map one to one. Parameters
live in fp32 and are cast to the activation dtype at use; LayerNorm
statistics and softmax are fp32. Each Transformer holds its layers in an
``nn.ModuleList``, where the JAX one is scan-stacked.

Dense layers come in three kinds, as in the JAX package: ``Dense`` (float),
and ``QuantDense`` in static or dynamic (calibration) int8 mode.

``remat`` is the JAX ``nn.remat`` of each residual block as activation
checkpointing: True recomputes the whole block in the backward pass; "dots"
keeps the dense products' outputs and the fused attention's output and
recomputes the elementwise work (LayerNorms, GELU, residual adds), as
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` does.
"""

import dataclasses
import functools
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from fitclip_torch.ops.attention import fused_attention_qkv, fused_int8_qkv_attention
from fitclip_torch.ops.block import prepare_bf16_layer, prepare_int8_layer
from fitclip_torch.ops.quant import QUANT_EPS, int8_dense, int8_dense_static, quantize_rint
from fitclip_torch.utils.precision import fp32_convolutions
from fitclip_torch.utils.profiling import count


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    vision: VisionConfig = VisionConfig()
    text: TextConfig = TextConfig()
    quick_gelu: bool = True

    @staticmethod
    def vit_b_32() -> "CLIPConfig":
        return CLIPConfig(vision=VisionConfig(patch_size=32))

    @staticmethod
    def vit_b_16() -> "CLIPConfig":
        return CLIPConfig()

    @staticmethod
    def vit_l_14(image_size: int = 224) -> "CLIPConfig":
        return CLIPConfig(
            embed_dim=768,
            vision=VisionConfig(image_size=image_size, patch_size=14, width=1024,
                                layers=24, heads=16),
            text=TextConfig(width=768, heads=12, layers=12))

    @staticmethod
    def tiny_test(vocab_size: int = 64) -> "CLIPConfig":
        """Small config for unit tests."""
        return CLIPConfig(
            embed_dim=32,
            vision=VisionConfig(image_size=32, patch_size=16, width=48, layers=2, heads=4),
            text=TextConfig(context_length=16, vocab_size=vocab_size, width=32,
                            layers=2, heads=4))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm_fp32(x, weight, bias, eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with fp32 statistics and arithmetic whatever x's dtype
    (model.py:_FastLayerNorm's math), returned in out_dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(out_dtype)


class LayerNormFp32(nn.Module):
    def __init__(self, width: int, dtype: torch.dtype, eps: float = 1e-5, device=None):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.ones(width, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_fp32(x, self.weight, self.bias, self.eps, self.dtype)


class Dense(nn.Module):
    """Float dense: fp32 parameters, math in the activation dtype.
    weight is (out, in), as nn.Linear's."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class QuantDense(nn.Module):
    """int8 W8A8 dense (ops/quant.py), zero weights until loaded. weight_q is
    (out, in) int8 with per-output-channel scale; act_scale is the calibrated
    per-tensor activation abs-max (all ones until calibrated).

    ``dynamic`` selects per-row activation quant (calibration). While
    ``observe`` is set, each call records the abs-max of its input in
    ``observed_amax`` (the JAX module's sown ``act_amax``)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 dynamic: bool = False, device=None):
        super().__init__()
        self.dtype, self.dynamic = dtype, dynamic
        self.observe = False
        self.observed_amax: Optional[torch.Tensor] = None
        self.register_buffer("weight_q", torch.zeros(out_features, in_features,
                                                     dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(out_features, device=device))
        self.register_buffer("bias", torch.zeros(out_features, device=device))
        self.register_buffer("act_scale", torch.ones(1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.observe:
            self.observed_amax = x.float().abs().amax().reshape(1)
        if self.dynamic:
            return int8_dense(x.to(self.dtype), self.weight_q, self.scale, self.bias)
        return int8_dense_static(x.to(self.dtype), self.weight_q, self.scale, self.bias,
                                 self.act_scale)


def _dense(quantized, in_features: int, out_features: int, dtype, device):
    """quantized: False (float Dense), True (static int8) or "dynamic"."""
    if quantized:
        return QuantDense(in_features, out_features, dtype,
                          dynamic=(quantized == "dynamic"), device=device)
    return Dense(in_features, out_features, dtype, device)


def _einsum_attention(qkv: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    """The unfused attention of model.py:MultiHeadAttention: logits scaled
    after QK^T, fp32 softmax, weights and output in the activation dtype."""
    batch, seq, triple = qkv.shape
    width = triple // 3
    head_dim = width // heads
    q, k, v = (t.reshape(batch, seq, heads, head_dim).transpose(1, 2)
               for t in qkv.split(width, dim=-1))
    logits = (q.float() @ k.float().transpose(-1, -2)) * (head_dim ** -0.5)
    if causal:
        keep = torch.ones(seq, seq, dtype=torch.bool, device=qkv.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = weights @ v
    return out.transpose(1, 2).reshape(batch, seq, width)


class MultiHeadAttention(nn.Module):
    """Self-attention with one fused QKV projection (OpenAI's in_proj
    layout). With ``fused`` the core is ``ops/attention.fused_attention_qkv``
    (the Hopper kernel on the card); with ``fused`` and static int8 the QKV
    projection and the attention are ``ops/attention.fused_int8_qkv_attention``
    (K8), on the in_proj's weights and static act scale."""

    def __init__(self, width: int, heads: int, causal: bool, dtype: torch.dtype,
                 fused: bool = False, quantized=False, device=None):
        super().__init__()
        self.heads, self.causal, self.fused, self.quantized = heads, causal, fused, quantized
        self.in_proj = _dense(quantized, width, 3 * width, dtype, device)
        self.out_proj = _dense(quantized, width, width, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        static_int8 = self.quantized is True and not getattr(self.in_proj, "dynamic", False)
        if self.fused and static_int8:
            return self.out_proj(self._int8_qkv_attention(x))
        qkv = self.in_proj(x)
        head_dim = qkv.shape[-1] // 3 // self.heads
        if self.fused:
            out = fused_attention_qkv(qkv, self.heads, head_dim ** -0.5, self.causal)
        else:
            out = _einsum_attention(qkv, self.heads, self.causal)
        return self.out_proj(out)

    def _int8_qkv_attention(self, x: torch.Tensor) -> torch.Tensor:
        """model.py:_FusedInProjAttention: quantize x with the in_proj's static
        act scale, then K8. The in_proj still records its input's abs-max."""
        dense = self.in_proj
        if dense.observe:
            dense.observed_amax = x.float().abs().amax().reshape(1)
        act = dense.act_scale.float()
        x_q = quantize_rint(x.float() * (127.0 / torch.clamp_min(act, QUANT_EPS)))
        out_scale = (act / 127.0) * dense.scale.float()
        head_dim = x.shape[-1] // self.heads
        return fused_int8_qkv_attention(x_q, dense.weight_q, out_scale, dense.bias.float(),
                                        self.heads, head_dim ** -0.5, self.causal,
                                        out_dtype=dense.dtype)


class ResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool, quick_gelu: bool,
                 dtype: torch.dtype, fused_attention: bool = False, ln_eps: float = 1e-5,
                 quantized=False, device=None):
        super().__init__()
        self.heads, self.causal, self.quick_gelu, self.ln_eps = heads, causal, quick_gelu, ln_eps
        self.ln_1 = LayerNormFp32(width, dtype, ln_eps, device)
        self.attn = MultiHeadAttention(width, heads, causal, dtype, fused_attention,
                                       quantized, device)
        self.ln_2 = LayerNormFp32(width, dtype, ln_eps, device)
        self.mlp_fc = _dense(quantized, width, 4 * width, dtype, device)
        self.mlp_proj = _dense(quantized, 4 * width, width, dtype, device)
        self._fold_cache = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        h = self.mlp_fc(self.ln_2(x))
        h = quick_gelu(h) if self.quick_gelu else F.gelu(h)
        return x + self.mlp_proj(h)

    def _folded(self, kind: str, leaves, fold):
        """fold() of the layer, kept while every source tensor is unchanged: the
        key is each tensor's identity, storage and in-place version counter, so
        calibration, load_act_scales, load_state_dict and .to() all refold."""
        sources = [self.ln_1.weight, self.ln_1.bias, self.ln_2.weight, self.ln_2.bias]
        for dense in (self.attn.in_proj, self.attn.out_proj, self.mlp_fc, self.mlp_proj):
            sources += [getattr(dense, leaf) for leaf in leaves]
        key = (kind,) + tuple((id(t), t.data_ptr(), t._version) for t in sources)
        if self._fold_cache is None or self._fold_cache[0] != key:
            count("operand_folds")
            self._fold_cache = (key, fold())
        return self._fold_cache[1]

    def int8_operands(self):
        """The layer's folded int8 operands (ops/block.prepare_int8_layer), cached."""
        return self._folded("int8", ("weight_q", "scale", "bias", "act_scale"),
                            functools.partial(prepare_int8_layer, self, self.quick_gelu))

    def bf16_operands(self):
        """The float layer's operands (ops/block.prepare_bf16_layer): weights in
        the compute dtype, cached as int8_operands is."""
        return self._folded("bf16", ("weight", "bias"),
                            functools.partial(prepare_bf16_layer, self))


# Ops whose outputs remat="dots" keeps: the dense products (no batch dims, as
# F.linear dispatches them) and the fused attention. Batched products (the
# einsum attention's) are recomputed, as under dots_with_no_batch_dims_saveable.
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.fitclip.fused_attention_qkv.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(remat: Union[bool, str]):
    if remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    if remat is True:
        return None
    raise ValueError(f"remat must be False, True or 'dots', got {remat!r}")


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, causal: bool, quick_gelu: bool,
                 dtype: torch.dtype, fused_attention: bool = False, ln_eps: float = 1e-5,
                 quantized=False, device=None, remat: Union[bool, str] = False):
        super().__init__()
        self.remat = remat
        self._remat_context = _remat_context(remat) if remat else None
        self.blocks = nn.ModuleList(
            ResidualBlock(width, heads, causal, quick_gelu, dtype, fused_attention, ln_eps,
                          quantized, device)
            for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                kwargs = {"context_fn": self._remat_context} if self._remat_context else {}
                x = checkpoint(block, x, use_reentrant=False, **kwargs)
            else:
                x = block(x)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, config: VisionConfig, embed_dim: int, quick_gelu: bool,
                 dtype: torch.dtype, fused_attention: bool = False, quantized=False,
                 device=None, remat: Union[bool, str] = False):
        super().__init__()
        self.config, self.dtype = config, dtype
        w, p = config.width, config.patch_size
        # Weight (width, 3, p, p): a stride-p conv, the same map as the JAX
        # unfold + matmul with its (p*p*3, width) kernel.
        self.patch_embed = nn.Conv2d(3, w, p, stride=p, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(w, device=device))
        self.positional_embedding = nn.Parameter(
            torch.zeros(config.num_patches + 1, w, device=device))
        self.ln_pre = LayerNormFp32(w, dtype, device=device)
        self.transformer = Transformer(w, config.layers, config.heads, False, quick_gelu,
                                       dtype, fused_attention, quantized=quantized,
                                       device=device, remat=remat)
        self.ln_post = LayerNormFp32(w, dtype, device=device)
        self.proj = nn.Parameter(torch.zeros(w, embed_dim, device=device))

    def patch_tokens(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, g*g, width) patch embeddings without the bias."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        with fp32_convolutions():  # the reference's Precision.HIGHEST
            x = F.conv2d(x, self.patch_embed.weight.to(self.dtype), stride=self.config.patch_size)
        return x.flatten(2).transpose(1, 2)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3), normalized floats, or uint8 if the pixel
        normalization is folded into the patch embedding."""
        x = self.patch_tokens(images) + self.patch_embed.bias.to(self.dtype)
        cls = self.class_embedding.to(self.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(self.dtype)
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj.to(self.dtype)


class TextTransformer(nn.Module):
    def __init__(self, config: TextConfig, embed_dim: int, quick_gelu: bool,
                 dtype: torch.dtype, fused_attention: bool = False, quantized=False,
                 device=None, remat: Union[bool, str] = False):
        super().__init__()
        self.config, self.dtype = config, dtype
        w = config.width
        self.token_embedding = nn.Parameter(torch.zeros(config.vocab_size, w, device=device))
        self.positional_embedding = nn.Parameter(
            torch.zeros(config.context_length, w, device=device))
        self.transformer = Transformer(w, config.layers, config.heads, True, quick_gelu,
                                       dtype, fused_attention, quantized=quantized,
                                       device=device, remat=remat)
        self.ln_final = LayerNormFp32(w, dtype, device=device)
        self.text_projection = nn.Parameter(torch.zeros(w, embed_dim, device=device))

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding[input_ids].to(self.dtype)
        return x + self.positional_embedding[:x.shape[1]].to(self.dtype)

    def pool(self, x: torch.Tensor, input_ids: torch.Tensor) -> torch.Tensor:
        """EOT pooling: the row of the first maximal token id (CLIP's EOT
        carries the largest id), then the projection."""
        eot = torch.argmax(input_ids, dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection.to(x.dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids: (B, context_length) integer token ids."""
        x = self.transformer(self.embed(input_ids))
        return self.pool(self.ln_final(x), input_ids)


class CLIPModel(nn.Module):
    def __init__(self, config: CLIPConfig, dtype: torch.dtype = torch.float32,
                 fused_attention: bool = False, quantized=False, device=None,
                 remat: Union[bool, str] = False):
        super().__init__()
        self.config, self.dtype, self.quantized = config, dtype, quantized
        self.visual = VisionTransformer(config.vision, config.embed_dim, config.quick_gelu,
                                        dtype, fused_attention, quantized, device, remat=remat)
        self.text = TextTransformer(config.text, config.embed_dim, config.quick_gelu,
                                    dtype, fused_attention, quantized, device, remat=remat)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text(input_ids)

    def forward(self, images: torch.Tensor, input_ids: torch.Tensor):
        return self.encode_image(images), self.encode_text(input_ids)


def _truncated_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated to +-2 std by inverse CDF (flax's truncated_normal)."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(shape, generator=generator) * (hi - lo) + lo
    return torch.erfinv(2 * u - 1) * math.sqrt(2) * std


def init_float_params(model: CLIPModel, seed: int) -> CLIPModel:
    """Seeded random init of a float CLIPModel, in place, with the JAX
    package's initializers: LeCun-normal dense kernels (truncated), zero
    biases, normal(0.02) class/token embeddings, normal(0.01) positions,
    normal(width^-0.5) projections, LayerNorms at ones and zeros. Draws on a
    CPU torch.Generator, so a seed gives the same weights on every device."""
    if model.quantized:
        raise ValueError("init_float_params takes a float model; int8 models are "
                         "quantized from one (models/clip/load.py)")
    gen = torch.Generator().manual_seed(seed)

    def put(param, value):
        param.copy_(value.to(param.device))

    with torch.no_grad():
        for tower in (model.visual, model.text):
            for module in tower.modules():
                if isinstance(module, Dense):
                    fan_in = module.weight.shape[1]
                    put(module.weight, _truncated_normal(
                        module.weight.shape, (1 / fan_in) ** 0.5 / 0.87962566103423978, gen))
                    module.bias.zero_()
                elif isinstance(module, LayerNormFp32):
                    module.weight.fill_(1.0)
                    module.bias.zero_()
        v, t = model.visual, model.text
        fan_in = v.patch_embed.weight[0].numel()
        put(v.patch_embed.weight, _truncated_normal(
            v.patch_embed.weight.shape, (1 / fan_in) ** 0.5 / 0.87962566103423978, gen))
        v.patch_embed.bias.zero_()
        put(v.class_embedding, torch.randn(v.class_embedding.shape, generator=gen) * 0.02)
        put(v.positional_embedding,
            torch.randn(v.positional_embedding.shape, generator=gen) * 0.01)
        put(v.proj, torch.randn(v.proj.shape, generator=gen) * v.config.width ** -0.5)
        put(t.token_embedding, torch.randn(t.token_embedding.shape, generator=gen) * 0.02)
        put(t.positional_embedding,
            torch.randn(t.positional_embedding.shape, generator=gen) * 0.01)
        put(t.text_projection,
            torch.randn(t.text_projection.shape, generator=gen) * t.config.width ** -0.5)
    return model


def fold_pixel_normalization(model: CLIPModel, mean, std, scale_255: bool = True) -> CLIPModel:
    """Fold ((x / 255) - mean) / std into the patch embedding, in place.

    Afterwards ``encode_image`` takes raw uint8 pixels (cast to the compute
    dtype): W' = W / (255 * std_c) per input channel, b' = b - sum W * mean/std.
    Exact, because the patch embedding is affine in the pixels."""
    conv = model.visual.patch_embed
    with torch.no_grad():
        weight = conv.weight.float()
        mean = torch.as_tensor(mean, dtype=torch.float32, device=weight.device)
        std = torch.as_tensor(std, dtype=torch.float32, device=weight.device)
        denom = (255.0 if scale_255 else 1.0) * std
        shift = (mean / std)[None, :, None, None]
        conv.bias.copy_(conv.bias.float() - (weight * shift).sum(dim=(1, 2, 3)))
        conv.weight.copy_(weight / denom[None, :, None, None])
    return model
