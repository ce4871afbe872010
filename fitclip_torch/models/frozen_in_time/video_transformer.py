"""Frozen-in-Time's SpaceTimeTransformer (divided space-time ViT) in PyTorch:
port of ``fitclip_tpu/models/frozen_in_time/video_transformer.py``.

Per block: time attention (norm3, then attention over the frames at each
patch location) added to the input; space attention (norm1 of that, then
attention over the patches of each frame) added to the ORIGINAL input; then
the MLP (exact GELU). The CLS row attends over every row, and its key/value
joins every time and space group. Positions: the per-frame spatial embedding
tiled over the frames plus the temporal embedding repeated per frame. LN eps
1e-6, fp32 statistics; softmax fp32.

Module names mirror the JAX parameter tree (``blocks.3.timeattn.qkv`` is
``blocks_3/timeattn/qkv``), so ``convert/from_jax.py:fit_params_from_jax``
and the act-scale sites map one to one. Dense layers are the CLIP port's
``Dense``/``QuantDense`` (float, static or dynamic int8).

``fused`` runs the attention cores through ``ops/attention.py``'s
``fused_attention_qkv_gkv`` (K5, space) and ``fused_time_attention`` (K6,
time), with the qkv projection applied to the CLS row and the patch rows
separately, as the JAX module does; the CLS row's global attention stays
plain PyTorch there, as it is XLA in JAX.
"""

from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

from fitclip_torch.models.clip.model import LayerNormFp32, _dense
from fitclip_torch.ops.attention import fused_attention_qkv_gkv, fused_time_attention
from fitclip_torch.ops.fit_block import FIT_LN_EPS, prepare_fit_int8_layer
from fitclip_torch.utils.precision import fp32_convolutions
from fitclip_torch.utils.profiling import count


class LayerNormTorch(LayerNormFp32):
    """FiT's LayerNorm: fp32 two-pass statistics, eps 1e-6."""

    def __init__(self, width: int, dtype: torch.dtype, device=None):
        super().__init__(width, dtype, FIT_LN_EPS, device)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


def cls_global_attention(qkv_cls: torch.Tensor, qkv_rows: torch.Tensor, heads: int) -> torch.Tensor:
    """The CLS row's attention over [itself | every row of qkv_rows]:
    qkv_cls (B, 1, 3W), qkv_rows (B, N, 3W) -> (B, 1, W) in the qkv dtype.
    q scaled in the qkv dtype, fp32 logits and softmax, weights cast to v's
    dtype, P.V in fp32 (video_transformer.py:_cls_global_attention_split)."""
    width = qkv_cls.shape[-1] // 3
    head_dim = width // heads
    kv = torch.cat([qkv_cls, qkv_rows], dim=1)
    q = _heads(qkv_cls[:, 0, :width], heads) * head_dim ** -0.5      # (B, H, D)
    k = _heads(kv[..., width:2 * width], heads).float()              # (B, N, H, D)
    v = _heads(kv[..., 2 * width:], heads)
    weights = torch.softmax(torch.einsum("bhd,bnhd->bhn", q.float(), k), dim=-1).to(v.dtype)
    out = torch.einsum("bhn,bnhd->bhd", weights.float(), v.float())
    return out.reshape(-1, 1, width).to(qkv_cls.dtype)


class VarAttention(nn.Module):
    """Time or space attention with the global CLS row (video_transformer.py:
    VarAttention): each group's softmax runs over [CLS | group] in fp32, the
    weights are cast to the compute dtype, P.V accumulates in fp32."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype, fused: bool = False,
                 quantized: Union[bool, str] = False, device=None):
        super().__init__()
        self.heads, self.fused = heads, fused
        self.qkv = _dense(quantized, dim, 3 * dim, dtype, device)
        self.proj = _dense(quantized, dim, dim, dtype, device)

    def forward(self, x: torch.Tensor, mode: str, frames: int, patches: int) -> torch.Tensor:
        b = x.shape[0]
        width = x.shape[-1]
        h, d = self.heads, width // self.heads
        if self.fused:
            qkv_cls, qkv_rows = self.qkv(x[:, :1]), self.qkv(x[:, 1:])
            gkv = qkv_cls[:, 0].contiguous()
            if mode == "space":
                groups = qkv_rows.reshape(b * frames, patches, 3 * width)
                gkv = gkv.repeat_interleave(frames, dim=0)
                out = fused_attention_qkv_gkv(groups, gkv, h, d ** -0.5)
                out = out.reshape(b, frames * patches, width)
            else:
                out = fused_time_attention(qkv_rows.contiguous(), gkv, h, frames, d ** -0.5)
            cls_out = cls_global_attention(qkv_cls, qkv_rows, h)
            return self.proj(torch.cat([cls_out, out.to(cls_out.dtype)], dim=1).to(x.dtype))

        qkv = self.qkv(x)
        cls_out = cls_global_attention(qkv[:, :1], qkv[:, 1:], h)
        q, k, v = (_heads(t[:, 1:], h).reshape(b, frames, patches, h, d)
                   for t in qkv.split(width, dim=-1))
        q = (q * d ** -0.5).float()
        cls_k, cls_v = (_heads(t, h)[:, 0] for t in qkv[:, :1].split(width, dim=-1)[1:])
        if mode == "time":  # each location attends over the frames
            logits = torch.einsum("bfphd,bgphd->bphfg", q, k.float())
            cls_l = torch.einsum("bfphd,bhd->bphf", q, cls_k.float())
            w = torch.softmax(torch.cat([cls_l[..., None], logits], dim=-1), dim=-1).to(v.dtype)
            w = w.float()
            out = (torch.einsum("bphfg,bgphd->bfphd", w[..., 1:], v.float())
                   + torch.einsum("bphf,bhd->bfphd", w[..., 0], cls_v.float()))
        else:  # each frame's patches attend over the frame
            logits = torch.einsum("bfphd,bfqhd->bfhpq", q, k.float())
            cls_l = torch.einsum("bfphd,bhd->bfhp", q, cls_k.float())
            w = torch.softmax(torch.cat([cls_l[..., None], logits], dim=-1), dim=-1).to(v.dtype)
            w = w.float()
            out = (torch.einsum("bfhpq,bfqhd->bfphd", w[..., 1:], v.float())
                   + torch.einsum("bfhp,bhd->bfphd", w[..., 0], cls_v.float()))
        out = torch.cat([cls_out.float(), out.reshape(b, frames * patches, width)], dim=1)
        return self.proj(out.to(x.dtype))


class SpaceTimeBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype, fused_attention: bool = False,
                 quantized: Union[bool, str] = False, device=None):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNormTorch(dim, dtype, device)
        self.norm2 = LayerNormTorch(dim, dtype, device)
        self.norm3 = LayerNormTorch(dim, dtype, device)
        self.attn = VarAttention(dim, heads, dtype, fused_attention, quantized, device)
        self.timeattn = VarAttention(dim, heads, dtype, fused_attention, quantized, device)
        self.mlp_fc1 = _dense(quantized, dim, 4 * dim, dtype, device)
        self.mlp_fc2 = _dense(quantized, 4 * dim, dim, dtype, device)
        self._int8_cache = None

    def forward(self, x: torch.Tensor, frames: int, patches: int) -> torch.Tensor:
        t = x + self.timeattn(self.norm3(x), "time", frames, patches)
        s = x + self.attn(self.norm1(t), "space", frames, patches)  # residual from x
        return s + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(s))))

    def int8_operands(self):
        """The block's folded int8 operands (ops/fit_block.prepare_fit_int8_layer),
        refolded whenever a source tensor changes (identity, storage or
        in-place version), as the CLIP block's."""
        sources = [t for n in (self.norm1, self.norm2, self.norm3) for t in (n.weight, n.bias)]
        for dense in (self.timeattn.qkv, self.timeattn.proj, self.attn.qkv, self.attn.proj,
                      self.mlp_fc1, self.mlp_fc2):
            sources += [dense.weight_q, dense.scale, dense.bias, dense.act_scale]
        key = tuple((id(t), t.data_ptr(), t._version) for t in sources)
        if self._int8_cache is None or self._int8_cache[0] != key:
            count("operand_folds")
            self._int8_cache = (key, prepare_fit_int8_layer(self))
        return self._int8_cache[1]


class SpaceTimeTransformer(nn.Module):
    """(B, F, H, W, 3) normalized video -> (B, embed_dim): the final LayerNorm
    of the CLS row (head and pre-logits are the identity, as FrozenInTime sets
    them). F may be below num_frames: the tiled embeddings are sliced."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, img_size: int = 224, num_frames: int = 4,
                 dtype: torch.dtype = torch.float32, fused_attention: bool = False,
                 quantized: Union[bool, str] = False, device=None):
        super().__init__()
        self.dtype, self.num_heads, self.patch_size = dtype, num_heads, patch_size
        self.num_frames, self.quantized = num_frames, quantized
        self.num_patches = (img_size // patch_size) ** 2
        # (embed_dim, 3, p, p): the JAX unfold + (p*p*3, embed_dim) dense as a conv.
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size, device=device)
        self.cls_token = nn.Parameter(torch.zeros(embed_dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(self.num_patches + 1, embed_dim, device=device))
        self.temporal_embed = nn.Parameter(torch.zeros(num_frames, embed_dim, device=device))
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(embed_dim, num_heads, dtype, fused_attention, quantized, device)
            for _ in range(depth))
        self.norm = LayerNormTorch(embed_dim, dtype, device)

    def patch_tokens(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, P, embed_dim) patch embeddings without the bias."""
        x = frames.to(self.dtype).permute(0, 3, 1, 2)
        with fp32_convolutions():  # the reference's Precision.HIGHEST
            x = F.conv2d(x, self.patch_embed.weight.to(self.dtype), stride=self.patch_size)
        return x.flatten(2).transpose(1, 2)

    def positions(self) -> torch.Tensor:
        """fp32 (1 + num_frames * P, embed_dim): pos[0] for the CLS row, then
        pos[1 + r] + temporal[f] for patch r of frame f."""
        pos = self.pos_embed.float()
        tiled = pos[1:].repeat(self.num_frames, 1) + \
            self.temporal_embed.float().repeat_interleave(self.num_patches, dim=0)
        return torch.cat([pos[:1], tiled], dim=0)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, f = video.shape[:2]
        x = self.patch_tokens(video.reshape(b * f, *video.shape[2:]))
        x = x + self.patch_embed.bias.to(self.dtype)
        x = x.reshape(b, f * self.num_patches, -1)
        cls = self.cls_token.to(self.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positions()[: x.shape[1]].to(self.dtype)
        for block in self.blocks:
            x = block(x, f, self.num_patches)
        return self.norm(x[:, 0])
