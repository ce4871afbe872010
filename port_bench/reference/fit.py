"""Frozen-in-Time (Bain et al., ICCV 2021, arXiv:2104.00650) in plain float32
PyTorch, on weights in the FrozenInTime checkpoint's layout
(``video_model.blocks.3.timeattn.qkv.weight``, ``text_model.transformer.
layer.2.attention.q_lin.weight``, ``vid_proj.0.weight``, ...).

Video: the SpaceTimeTransformer with divided attention. Per block, time
attention (each patch location over its frames) added to the input, space
attention (each frame's patches) on the LayerNorm of that, added to the
ORIGINAL input, then the MLP. The CLS row attends over every row, and its key
and value join every time and space group. The final LayerNorm of the CLS
row, ``vid_proj``, L2-normalized (eps 1e-8). Text: DistilBERT with padding
(id 0) masked as keys, ReLU of the first row, ``txt_proj``, L2-normalized.
``bits`` runs the video tower's denses at that integer precision and
``text_bits`` DistilBERT's: the control.
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from port_bench.reference.common import (l2_normalize, layer_norm, merge_heads,
                                         softmax_attention, split_heads)
from port_bench.reference.quant import linear

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
VIDEO_LN_EPS = 1e-6
TEXT_LN_EPS = 1e-12
EMBED_EPS = 1e-8

Weights = Dict[str, torch.Tensor]


def _ln(x, w, prefix, eps):
    return layer_norm(x, w[prefix + ".weight"], w[prefix + ".bias"], eps)


def _lin(x, w, prefix, bits):
    return linear(x, w[prefix + ".weight"], w[prefix + ".bias"], bits)


def divided_attention(h: torch.Tensor, w: Weights, prefix: str, heads: int, frames: int,
                      mode: str, bits: Optional[int]) -> torch.Tensor:
    """h (B, 1 + F * P, D) -> the attention half's output (B, 1 + F * P, D)."""
    b, n, d = h.shape
    patches = (n - 1) // frames
    q, k, v = (split_heads(t, heads) for t in _lin(h, w, prefix + ".qkv", bits).chunk(3, -1))
    cls = softmax_attention(q[:, :, :1], k, v)                      # (B, H, 1, hd)

    def grouped(t):  # (B, H, F * P, hd) -> (B, H, groups, members, hd)
        t = t.reshape(b, heads, frames, patches, -1)
        return t.transpose(2, 3) if mode == "time" else t

    qr, kr, vr = grouped(q[:, :, 1:]), grouped(k[:, :, 1:]), grouped(v[:, :, 1:])
    groups = qr.shape[2]
    cls_k = k[:, :, :1, None].expand(-1, -1, groups, -1, -1)
    cls_v = v[:, :, :1, None].expand(-1, -1, groups, -1, -1)
    rows = softmax_attention(qr, torch.cat([cls_k, kr], dim=3), torch.cat([cls_v, vr], dim=3))
    if mode == "time":
        rows = rows.transpose(2, 3)
    rows = rows.reshape(b, heads, frames * patches, -1)
    out = merge_heads(torch.cat([cls, rows], dim=2))
    return _lin(out, w, prefix + ".proj", bits)


def encode_video(w: Weights, video: torch.Tensor, cfg: dict,
                 bits: Optional[int] = None) -> torch.Tensor:
    """uint8 (B, F, H, W, 3) -> (B, projection_dim), L2-normalized."""
    vcfg = cfg["video"]
    b, f = video.shape[:2]
    mean = torch.tensor(MEAN, device=video.device) * 255.0
    std = torch.tensor(STD, device=video.device) * 255.0
    x = ((video.float() - mean) / std).reshape(b * f, *video.shape[2:]).permute(0, 3, 1, 2)
    x = F.conv2d(x, w["video_model.patch_embed.proj.weight"],
                 w["video_model.patch_embed.proj.bias"], stride=vcfg["patch_size"])
    x = x.flatten(2).transpose(1, 2)                                 # (B * F, P, D)
    patches, dim = x.shape[1], x.shape[2]
    pos = w["video_model.pos_embed"].reshape(-1, dim)
    temporal = w["video_model.temporal_embed"].reshape(-1, dim)[:f]
    x = x.reshape(b, f, patches, dim) + pos[1:] + temporal[:, None]
    cls = (w["video_model.cls_token"].reshape(dim) + pos[0]).expand(b, 1, dim)
    x = torch.cat([cls, x.reshape(b, f * patches, dim)], dim=1)
    for i in range(vcfg["depth"]):
        p = f"video_model.blocks.{i}"
        t = x + divided_attention(_ln(x, w, p + ".norm3", VIDEO_LN_EPS), w, p + ".timeattn",
                                  vcfg["num_heads"], f, "time", bits)
        s = x + divided_attention(_ln(t, w, p + ".norm1", VIDEO_LN_EPS), w, p + ".attn",
                                  vcfg["num_heads"], f, "space", bits)
        hidden = F.gelu(_lin(_ln(s, w, p + ".norm2", VIDEO_LN_EPS), w, p + ".mlp.fc1", bits))
        x = s + _lin(hidden, w, p + ".mlp.fc2", bits)
    features = _ln(x[:, 0], w, "video_model.norm", VIDEO_LN_EPS)
    return l2_normalize(_lin(features, w, "vid_proj.0", None), EMBED_EPS)


def encode_text(w: Weights, ids: torch.Tensor, cfg: dict,
                text_bits: Optional[int] = None) -> torch.Tensor:
    """(B, L) WordPiece ids, 0 the padding -> (B, projection_dim), L2-normalized."""
    tcfg = cfg["text"]
    t = "text_model."
    x = w[t + "embeddings.word_embeddings.weight"][ids] + \
        w[t + "embeddings.position_embeddings.weight"][:ids.shape[1]]
    x = _ln(x, w, t + "embeddings.LayerNorm", TEXT_LN_EPS)
    seen = (ids != 0)[:, None, None, :]
    for i in range(tcfg["n_layers"]):
        p = f"{t}transformer.layer.{i}."
        q, k, v = (split_heads(_lin(x, w, p + "attention." + name, text_bits), tcfg["n_heads"])
                   for name in ("q_lin", "k_lin", "v_lin"))
        a = merge_heads(softmax_attention(q, k, v, seen))
        x = _ln(x + _lin(a, w, p + "attention.out_lin", text_bits), w, p + "sa_layer_norm",
                TEXT_LN_EPS)
        h = _lin(F.gelu(_lin(x, w, p + "ffn.lin1", text_bits)), w, p + "ffn.lin2", text_bits)
        x = _ln(x + h, w, p + "output_layer_norm", TEXT_LN_EPS)
    return l2_normalize(_lin(torch.relu(x[:, 0]), w, "txt_proj.1", None), EMBED_EPS)
