"""CLIP ViT (Radford et al. 2021, arXiv:2103.00020) in plain float32 PyTorch,
on weights in OpenAI's checkpoint layout (``visual.conv1.weight``,
``transformer.resblocks.3.attn.in_proj_weight``, ...).

Video: each frame through the vision tower, L2-normalized, the mean over the
frames (the FitCLIP encoder's pooling). Text: the causal text tower, the row
of the end token (the largest id of its row), L2-normalized. ``bits`` runs
every dense of the towers at that precision (``quant.linear``) and
``stream`` rounds the residual stream after each block: the control.
Written without in-place operations, so autograd can differentiate it for
the training reference.
"""

from typing import Dict

import torch
import torch.nn.functional as F

from port_bench.reference.common import (l2_normalize, layer_norm, merge_heads, quick_gelu,
                                         softmax_attention, split_heads)
from port_bench.reference.quant import linear, round_tensor

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
LN_EPS = 1e-5

Weights = Dict[str, torch.Tensor]


def block(x: torch.Tensor, w: Weights, prefix: str, heads: int, causal: bool,
          quick: bool, bits, stream=None) -> torch.Tensor:
    """One residual block; ``bits`` rounds its denses, ``stream`` its output."""
    h = layer_norm(x, w[prefix + "ln_1.weight"], w[prefix + "ln_1.bias"], LN_EPS)
    q, k, v = (split_heads(t, heads) for t in linear(
        h, w[prefix + "attn.in_proj_weight"], w[prefix + "attn.in_proj_bias"], bits).chunk(3, -1))
    mask = None
    if causal:
        length = x.shape[-2]
        mask = torch.ones(length, length, dtype=torch.bool, device=x.device).tril()
    a = merge_heads(softmax_attention(q, k, v, mask))
    x = x + linear(a, w[prefix + "attn.out_proj.weight"], w[prefix + "attn.out_proj.bias"], bits)
    h = layer_norm(x, w[prefix + "ln_2.weight"], w[prefix + "ln_2.bias"], LN_EPS)
    h = linear(h, w[prefix + "mlp.c_fc.weight"], w[prefix + "mlp.c_fc.bias"], bits)
    h = quick_gelu(h) if quick else F.gelu(h)
    return round_tensor(
        x + linear(h, w[prefix + "mlp.c_proj.weight"], w[prefix + "mlp.c_proj.bias"], bits), stream)


def encode_frames(w: Weights, frames: torch.Tensor, cfg: dict, bits=None,
                  stream=None) -> torch.Tensor:
    """uint8 (N, H, W, 3) frames -> (N, embed_dim) frame embeddings."""
    vision = cfg["vision"]
    mean = torch.tensor(MEAN, device=frames.device) * 255.0
    std = torch.tensor(STD, device=frames.device) * 255.0
    x = ((frames.float() - mean) / std).permute(0, 3, 1, 2)
    x = F.conv2d(x, w["visual.conv1.weight"], w.get("visual.conv1.bias"),
                 stride=vision["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    cls = w["visual.class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + w["visual.positional_embedding"]
    x = layer_norm(x, w["visual.ln_pre.weight"], w["visual.ln_pre.bias"], LN_EPS)
    for i in range(vision["layers"]):
        x = block(x, w, f"visual.transformer.resblocks.{i}.", vision["heads"], False,
                  cfg["quick_gelu"], bits, stream)
    x = layer_norm(x[:, 0], w["visual.ln_post.weight"], w["visual.ln_post.bias"], LN_EPS)
    return x @ w["visual.proj"]


def encode_video(w: Weights, video: torch.Tensor, cfg: dict, bits=None,
                 stream=None) -> torch.Tensor:
    """uint8 (B, F, H, W, 3) -> (B, embed_dim): the mean of the L2-normalized
    frame embeddings."""
    b, f = video.shape[:2]
    frames = encode_frames(w, video.reshape(b * f, *video.shape[2:]), cfg, bits, stream)
    return l2_normalize(frames).reshape(b, f, -1).mean(dim=1)


def encode_text(w: Weights, ids: torch.Tensor, cfg: dict, bits=None,
                stream=None) -> torch.Tensor:
    """(B, context) token ids -> (B, embed_dim), L2-normalized."""
    text = cfg["text"]
    x = w["token_embedding.weight"][ids] + w["positional_embedding"][:ids.shape[1]]
    for i in range(text["layers"]):
        x = block(x, w, f"transformer.resblocks.{i}.", text["heads"], True, cfg["quick_gelu"],
                  bits, stream)
    x = layer_norm(x, w["ln_final.weight"], w["ln_final.bias"], LN_EPS)
    eot = torch.argmax(ids, dim=-1)
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return l2_normalize(x @ w["text_projection"])
