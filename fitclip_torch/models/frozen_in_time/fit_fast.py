"""Inference forward of Frozen-in-Time's int8 video tower, one K4 block per
SpaceTimeBlock: port of ``fitclip_tpu/models/frozen_in_time/fit_fast.py``.

It takes the same int8 ``SpaceTimeTransformer`` as the module path, so
calibrated or persisted scales serve both. The prologue mirrors the JAX fast
path: the patch embedding as a strided conv, the patch bias and the tiled
position and temporal embeddings folded into one shift (sliced to the clip's
frames), the CLS row ``cls + pos[0]``; then the blocks on the joint
(B, 1 + F * P, W) rows, and the final LayerNorm of the CLS row. Inference only.
"""

from typing import Callable

import torch

from fitclip_torch.models.clip.model import layer_norm_fp32
from fitclip_torch.models.frozen_in_time.video_transformer import SpaceTimeTransformer
from fitclip_torch.ops.fit_block import FIT_LN_EPS, fused_fit_int8_layer


@torch.no_grad()
def encode_video_features_fast(model: SpaceTimeTransformer, video: torch.Tensor,
                               layer_fn: Callable = fused_fit_int8_layer) -> torch.Tensor:
    """(B, F, H, W, 3) normalized video -> (B, embed_dim) CLS features in the
    model's dtype. layer_fn runs one block: the kernel path by default,
    ops/fit_block.fused_fit_int8_layer_plain the plain one."""
    if model.quantized is not True:
        raise ValueError("the fast path runs static int8 models only; run a float model "
                         "with fused_block=False")
    b, f = video.shape[:2]
    dtype, patches = model.dtype, model.num_patches
    x = model.patch_tokens(video.reshape(b * f, *video.shape[2:]))
    x = x.reshape(b, f * patches, -1)
    positions = model.positions()
    patch_shift = (model.patch_embed.bias.float() + positions[1:])[: f * patches]
    cls = (model.cls_token.float() + positions[0]).to(dtype)
    x = torch.cat([cls.expand(b, 1, -1), x + patch_shift.to(dtype)], dim=1)
    for block in model.blocks:
        x = layer_fn(x, block.int8_operands(), block.heads, f)
    return layer_norm_fp32(x[:, 0], model.norm.weight, model.norm.bias, FIT_LN_EPS, dtype)
