"""Inference forward for SLIP, one fused layer per transformer block: port of
``fitclip_tpu/models/slip_fast.py``.

SLIP's towers are the CLIP ``Transformer``, so they run CLIP's fast path
(``models/clip/fast_eval._run_blocks``: K1 for an int8 model, K2 for a float
one) with the block's own constants: exact GELU and LayerNorm eps 1e-6 in the
vision tower, QuickGELU, eps 1e-5 and the causal mask in the text tower. The
vision prologue is timm's: the patch embedding as a strided conv, the bias and
position add on the patch rows, the batch-invariant CLS row built once, no
``ln_pre``; then the final ``norm`` and the image projection. Text pools the
argmax-EOT row. Inference only.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from fitclip_torch.models.clip.fast_eval import _run_blocks


@torch.no_grad()
def encode_frames_fast(model, frames: torch.Tensor,
                       layer_fn: Optional[Callable] = None) -> torch.Tensor:
    """(N, H, W, 3) ImageNet-normalized frames -> (N, embed_dim) SLIP image
    embeddings in the model's dtype. layer_fn replaces the default layer."""
    v, dtype = model.visual, model.dtype
    p, width = v.config.patch_size, v.config.vision_width
    # The patch Dense's (width, p*p*3) rows are ordered (ph, pw, c): a
    # (width, 3, p, p) conv kernel after a reshape.
    kernel = v.patch_embed.weight.to(dtype).reshape(width, p, p, 3).permute(0, 3, 1, 2)
    x = F.conv2d(frames.to(dtype).permute(0, 3, 1, 2), kernel, stride=p)
    pos = v.pos_embed.to(dtype)
    x = x.flatten(2).transpose(1, 2) + (v.patch_embed.bias.to(dtype) + pos[1:])
    cls_row = (v.cls_token.to(dtype) + pos[0])[None, None]
    x = torch.cat([cls_row.expand(x.shape[0], 1, width), x], dim=1)
    x = _run_blocks(x, v.blocks, model.quantized, layer_fn)
    return v.norm(x[:, 0]) @ model.image_projection.to(dtype)


@torch.no_grad()
def encode_text_fast(model, input_ids: torch.Tensor,
                     layer_fn: Optional[Callable] = None) -> torch.Tensor:
    """(B, context) token ids -> (B, embed_dim); EOT = the first max id per row."""
    x = _run_blocks(model.embed_text(input_ids), model.transformer, model.quantized, layer_fn)
    return model.pool_text(x, input_ids)
