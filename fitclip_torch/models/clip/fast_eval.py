"""Inference forward for int8 CLIP, one fused int8 layer per transformer
block: port of ``fitclip_tpu/models/clip/fast_eval.py``.

It takes the same int8 ``CLIPModel`` as the module path and runs each block
through ``ops/block.fused_int8_layer`` (the Hopper kernels on the card; their
plain versions on the CPU), on the operands each block folds once. The
embedding math mirrors the JAX fast path: the patch embedding as a strided
conv, ``ln_pre`` applied separately to the patch rows and to the
batch-invariant CLS row, an optional padded sequence with masked keys
(``pad_seq``/``seq_valid``), then ``ln_post``/``proj``, or argmax-EOT pooling
for text. Inference only: the layer kernels have no gradient.

A float model has no fast path yet: its whole-layer kernel is the TPU's
``fused_bf16_layer`` (K2), which is not ported.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from fitclip_torch.models.clip.model import CLIPModel
from fitclip_torch.ops.block import fused_int8_layer


def _require_int8(model: CLIPModel) -> None:
    if model.quantized is not True:
        raise NotImplementedError(
            "the fast path runs int8 models only: the float whole-layer kernel "
            "(fitclip_tpu/ops/block.py:fused_bf16_layer, K2) is the next kernel "
            "to port; run a float model with fused_block=False")


def _run_blocks(x, transformer, layer_fn: Callable, seq_valid: Optional[int] = None):
    for block in transformer.blocks:
        x = layer_fn(x, block.int8_operands(), block.heads, causal=block.causal,
                     ln_eps=block.ln_eps, seq_valid=seq_valid)
    return x


@torch.no_grad()
def encode_frames_fast(model: CLIPModel, frames: torch.Tensor, pad_seq: int = 0,
                       layer_fn: Callable = fused_int8_layer) -> torch.Tensor:
    """(N, H, W, 3) frames (uint8 with folded normalization, or normalized
    floats) -> (N, embed_dim) in the model's dtype. layer_fn runs one layer:
    the kernel path by default, ops/block.fused_int8_layer_plain the plain one."""
    _require_int8(model)
    v = model.visual
    dtype, width = model.dtype, v.config.width
    # ln_pre is per token, so it commutes with the row concat: the patch rows
    # get bias + position + LN, the batch-invariant CLS row is normalized once.
    pos = v.positional_embedding.to(dtype)
    patch_shift = v.patch_embed.bias.to(dtype) + pos[1:]
    x = v.ln_pre(v.patch_tokens(frames) + patch_shift)
    cls_row = v.ln_pre((v.class_embedding.to(dtype) + pos[:1])[None])
    x = torch.cat([cls_row.expand(x.shape[0], 1, width), x], dim=1)
    # Padded tail rows are masked as keys (seq_valid); row 0 never reads them.
    seq = x.shape[1]
    seq_valid = None
    if pad_seq and pad_seq > seq:
        x = F.pad(x, (0, 0, 0, pad_seq - seq))
        seq_valid = seq
    x = _run_blocks(x, v.transformer, layer_fn, seq_valid)
    return v.ln_post(x[:, 0]) @ v.proj.to(dtype)


@torch.no_grad()
def encode_text_fast(model: CLIPModel, input_ids: torch.Tensor,
                     layer_fn: Callable = fused_int8_layer) -> torch.Tensor:
    """(B, context) token ids -> (B, embed_dim); EOT = the first max id per row."""
    _require_int8(model)
    t = model.text
    x = _run_blocks(t.embed(input_ids), t.transformer, layer_fn)
    return t.pool(t.ln_final(x), input_ids)


# The JAX package's names for the int8 entry points.
encode_frames_int8 = encode_frames_fast
encode_text_int8 = encode_text_fast
