"""Inference forward for CLIP, one fused layer per transformer block: port of
``fitclip_tpu/models/clip/fast_eval.py``.

It takes the same ``CLIPModel`` as the module path and runs each block
through ``ops/block.fused_int8_layer`` (K1) for an int8 model or
``ops/block.fused_bf16_layer`` (K2) for a float one, as the JAX fast path
chooses by the tree's leaves: the Hopper kernels on the card, their plain
versions on the CPU, on the operands each block folds once. The embedding
math mirrors the JAX fast path: the patch embedding as a strided conv,
``ln_pre`` applied separately to the patch rows and to the batch-invariant CLS
row, an optional padded sequence with masked keys (``pad_seq``/``seq_valid``),
then ``ln_post``/``proj``, or argmax-EOT pooling for text. Inference only: the
layer kernels have no gradient.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from fitclip_torch.models.clip.model import CLIPModel
from fitclip_torch.ops.block import fused_bf16_layer, fused_int8_layer


def _run_blocks(x, transformer, quantized, layer_fn: Optional[Callable] = None,
                seq_valid: Optional[int] = None):
    """Each block of ``transformer`` as one layer: K1 on its folded int8
    operands if ``quantized``, else K2 on its compute-dtype operands. layer_fn
    replaces the default layer (the plain versions, say); the block gives its
    heads, causal mask, LayerNorm eps and, for K2, its GELU."""
    for block in transformer.blocks:
        if quantized:
            x = (layer_fn or fused_int8_layer)(
                x, block.int8_operands(), block.heads, causal=block.causal,
                ln_eps=block.ln_eps, seq_valid=seq_valid)
        else:
            x = (layer_fn or fused_bf16_layer)(
                x, block.bf16_operands(), block.heads, causal=block.causal,
                quick_gelu=block.quick_gelu, ln_eps=block.ln_eps, seq_valid=seq_valid)
    return x


@torch.no_grad()
def encode_frames_fast(model: CLIPModel, frames: torch.Tensor, pad_seq: int = 0,
                       layer_fn: Optional[Callable] = None) -> torch.Tensor:
    """(N, H, W, 3) frames (uint8 with folded normalization, or normalized
    floats) -> (N, embed_dim) in the model's dtype. layer_fn runs one layer:
    the kernel path by default, ops/block.fused_int8_layer_plain or
    fused_bf16_layer_plain the plain one."""
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
    x = _run_blocks(x, v.transformer, model.quantized, layer_fn, seq_valid)
    return v.ln_post(x[:, 0]) @ v.proj.to(dtype)


@torch.no_grad()
def encode_text_fast(model: CLIPModel, input_ids: torch.Tensor,
                     layer_fn: Optional[Callable] = None) -> torch.Tensor:
    """(B, context) token ids -> (B, embed_dim); EOT = the first max id per row."""
    t = model.text
    x = _run_blocks(t.embed(input_ids), t.transformer, model.quantized, layer_fn)
    return t.pool(t.ln_final(x), input_ids)


# The JAX package's names for the int8 entry points.
encode_frames_int8 = encode_frames_fast
encode_text_int8 = encode_text_fast
