"""The port's ViT CLIP weights -> an OpenAI-schema (``clip`` package) state
dict: the counterpart of
``fitclip_tpu/convert/flax_to_torch.py:clip_torch_state_dict_from_params``.

It takes a ``CLIPModel`` state dict (``encoder.model.state_dict()``, or a
port train checkpoint's ``encoder.*`` params without the prefix) and gives the
keys and layouts that ``convert/torch_state_dict.py`` reads back, so the pair
is an identity. The port's modules already keep OpenAI's layouts (dense
weights (out, in), the patch embedding a (width, 3, p, p) conv), so the map
only renames. OpenAI's conv1 has no bias: ``visual.conv1.bias`` is written
only when the patch embedding's bias is non-zero (after training, or a folded
pixel normalization), as the JAX exporter does.
"""

from typing import Dict, Mapping

import torch

_LAYER = (("attn.in_proj.weight", "attn.in_proj_weight"),
          ("attn.in_proj.bias", "attn.in_proj_bias"),
          ("attn.out_proj.weight", "attn.out_proj.weight"),
          ("attn.out_proj.bias", "attn.out_proj.bias"),
          ("ln_1.weight", "ln_1.weight"), ("ln_1.bias", "ln_1.bias"),
          ("ln_2.weight", "ln_2.weight"), ("ln_2.bias", "ln_2.bias"),
          ("mlp_fc.weight", "mlp.c_fc.weight"), ("mlp_fc.bias", "mlp.c_fc.bias"),
          ("mlp_proj.weight", "mlp.c_proj.weight"), ("mlp_proj.bias", "mlp.c_proj.bias"))


def _layers(state: Mapping[str, torch.Tensor], prefix: str) -> int:
    return len({k[len(prefix):].split(".")[0] for k in state if k.startswith(prefix)})


def openai_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """CLIPModel state dict (float) -> OpenAI ``clip`` naming, fp32 CPU tensors."""
    if "visual.patch_embed.weight" not in state:
        raise ValueError("openai_state_dict takes a ViT CLIP's float weights (a CLIPModel "
                         f"state dict); got keys {sorted(state)[:3]}...")
    if any(k.endswith(".weight_q") for k in state):
        raise ValueError("openai_state_dict takes float weights; this state dict is an int8 "
                         "encoder's (export the float encoder it was quantized from)")
    out: Dict[str, torch.Tensor] = {}

    def put(key, name):
        out[key] = state[name].detach().to("cpu", torch.float32, copy=True)

    def tower(prefix, source):
        for i in range(_layers(state, f"{source}.")):
            for name, key in _LAYER:
                put(f"{prefix}.resblocks.{i}.{key}", f"{source}.{i}.{name}")

    put("visual.conv1.weight", "visual.patch_embed.weight")
    if bool(state["visual.patch_embed.bias"].abs().max() > 0):
        put("visual.conv1.bias", "visual.patch_embed.bias")
    for name in ("class_embedding", "positional_embedding"):
        put(f"visual.{name}", f"visual.{name}")
    for leaf in ("weight", "bias"):
        put(f"visual.ln_pre.{leaf}", f"visual.ln_pre.{leaf}")
    tower("visual.transformer", "visual.transformer.blocks")
    for leaf in ("weight", "bias"):
        put(f"visual.ln_post.{leaf}", f"visual.ln_post.{leaf}")
    put("visual.proj", "visual.proj")
    put("token_embedding.weight", "text.token_embedding")
    put("positional_embedding", "text.positional_embedding")
    tower("transformer", "text.transformer.blocks")
    for leaf in ("weight", "bias"):
        put(f"ln_final.{leaf}", f"text.ln_final.{leaf}")
    put("text_projection", "text.text_projection")
    return out
