"""A CLIP torch checkpoint -> the port's ``CLIPModel`` state dict (port of
``fitclip_tpu/convert/torch_state_dict.py``).

Two naming schemas are read:

- "openai": the ``clip`` package layout (visual.conv1.weight,
  transformer.resblocks.N.attn.in_proj_weight, ...);
- "hf": HuggingFace ``CLIPModel`` (vision_model.encoder.layers.N.
  self_attn.q_proj.weight, ...).

``clip_tree_from_torch`` builds the JAX package's CLIP tree as numpy (layers
stacked, dense kernels (in, out)), as the JAX converter does;
``clip_params_from_torch`` maps that tree to the port's modules through
``convert/from_jax.py:params_from_jax``, the road an int8 load also takes
(``ops/quant.py:quantize_clip_params`` works on the tree).
"""

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from fitclip_torch.convert.from_jax import params_from_jax
from fitclip_torch.models.clip.model import CLIPConfig, TextConfig, VisionConfig


def load_torch_state_dict(path: str, strip_prefix: Optional[str] = None) -> Dict[str, np.ndarray]:
    """A torch checkpoint as fp32 numpy arrays: a plain state dict, a
    Lightning-style {"state_dict": ...}, or a pickled module. ``strip_prefix``
    keeps only the keys under that prefix, without it (e.g. "encoder.model.")."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        obj = obj.state_dict()
    out = {}
    for key, value in obj.items():
        if strip_prefix:
            if not key.startswith(strip_prefix):
                continue
            key = key[len(strip_prefix):]
        if hasattr(value, "detach"):
            out[key] = value.detach().to(torch.float32).cpu().numpy()
    return out


def detect_schema(state_dict: Mapping[str, np.ndarray]) -> str:
    if any(k.startswith("vision_model.") for k in state_dict):
        return "hf"
    if any(k.startswith("visual.") for k in state_dict):
        return "openai"
    raise ValueError("Unrecognized CLIP state-dict schema; expected 'visual.*' or "
                     "'vision_model.*' keys")


def config_from_openai_state_dict(state_dict: Mapping[str, np.ndarray]) -> CLIPConfig:
    """The CLIPConfig of an OpenAI-layout ViT state dict, from its shapes (the
    ``clip`` package's build_model arithmetic; heads = width / 64)."""
    if "visual.conv1.weight" not in state_dict:
        raise ValueError("Only ViT CLIP variants are supported by config inference for now")
    conv1 = state_dict["visual.conv1.weight"]  # (width, 3, p, p)
    width, patch = conv1.shape[0], conv1.shape[2]
    grid = int(round((state_dict["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    vision_layers = len({k.split(".")[3] for k in state_dict
                         if k.startswith("visual.transformer.resblocks.")})
    text_width = state_dict["ln_final.weight"].shape[0]
    text_layers = len({k.split(".")[2] for k in state_dict
                       if k.startswith("transformer.resblocks.")})
    return CLIPConfig(
        embed_dim=state_dict["text_projection"].shape[1],
        vision=VisionConfig(image_size=grid * patch, patch_size=patch, width=width,
                            layers=vision_layers, heads=width // 64),
        text=TextConfig(context_length=state_dict["positional_embedding"].shape[0],
                        vocab_size=state_dict["token_embedding.weight"].shape[0],
                        width=text_width, layers=text_layers, heads=text_width // 64))


# --- the JAX tree's layout, shared with models/slip.py ----------------------------

def _stack(arrays):
    return np.stack(arrays, axis=0)


def _patch_kernel(conv_weight: np.ndarray) -> np.ndarray:
    """torch conv (out, in=3, ph, pw) -> matmul kernel rows ordered (ph, pw, c)."""
    return conv_weight.transpose(2, 3, 1, 0).reshape(-1, conv_weight.shape[0])


def _dense_stack(sd, fmt, layers):
    return {"kernel": _stack([sd[fmt.format(i=i, leaf="weight")].T for i in range(layers)]),
            "bias": _stack([sd[fmt.format(i=i, leaf="bias")] for i in range(layers)])}


def _ln_stack(sd, fmt, layers):
    return {"ln": {"scale": _stack([sd[fmt.format(i=i, leaf="weight")] for i in range(layers)]),
                   "bias": _stack([sd[fmt.format(i=i, leaf="bias")] for i in range(layers)])}}


def _ln(sd, prefix):
    return {"ln": {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}}


def _openai_tower_blocks(sd, prefix: str, layers: int) -> dict:
    """OpenAI resblocks (in_proj_weight/in_proj_bias, c_fc/c_proj) in the scan layout."""
    r = prefix + ".resblocks.{i}."
    return {
        "attn": {"in_proj": {
                     "kernel": _stack([sd[r.format(i=i) + "attn.in_proj_weight"].T
                                       for i in range(layers)]),
                     "bias": _stack([sd[r.format(i=i) + "attn.in_proj_bias"]
                                     for i in range(layers)])},
                 "out_proj": _dense_stack(sd, r + "attn.out_proj.{leaf}", layers)},
        "ln_1": _ln_stack(sd, r + "ln_1.{leaf}", layers),
        "ln_2": _ln_stack(sd, r + "ln_2.{leaf}", layers),
        "mlp_fc": _dense_stack(sd, r + "mlp.c_fc.{leaf}", layers),
        "mlp_proj": _dense_stack(sd, r + "mlp.c_proj.{leaf}", layers),
    }


def _hf_tower_blocks(sd, prefix: str, layers: int) -> dict:
    """HF layers (separate q/k/v projections, layer_norm1/2, fc1/fc2) in the scan layout."""
    r = prefix + ".layers.{i}."

    def qkv(i, leaf):
        return np.concatenate([sd[r.format(i=i) + f"self_attn.{p}_proj.{leaf}"]
                               for p in "qkv"], axis=0)

    return {
        "attn": {"in_proj": {"kernel": _stack([qkv(i, "weight").T for i in range(layers)]),
                             "bias": _stack([qkv(i, "bias") for i in range(layers)])},
                 "out_proj": _dense_stack(sd, r + "self_attn.out_proj.{leaf}", layers)},
        "ln_1": _ln_stack(sd, r + "layer_norm1.{leaf}", layers),
        "ln_2": _ln_stack(sd, r + "layer_norm2.{leaf}", layers),
        "mlp_fc": _dense_stack(sd, r + "mlp.fc1.{leaf}", layers),
        "mlp_proj": _dense_stack(sd, r + "mlp.fc2.{leaf}", layers),
    }


def clip_tree_from_torch(state_dict: Mapping[str, np.ndarray], config: CLIPConfig) -> dict:
    """The JAX package's CLIP tree (numpy, fp32) from an OpenAI- or HF-layout state dict."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()}
    width = config.vision.width
    if detect_schema(sd) == "openai":
        visual = {
            # OpenAI's conv1 has no bias; zeros give the pixel-normalization fold a slot.
            "patch_embed": {"kernel": _patch_kernel(sd["visual.conv1.weight"]),
                            "bias": sd.get("visual.conv1.bias", np.zeros(width, np.float32))},
            "class_embedding": sd["visual.class_embedding"],
            "positional_embedding": sd["visual.positional_embedding"],
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "transformer": {"blocks": _openai_tower_blocks(sd, "visual.transformer",
                                                           config.vision.layers)},
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": sd["visual.proj"],
        }
        text = {
            "token_embedding": sd["token_embedding.weight"],
            "positional_embedding": sd["positional_embedding"],
            "transformer": {"blocks": _openai_tower_blocks(sd, "transformer",
                                                           config.text.layers)},
            "ln_final": _ln(sd, "ln_final"),
            "text_projection": sd["text_projection"],
        }
    else:
        # HF historically misspells pre_layrnorm; accept both.
        pre_ln = ("vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd
                  else "vision_model.pre_layernorm")
        visual = {
            "patch_embed": {
                "kernel": _patch_kernel(sd["vision_model.embeddings.patch_embedding.weight"]),
                "bias": sd.get("vision_model.embeddings.patch_embedding.bias",
                               np.zeros(width, np.float32))},
            "class_embedding": sd["vision_model.embeddings.class_embedding"].reshape(-1),
            "positional_embedding": sd["vision_model.embeddings.position_embedding.weight"],
            "ln_pre": _ln(sd, pre_ln),
            "transformer": {"blocks": _hf_tower_blocks(sd, "vision_model.encoder",
                                                       config.vision.layers)},
            "ln_post": _ln(sd, "vision_model.post_layernorm"),
            "proj": sd["visual_projection.weight"].T,
        }
        text = {
            "token_embedding": sd["text_model.embeddings.token_embedding.weight"],
            "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
            "transformer": {"blocks": _hf_tower_blocks(sd, "text_model.encoder",
                                                       config.text.layers)},
            "ln_final": _ln(sd, "text_model.final_layer_norm"),
            "text_projection": sd["text_projection.weight"].T,
        }
    return {"visual": visual, "text": text}


def clip_params_from_torch(state_dict: Mapping[str, np.ndarray],
                           config: CLIPConfig) -> Dict[str, torch.Tensor]:
    """A CLIP state dict (OpenAI or HF layout) -> ``CLIPModel.load_state_dict``'s (float)."""
    return params_from_jax(clip_tree_from_torch(state_dict, config), config)
