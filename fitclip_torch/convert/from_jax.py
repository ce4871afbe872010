"""Map a JAX CLIP parameter tree (as numpy) to the port's modules and back.

The JAX tree (``fitclip_tpu/models/clip/model.py``) stacks each transformer's
layers on a leading axis, stores dense kernels as (in, out), LayerNorms as
``{"ln": {"scale", "bias"}}`` and the patch embedding as a (p*p*3, width)
kernel over patches ordered (ph, pw, c). An int8 tree (``quantize_clip_params``)
has ``kernel_q``/``scale``/``bias``/``act_scale`` in place of each block
dense's ``kernel``/``bias``. The port keeps one module per layer, dense
weights as (out, in), and the patch embedding as a (width, 3, p, p) conv.

``params_from_jax`` gives a state dict for ``CLIPModel.load_state_dict``;
``params_to_jax`` is its inverse. They let both packages compute the same
function in the tests, and carry the quantization of a torch-initialized
model through the one numpy ``quantize_clip_params``.

``fit_params_from_jax`` does the same for a Frozen-in-Time tree, whose blocks
are not stacked (``blocks_{i}``, ``layer_{i}``) and whose LayerNorms are
``{"weight", "bias"}``.

``s3dg_params_from_jax``, ``mil_nce_params_from_jax`` and
``videoclip_params_from_jax`` map the S3D-G family's trees. The S3DG and
MIL-NCE text modules keep the JAX names and layouts, so their float leaves only
rename; an ``int8`` subtree (``quantize_s3dg_fast``) maps as the int8 denses do.
The VideoCLIP BERT towers take (out, in) dense weights, as DistilBERT's.

``load_train_state_from_jax`` and ``train_state_to_jax`` carry a whole
training state across: the encoder params, the logit scales, the clamp, the
step and the fused AdamW state (``count``, ``mu``, ``nu``), whose moment trees
have the params' layout, with a 0-dim placeholder at each frozen leaf. The JAX
side is a dict of the TrainState's fields with numpy leaves.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch

from fitclip_torch.models.clip.model import CLIPConfig
from fitclip_torch.models.frozen_in_time.encoder import FrozenInTimeConfig
from fitclip_torch.training.state import TrainState, jax_param_path

_DENSES = (("attn", "in_proj"), ("attn", "out_proj"), ("mlp_fc",), ("mlp_proj",))
_LNS = ("ln_1", "ln_2")


def _t(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array))  # a writable, contiguous copy


def _get(node, path):
    for key in path:
        node = node[key]
    return node


def _blocks_from_jax(blocks, prefix: str, layers: int, out: Dict[str, torch.Tensor]):
    for i in range(layers):
        p = f"{prefix}.{i}"
        for name in _LNS:
            out[f"{p}.{name}.weight"] = _t(np.asarray(blocks[name]["ln"]["scale"][i], np.float32))
            out[f"{p}.{name}.bias"] = _t(np.asarray(blocks[name]["ln"]["bias"][i], np.float32))
        for path in _DENSES:
            layer = {key: np.asarray(value)[i] for key, value in _get(blocks, path).items()}
            _dense_from_jax(layer, f"{p}.{'.'.join(path)}", out)


def _ln_from_jax(node, name: str, out):
    out[f"{name}.weight"] = _t(np.asarray(node["ln"]["scale"], np.float32))
    out[f"{name}.bias"] = _t(np.asarray(node["ln"]["bias"], np.float32))


def params_from_jax(tree, config: CLIPConfig) -> Dict[str, torch.Tensor]:
    """JAX CLIP tree (float or int8, numpy leaves) -> CLIPModel state dict."""
    out: Dict[str, torch.Tensor] = {}
    v, t = tree["visual"], tree["text"]
    p, width = config.vision.patch_size, config.vision.width
    kernel = np.asarray(v["patch_embed"]["kernel"], np.float32)
    out["visual.patch_embed.weight"] = _t(kernel.reshape(p, p, 3, width).transpose(3, 2, 0, 1))
    out["visual.patch_embed.bias"] = _t(np.asarray(v["patch_embed"]["bias"], np.float32))
    for name in ("class_embedding", "positional_embedding", "proj"):
        out[f"visual.{name}"] = _t(np.asarray(v[name], np.float32))
    _ln_from_jax(v["ln_pre"], "visual.ln_pre", out)
    _ln_from_jax(v["ln_post"], "visual.ln_post", out)
    _blocks_from_jax(v["transformer"]["blocks"], "visual.transformer.blocks",
                     config.vision.layers, out)
    for name in ("token_embedding", "positional_embedding", "text_projection"):
        out[f"text.{name}"] = _t(np.asarray(t[name], np.float32))
    _ln_from_jax(t["ln_final"], "text.ln_final", out)
    _blocks_from_jax(t["transformer"]["blocks"], "text.transformer.blocks",
                     config.text.layers, out)
    return out


def _dense_from_jax(node, name: str, out) -> None:
    """A float ({kernel, bias}) or int8 ({kernel_q, scale, bias, act_scale})
    dense node -> (out, in) weights."""
    if "kernel_q" in node:
        out[f"{name}.weight_q"] = _t(np.asarray(node["kernel_q"], np.int8).T)
        out[f"{name}.scale"] = _t(np.asarray(node["scale"], np.float32))
        out[f"{name}.act_scale"] = _t(np.asarray(node["act_scale"], np.float32).reshape(1))
    else:
        out[f"{name}.weight"] = _t(np.asarray(node["kernel"], np.float32).T)
    out[f"{name}.bias"] = _t(np.asarray(node["bias"], np.float32))


def _vector(node, name: str, out) -> None:
    for key in ("weight", "bias"):
        out[f"{name}.{key}"] = _t(np.asarray(node[key], np.float32))


_FIT_DENSES = ("attn/qkv", "attn/proj", "timeattn/qkv", "timeattn/proj", "mlp_fc1", "mlp_fc2")
_BERT_DENSES = ("attention_q_lin", "attention_k_lin", "attention_v_lin", "attention_out_lin",
                "ffn_lin1", "ffn_lin2")


def fit_params_from_jax(tree, config: FrozenInTimeConfig) -> Dict[str, torch.Tensor]:
    """JAX Frozen-in-Time tree ({"video", "text", "vid_proj", "txt_proj"},
    numpy leaves, the video denses float or int8) ->
    FrozenInTimeVideoTextEncoder state dict."""
    out: Dict[str, torch.Tensor] = {}
    v, t = tree["video"], tree["text"]
    p, width = config.patch_size, config.embed_dim
    kernel = np.asarray(v["patch_embed"]["kernel"], np.float32)
    out["video.patch_embed.weight"] = _t(kernel.reshape(p, p, 3, width).transpose(3, 2, 0, 1))
    out["video.patch_embed.bias"] = _t(np.asarray(v["patch_embed"]["bias"], np.float32))
    for name in ("cls_token", "pos_embed", "temporal_embed"):
        out[f"video.{name}"] = _t(np.asarray(v[name], np.float32))
    _vector(v["norm"], "video.norm", out)
    for i in range(config.depth):
        block, prefix = v[f"blocks_{i}"], f"video.blocks.{i}"
        for name in ("norm1", "norm2", "norm3"):
            _vector(block[name], f"{prefix}.{name}", out)
        for path in _FIT_DENSES:
            _dense_from_jax(_get(block, path.split("/")), f"{prefix}.{path.replace('/', '.')}",
                            out)
    for name in ("word_embeddings", "position_embeddings"):
        out[f"text.{name}"] = _t(np.asarray(t[name], np.float32))
    _vector(t["embeddings_layer_norm"], "text.embeddings_layer_norm", out)
    for i in range(config.text.n_layers):
        layer, prefix = t[f"layer_{i}"], f"text.layers.{i}"
        for name in ("sa_layer_norm", "output_layer_norm"):
            _vector(layer[name], f"{prefix}.{name}", out)
        for name in _BERT_DENSES:
            _dense_from_jax(layer[name], f"{prefix}.{name}", out)
    for name in ("vid_proj", "txt_proj"):
        _dense_from_jax(tree[name], name, out)
    return out


def _np(state, key) -> np.ndarray:
    return state[key].detach().cpu().numpy()


def _blocks_to_jax(state, prefix: str, layers: int):
    def stack(suffix, transpose=False):
        arrays = [_np(state, f"{prefix}.{i}.{suffix}") for i in range(layers)]
        return np.stack([a.T if transpose else a for a in arrays])

    blocks = {name: {"ln": {"scale": stack(f"{name}.weight"), "bias": stack(f"{name}.bias")}}
              for name in _LNS}
    blocks["attn"] = {}
    for path in _DENSES:
        name = ".".join(path)
        if f"{prefix}.0.{name}.weight_q" in state:
            node = {"kernel_q": stack(f"{name}.weight_q", transpose=True),
                    "scale": stack(f"{name}.scale"), "bias": stack(f"{name}.bias"),
                    "act_scale": stack(f"{name}.act_scale")}
        else:
            node = {"kernel": stack(f"{name}.weight", transpose=True),
                    "bias": stack(f"{name}.bias")}
        parent = blocks["attn"] if path[0] == "attn" else blocks
        parent[path[-1]] = node
    return blocks


def params_to_jax(state: Dict[str, torch.Tensor], config: CLIPConfig):
    """CLIPModel state dict -> JAX CLIP tree with numpy leaves."""
    p, width = config.vision.patch_size, config.vision.width

    def ln(name):
        return {"ln": {"scale": _np(state, f"{name}.weight"), "bias": _np(state, f"{name}.bias")}}

    conv = _np(state, "visual.patch_embed.weight")  # (width, 3, p, p)
    visual = {
        "patch_embed": {"kernel": conv.transpose(2, 3, 1, 0).reshape(p * p * 3, width),
                        "bias": _np(state, "visual.patch_embed.bias")},
        "class_embedding": _np(state, "visual.class_embedding"),
        "positional_embedding": _np(state, "visual.positional_embedding"),
        "proj": _np(state, "visual.proj"),
        "ln_pre": ln("visual.ln_pre"), "ln_post": ln("visual.ln_post"),
        "transformer": {"blocks": _blocks_to_jax(state, "visual.transformer.blocks",
                                                 config.vision.layers)},
    }
    text = {
        "token_embedding": _np(state, "text.token_embedding"),
        "positional_embedding": _np(state, "text.positional_embedding"),
        "text_projection": _np(state, "text.text_projection"),
        "ln_final": ln("text.ln_final"),
        "transformer": {"blocks": _blocks_to_jax(state, "text.transformer.blocks",
                                                 config.text.layers)},
    }
    return {"visual": visual, "text": text}


def _fill_placeholders(moments, params):
    """The moment tree with each 0-dim placeholder (a frozen leaf) replaced by
    zeros of its parameter's shape."""
    if isinstance(moments, Mapping):
        return {k: _fill_placeholders(moments[k], params[k]) for k in moments}
    moment, param = np.asarray(moments), np.asarray(params)
    return np.zeros(param.shape, np.float32) if moment.ndim == 0 and param.ndim else moment


def _named_from_jax(tree, config: CLIPConfig) -> Dict[str, torch.Tensor]:
    named = {f"encoder.{k}": v for k, v in params_from_jax(tree["encoder"], config).items()}
    named.update((k, _t(np.asarray(v, np.float32))) for k, v in tree.items() if k != "encoder")
    return named


def load_train_state_from_jax(state: TrainState, jax_state: Mapping[str, Any],
                              config: CLIPConfig) -> TrainState:
    """Copy a JAX TrainState ({"step", "params", "opt_state": {"count", "mu",
    "nu"}, "max_logit_scale"}, numpy leaves, fused AdamW layout) into ``state``,
    a port state of the same configuration, in place. Frozen parameters keep
    the port's placeholder moments."""
    params = jax_state["params"]
    values = _named_from_jax(params, config)
    with torch.no_grad():
        for name, param in state.named_parameters().items():
            param.copy_(values[name])
        for key in ("mu", "nu"):
            moments = _named_from_jax(_fill_placeholders(jax_state["opt_state"][key], params),
                                      config)
            for name, target in state.opt_state[key].items():
                if target.dim():
                    target.copy_(moments[name])
        state.max_logit_scale.copy_(_t(np.asarray(jax_state["max_logit_scale"], np.float32)))
    state.opt_state["count"] = int(np.asarray(jax_state["opt_state"]["count"]))
    state.step = int(np.asarray(jax_state["step"]))
    return state


def _set_placeholders(tree, frozen, prefix=""):
    if isinstance(tree, Mapping):
        return {k: _set_placeholders(v, frozen, f"{prefix}{k}/") for k, v in tree.items()}
    return np.zeros((), np.float32) if prefix.rstrip("/") in frozen else tree


def _tree_from_named(named: Mapping[str, torch.Tensor], config: CLIPConfig):
    encoder = {k[len("encoder."):]: v for k, v in named.items() if k.startswith("encoder.")}
    tree = {"encoder": params_to_jax(encoder, config)}
    tree.update((k, _np(named, k)) for k in named if not k.startswith("encoder."))
    return tree


def train_state_to_jax(state: TrainState, config: CLIPConfig) -> Dict[str, Any]:
    """The inverse of ``load_train_state_from_jax``: a dict of the JAX
    TrainState's fields with numpy leaves. numpy has no bfloat16, so bf16
    moments come back as fp32 arrays holding the same values."""
    named = state.named_parameters()

    def moments(key):
        stored = state.opt_state[key]
        frozen = {jax_param_path(n) for n, m in stored.items() if m.dim() < named[n].dim()}
        full = {n: (m if m.dim() == named[n].dim() else torch.zeros_like(named[n])).float()
                for n, m in stored.items()}
        return _set_placeholders(_tree_from_named(full, config), frozen)

    return {"step": np.int32(state.step), "params": _tree_from_named(named, config),
            "opt_state": {"count": np.int32(state.opt_state["count"]), "mu": moments("mu"),
                          "nu": moments("nu")},
            "max_logit_scale": _np({"m": state.max_logit_scale}, "m")}


def _flatten(tree, prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _int8_nodes(tree, prefix: str = ""):
    for key, value in tree.items():
        if "kernel_q" in value:
            yield f"{prefix}{key}", value
        else:
            yield from _int8_nodes(value, f"{prefix}{key}.")


def s3dg_params_from_jax(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX S3DG tree (numpy leaves, optionally with "int8") -> S3DG state dict.
    A torch checkpoint's ``num_batches_tracked`` counters are dropped."""
    out = {f"{prefix}{name}": _t(np.asarray(value, np.float32))
           for name, value in _flatten({k: v for k, v in tree.items() if k != "int8"})
           if not name.endswith("num_batches_tracked")}
    for path, node in _int8_nodes(tree.get("int8", {})):
        _dense_from_jax(node, f"{prefix}int8.{path}", out)
    return out


def mil_nce_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX MIL-NCE tree ({"video", "text"}) -> MilNceVideoTextEncoder state dict."""
    out = s3dg_params_from_jax(tree["video"], "video.")
    out.update((f"text.{name}", _t(np.asarray(value, np.float32)))
               for name, value in _flatten(tree["text"]))
    return out


def _bert_from_jax(tree, prefix: str, out) -> None:
    for name in ("position_embeddings", "token_type_embeddings"):
        out[f"{prefix}.{name}"] = _t(np.asarray(tree[name], np.float32))
    _vector(tree["embeddings_layernorm"], f"{prefix}.embeddings_layernorm", out)
    layers = sorted(int(k[len("layer_"):]) for k in tree if k.startswith("layer_"))
    for i in layers:
        for name, node in tree[f"layer_{i}"].items():
            if name.endswith("layernorm"):
                _vector(node, f"{prefix}.layers.{i}.{name}", out)
            else:
                _dense_from_jax(node, f"{prefix}.layers.{i}.{name}", out)


def videoclip_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX VideoCLIP tree ({"s3dg", "model"}) -> VideoClipVideoTextEncoder state dict."""
    out = s3dg_params_from_jax(tree["s3dg"], "s3dg.")
    model = tree["model"]
    for name in ("video_word_embeddings", "text_word_embeddings"):
        out[f"model.{name}"] = _t(np.asarray(model[name], np.float32))
    mlp = model["videomlp"]
    _dense_from_jax(mlp["linear1"], "model.videomlp.linear1", out)
    _vector(mlp["layernorm"], "model.videomlp.layernorm", out)
    _dense_from_jax(mlp["linear2"], "model.videomlp.linear2", out)
    _bert_from_jax(model["video_bert"], "model.video_bert", out)
    _bert_from_jax(model["text_bert"], "model.text_bert", out)
    return out
