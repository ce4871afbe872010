"""Frozen-in-Time (the FrozenInTime checkpoint's layout) for the benchmark:
its seeded weights, the program's encoder built from them through the port's
own state-dict route, the reference, and its work counted from the shapes.

Configuration keys (``configs/<name>.json``): ``projection_dim``, ``video``
(embed_dim, depth, num_heads, patch_size, img_size), ``num_frames``,
``max_tokens``, ``text`` (DistilBERT's vocab_size, dim, hidden_dim, n_layers,
n_heads, max_position_embeddings), ``tokens``.
"""

from typing import Dict, List, Optional

import torch

from port_bench import weights as seeded
from port_bench.reference import fit as reference
from port_bench.work import BYTES, Call, conv_patches, dense


def leaves(cfg: dict) -> List[seeded.Leaf]:
    v, t, f = cfg["video"], cfg["text"], cfg["num_frames"]
    d, p = v["embed_dim"], v["patch_size"]
    patches = (v["img_size"] // p) ** 2
    m = "video_model."
    out = [(m + "patch_embed.proj.weight", (d, 3, p, p), "conv"),
           (m + "patch_embed.proj.bias", (d,), "bias"),
           (m + "cls_token", (1, 1, d), "embedding"),
           (m + "pos_embed", (1, patches + 1, d), "position"),
           (m + "temporal_embed", (1, f, d), "position")]
    for i in range(v["depth"]):
        b = f"{m}blocks.{i}."
        for norm in ("norm1", "norm2", "norm3"):
            out += [(b + norm + ".weight", (d,), "ln_weight"),
                    (b + norm + ".bias", (d,), "ln_bias")]
        for half in ("attn", "timeattn"):
            out += [(b + half + ".qkv.weight", (3 * d, d), "dense"),
                    (b + half + ".qkv.bias", (3 * d,), "bias"),
                    (b + half + ".proj.weight", (d, d), "dense"),
                    (b + half + ".proj.bias", (d,), "bias")]
        out += [(b + "mlp.fc1.weight", (4 * d, d), "dense"),
                (b + "mlp.fc1.bias", (4 * d,), "bias"),
                (b + "mlp.fc2.weight", (d, 4 * d), "dense"),
                (b + "mlp.fc2.bias", (d,), "bias")]
    out += [(m + "norm.weight", (d,), "ln_weight"), (m + "norm.bias", (d,), "ln_bias")]
    e, hidden = t["dim"], t["hidden_dim"]
    x = "text_model."
    out += [(x + "embeddings.word_embeddings.weight", (t["vocab_size"], e), "embedding"),
            (x + "embeddings.position_embeddings.weight", (t["max_position_embeddings"], e),
             "position"),
            (x + "embeddings.LayerNorm.weight", (e,), "ln_weight"),
            (x + "embeddings.LayerNorm.bias", (e,), "ln_bias")]
    for i in range(t["n_layers"]):
        b = f"{x}transformer.layer.{i}."
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            out += [(b + f"attention.{name}.weight", (e, e), "dense"),
                    (b + f"attention.{name}.bias", (e,), "bias")]
        out += [(b + "sa_layer_norm.weight", (e,), "ln_weight"),
                (b + "sa_layer_norm.bias", (e,), "ln_bias"),
                (b + "ffn.lin1.weight", (hidden, e), "dense"),
                (b + "ffn.lin1.bias", (hidden,), "bias"),
                (b + "ffn.lin2.weight", (e, hidden), "dense"), (b + "ffn.lin2.bias", (e,), "bias"),
                (b + "output_layer_norm.weight", (e,), "ln_weight"),
                (b + "output_layer_norm.bias", (e,), "ln_bias")]
    projection = cfg["projection_dim"]
    out += [("vid_proj.0.weight", (projection, d), "dense"),
            ("vid_proj.0.bias", (projection,), "bias"),
            ("txt_proj.1.weight", (projection, e), "dense"),
            ("txt_proj.1.bias", (projection,), "bias")]
    return out


def make_weights(cfg: dict, seed: int, tag: str, device) -> Dict[str, torch.Tensor]:
    return seeded.make(leaves(cfg), seed, tag, device)


def shapes(cfg: dict):
    """(frames a clip, frame size, tokens a caption)."""
    return cfg["num_frames"], cfg["video"]["img_size"], cfg["max_tokens"]


def load_program(cfg: dict, weights: Dict[str, torch.Tensor], device, precision: str,
                 fused_block: Optional[bool] = None):
    """The port's ``FrozenInTimeVideoTextEncoder`` from a FrozenInTime state
    dict, by the functions ``load_frozen_in_time_encoder`` applies to a
    checkpoint's: ``frozen_in_time_params_from_torch``, for int8
    ``quantize_clip_params`` of the video tower, ``fit_params_from_jax``."""
    from fitclip_torch.convert.from_jax import fit_params_from_jax
    from fitclip_torch.models.frozen_in_time.distilbert import DistilBertConfig
    from fitclip_torch.models.frozen_in_time.encoder import (FrozenInTimeConfig,
                                                             FrozenInTimeVideoTextEncoder,
                                                             frozen_in_time_params_from_torch)
    from fitclip_torch.ops.quant import FIT_DENSE_NAMES, quantize_clip_params

    v = cfg["video"]
    config = FrozenInTimeConfig(projection_dim=cfg["projection_dim"], embed_dim=v["embed_dim"],
                                depth=v["depth"], num_heads=v["num_heads"],
                                patch_size=v["patch_size"], img_size=v["img_size"],
                                num_frames=cfg["num_frames"],
                                text=DistilBertConfig(**cfg["text"]))
    quantized = precision == "int8"
    dtype = torch.float32 if precision == "float32" else torch.bfloat16
    encoder = FrozenInTimeVideoTextEncoder(
        config, num_frames=cfg["num_frames"], max_tokens=cfg["max_tokens"], dtype=dtype,
        quantized=quantized, fused_attention=torch.device(device).type == "cuda",
        fused_block=fused_block)
    state_dict = {name: t.detach().float().cpu().numpy() for name, t in weights.items()}
    params = frozen_in_time_params_from_torch(state_dict, config)
    if quantized:
        params = dict(params, video=quantize_clip_params(params["video"], FIT_DENSE_NAMES))
    encoder.load_state_dict(fit_params_from_jax(params, config))
    return encoder.to(device)


def calibrate(encoder, observations) -> None:
    """The running abs-max of every int8 site of the video tower over the
    batches, written once (``FrozenInTimeVideoTextEncoder.calibrate`` over
    several batches)."""
    from fitclip_torch.ops.quant import apply_act_scales, merge_act_amax

    amax = None
    for video, text in observations:
        amax = merge_act_amax(amax, encoder.collect_act_amax(video, text))
    apply_act_scales(encoder, amax)


def reference_video(weights, video, cfg, bits: Optional[dict] = None):
    return reference.encode_video(weights, video, cfg, (bits or {}).get("video"))


def reference_text(weights, ids, cfg, bits: Optional[dict] = None):
    return reference.encode_text(weights, ids, cfg, (bits or {}).get("text"))


def _fit_attention(clips: int, frames: int, patches: int, heads: int, d: int, mode: str) -> Call:
    """One attention half of K4: the patch rows' time or space attention (each
    query over the CLS key and its group) and the CLS row's over every row;
    qkv in bf16, the int8 output (the projection's input) out."""
    rows = 1 + frames * patches
    if mode == "time":
        pairs = patches * frames * (1 + frames)
    else:
        pairs = frames * patches * (1 + patches)
    ops = 4.0 * clips * heads * d * (pairs + rows)
    width = heads * d
    nbytes = clips * rows * (3 * width * BYTES["bfloat16"] + width * BYTES["int8"])
    return Call("fit_attention", ops, nbytes, "bfloat16")


def eval_calls(cfg: dict, precision: str, clips: int, texts: int) -> List[Call]:
    """The device work of one eval batch. int8: the video tower's denses on
    K1's int8 GEMMs, FiT's attention cores in bf16 with an int8 output;
    DistilBERT in bf16 (cuBLAS) with its attention logits in float32; both
    projections in float32."""
    if precision != "int8":
        raise ValueError(f"eval cells of the FiT family run int8, not {precision}")
    v, t, f = cfg["video"], cfg["text"], cfg["num_frames"]
    d, heads = v["embed_dim"], v["num_heads"]
    patches = (v["img_size"] // v["patch_size"]) ** 2
    rows = clips * (1 + f * patches)
    calls = [conv_patches("patch_embed", clips * f, v["img_size"], v["patch_size"], d,
                          "bfloat16")]
    block = []
    for mode in ("time", "space"):
        block += [dense("int8_gemm", rows, d, 3 * d, "int8", "bfloat16"),
                  _fit_attention(clips, f, patches, heads, d // heads, mode),
                  dense("int8_gemm", rows, d, d, "int8", "bfloat16", residual=True)]
    block += [dense("int8_gemm", rows, d, 4 * d, "int8", "bfloat16"),
              dense("int8_gemm", rows, 4 * d, d, "int8", "bfloat16", residual=True)]
    calls += block * v["depth"]
    calls.append(dense("projection", clips, d, cfg["projection_dim"], "float32", "float32"))
    e, length, th = t["dim"], cfg["max_tokens"], t["n_heads"]
    trows = texts * length
    layer = [dense("text_gemm", trows, e, e, "bfloat16", "bfloat16") for _ in range(4)]
    layer.append(Call("text_attention", 4.0 * texts * th * (e // th) * length * length,
                      trows * 4 * e * BYTES["float32"], "float32"))
    layer += [dense("text_gemm", trows, e, t["hidden_dim"], "bfloat16", "bfloat16"),
              dense("text_gemm", trows, t["hidden_dim"], e, "bfloat16", "bfloat16")]
    calls += layer * t["n_layers"]
    calls.append(dense("projection", texts, e, cfg["projection_dim"], "float32", "float32"))
    return calls
