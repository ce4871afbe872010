"""CLIP ViT (OpenAI's checkpoint layout) for the benchmark: its seeded
weights, the program's encoder built from them through the port's own
state-dict route, the reference, and its work counted from the shapes.

Configuration keys (``configs/<name>.json``): ``embed_dim``, ``vision``
(image_size, patch_size, width, layers, heads), ``text`` (context_length,
vocab_size, width, layers, heads), ``quick_gelu``, ``num_frames``, ``tokens``.
"""

from typing import Dict, List, Optional

import torch

from port_bench import weights as seeded
from port_bench.reference import clip as reference
from port_bench.work import Call, attention, attention_backward, conv_patches, dense


def leaves(cfg: dict) -> List[seeded.Leaf]:
    v, t, e = cfg["vision"], cfg["text"], cfg["embed_dim"]
    w, p = v["width"], v["patch_size"]
    out = [("visual.conv1.weight", (w, 3, p, p), "conv"),
           ("visual.class_embedding", (w,), "embedding"),
           ("visual.positional_embedding", ((v["image_size"] // p) ** 2 + 1, w), "position"),
           ("visual.ln_pre.weight", (w,), "ln_weight"), ("visual.ln_pre.bias", (w,), "ln_bias")]
    out += _tower("visual.transformer.resblocks", w, v["layers"])
    out += [("visual.ln_post.weight", (w,), "ln_weight"),
            ("visual.ln_post.bias", (w,), "ln_bias"),
            ("visual.proj", (w, e), "proj"),
            ("token_embedding.weight", (t["vocab_size"], t["width"]), "embedding"),
            ("positional_embedding", (t["context_length"], t["width"]), "position")]
    out += _tower("transformer.resblocks", t["width"], t["layers"])
    out += [("ln_final.weight", (t["width"],), "ln_weight"),
            ("ln_final.bias", (t["width"],), "ln_bias"),
            ("text_projection", (t["width"], e), "proj")]
    return out


def _tower(prefix: str, w: int, layers: int) -> List[seeded.Leaf]:
    out = []
    for i in range(layers):
        r = f"{prefix}.{i}."
        out += [(r + "ln_1.weight", (w,), "ln_weight"), (r + "ln_1.bias", (w,), "ln_bias"),
                (r + "attn.in_proj_weight", (3 * w, w), "dense"),
                (r + "attn.in_proj_bias", (3 * w,), "bias"),
                (r + "attn.out_proj.weight", (w, w), "dense"),
                (r + "attn.out_proj.bias", (w,), "bias"),
                (r + "ln_2.weight", (w,), "ln_weight"), (r + "ln_2.bias", (w,), "ln_bias"),
                (r + "mlp.c_fc.weight", (4 * w, w), "dense"),
                (r + "mlp.c_fc.bias", (4 * w,), "bias"),
                (r + "mlp.c_proj.weight", (w, 4 * w), "dense"),
                (r + "mlp.c_proj.bias", (w,), "bias")]
    return out


def make_weights(cfg: dict, seed: int, tag: str, device) -> Dict[str, torch.Tensor]:
    return seeded.make(leaves(cfg), seed, tag, device)


def shapes(cfg: dict):
    """(frames a clip, frame size, tokens a caption)."""
    return cfg["num_frames"], cfg["vision"]["image_size"], cfg["text"]["context_length"]


def load_program(cfg: dict, weights: Dict[str, torch.Tensor], device, precision: str,
                 fused_block: Optional[bool] = None):
    """The port's ``ClipVideoTextEncoder`` from an OpenAI-layout state dict, by
    the functions ``load_clip_encoder`` applies to a checkpoint's:
    ``config_from_openai_state_dict``, ``clip_tree_from_torch``,
    ``quantize_clip_params`` for int8, ``params_from_jax``."""
    from fitclip_torch.convert.from_jax import params_from_jax
    from fitclip_torch.convert.torch_state_dict import (clip_tree_from_torch,
                                                        config_from_openai_state_dict)
    from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_torch.ops.quant import quantize_clip_params

    state_dict = {name: t.detach().float().cpu().numpy() for name, t in weights.items()}
    config = config_from_openai_state_dict(state_dict)
    quantized = precision == "int8"
    dtype = torch.float32 if precision == "float32" else torch.bfloat16
    encoder = ClipVideoTextEncoder(config, num_frames=cfg["num_frames"], dtype=dtype,
                                   fused_attention=torch.device(device).type == "cuda",
                                   quantized=quantized, fused_block=fused_block, device="cpu")
    tree = clip_tree_from_torch(state_dict, config)
    encoder.model.load_state_dict(
        params_from_jax(quantize_clip_params(tree) if quantized else tree, config))
    return encoder.to(device)


def calibrate(encoder, observations) -> None:
    """The evaluate command's calibration: the running abs-max of every int8
    site over the (video, text) batches, written once."""
    from fitclip_torch.cli.runners import _calibrate_on_batches

    _calibrate_on_batches(encoder, observations, {})


def reference_video(weights, video, cfg, bits: Optional[dict] = None):
    """``bits``: the control's precisions, ``video`` of the denses and
    ``stream`` of the residual stream (absent: float32)."""
    bits = bits or {}
    return reference.encode_video(weights, video, cfg, bits.get("video"), bits.get("stream"))


def reference_text(weights, ids, cfg, bits: Optional[dict] = None):
    bits = bits or {}
    return reference.encode_text(weights, ids, cfg, bits.get("text"), bits.get("stream"))


def _tower_calls(groups: int, seq: int, width: int, heads: int, layers: int, causal: bool,
                 precision: str, gemm: str, core: str, core_out: str) -> List[Call]:
    rows, act = groups * seq, "bfloat16"
    one = [dense(gemm, rows, width, 3 * width, precision, act),
           attention(core, groups, heads, seq, seq, width // heads, "bfloat16", rows, core_out,
                     causal),
           dense(gemm, rows, width, width, precision, act, residual=True),
           dense(gemm, rows, width, 4 * width, precision, act),
           dense(gemm, rows, 4 * width, width, precision, act, residual=True)]
    return one * layers


def eval_calls(cfg: dict, precision: str, clips: int, texts: int) -> List[Call]:
    """The device work of one eval batch: ``clips`` clips and ``texts`` caption
    rows through both towers. int8: the block denses on K1's int8 GEMMs, the
    attention cores in bf16 with an int8 output (the out-projection's input)."""
    if precision != "int8":
        raise ValueError(f"eval cells of the CLIP family run int8, not {precision}")
    v, t, e = cfg["vision"], cfg["text"], cfg["embed_dim"]
    frames = clips * cfg["num_frames"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    calls = [conv_patches("patch_embed", frames, v["image_size"], v["patch_size"], v["width"],
                          "bfloat16")]
    calls += _tower_calls(frames, seq, v["width"], v["heads"], v["layers"], False, "int8",
                          "int8_gemm", "attention", "int8")
    calls.append(dense("projection", frames, v["width"], e, "bfloat16", "bfloat16"))
    calls += _tower_calls(texts, t["context_length"], t["width"], t["heads"], t["layers"], True,
                          "int8", "int8_gemm", "attention", "int8")
    calls.append(dense("projection", texts, t["width"], e, "bfloat16", "bfloat16"))
    return calls


def forward_calls(cfg: dict, clips: int, texts: int, gemm: str, core: str) -> List[Call]:
    """One bf16 forward of both towers (training): denses on ``gemm``, cores on ``core``."""
    v, t, e = cfg["vision"], cfg["text"], cfg["embed_dim"]
    frames = clips * cfg["num_frames"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    calls = [conv_patches("patch_embed", frames, v["image_size"], v["patch_size"], v["width"],
                          "bfloat16")]
    calls += _tower_calls(frames, seq, v["width"], v["heads"], v["layers"], False, "bfloat16",
                          gemm, core, "bfloat16")
    calls.append(dense("projection", frames, v["width"], e, "bfloat16", "bfloat16"))
    calls += _tower_calls(texts, t["context_length"], t["width"], t["heads"], t["layers"], True,
                          "bfloat16", gemm, core, "bfloat16")
    calls.append(dense("projection", texts, t["width"], e, "bfloat16", "bfloat16"))
    return calls


def backward_cores(cfg: dict, clips: int, texts: int, family: str) -> List[Call]:
    """The attention cores' backward of one training step (bf16)."""
    v, t = cfg["vision"], cfg["text"]
    frames = clips * cfg["num_frames"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    return ([attention_backward(family, frames, v["heads"], seq, v["width"] // v["heads"],
                                "bfloat16")] * v["layers"]
            + [attention_backward(family, texts, t["heads"], t["context_length"],
                                  t["width"] // t["heads"], "bfloat16", causal=True)]
            * t["layers"])


def train_calls(cfg: dict, rows: int, unlabeled: int) -> List[Call]:
    """The device work of one teacher-student step: the student's bf16 forward
    (cuBLAS denses, K3f cores) over ``rows`` clips and captions, its backward
    (two products a dense, the patch embedding's weight gradient, K3b cores),
    and the frozen teacher's forward over the ``unlabeled`` ones on K2."""
    forward = forward_calls(cfg, rows, rows, "gemm", "attention")
    backward = [Call("gemm_bwd", 2 * c.ops, 2 * c.nbytes, c.precision) for c in forward
                if c.family in ("gemm", "projection")]
    backward += [Call("patch_embed_bwd", c.ops, c.nbytes, c.precision) for c in forward
                 if c.family == "patch_embed"]
    backward += backward_cores(cfg, rows, rows, "attention_bwd")
    return forward + backward + forward_calls(cfg, unlabeled, unlabeled, "bf16_gemm",
                                              "attention_block")


def reference_trainable(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's trainable leaves: the weights, and the patch
    embedding's bias at zero (OpenAI's conv1 has none; the program trains one)."""
    out = dict(weights)
    width = weights["visual.conv1.weight"].shape[0]
    device = weights["visual.conv1.weight"].device
    out.setdefault("visual.conv1.bias", torch.zeros(width, device=device))
    return out


def program_leaf_name(name: str) -> str:
    """The program's state name of a reference leaf (OpenAI's layout):
    ``transformer.resblocks.3.mlp.c_fc.weight`` ->
    ``encoder.text.transformer.blocks.3.mlp_fc.weight``."""
    if name in ("logit_scale", "ts_logit_scale"):
        return name
    n = name.replace("visual.conv1.", "visual.patch_embed.")
    n = n.replace("transformer.resblocks.", "transformer.blocks.")
    n = n.replace("attn.in_proj_weight", "attn.in_proj.weight")
    n = n.replace("attn.in_proj_bias", "attn.in_proj.bias")
    n = n.replace(".mlp.c_fc.", ".mlp_fc.").replace(".mlp.c_proj.", ".mlp_proj.")
    if not n.startswith("visual."):
        n = "text." + (n[:-len(".weight")] if n == "token_embedding.weight" else n)
    return "encoder." + n
