"""Frozen-in-Time encoder factory (port of
``fitclip_tpu/models/frozen_in_time/encoder.py:load_frozen_in_time_encoder``).

With a ``checkpoint_path`` the FrozenInTime torch checkpoint is mapped to the
parameter tree (``frozen_in_time_params_from_torch``, temporal embedding
inflated to ``num_frames``); without one the tree is drawn from a seed with
the JAX package's initializers. ``dtype="int8"`` quantizes the video tower's
denses (``FIT_DENSE_NAMES``) from that float tree, with bf16 activations and
a bf16 text tower, so an int8 and a float encoder of one seed share weights.
The int8 encoder must then be calibrated (``encoder.calibrate``).

The encoder runs on CUDA unless the caller asks for another device; on CUDA
``fused_attention`` defaults to True and ``fused_block`` follows the dtype
(int8: the K4 kernels; bf16: the module path on K5/K6), on the CPU both are
False.
"""

import logging
import math
from typing import Optional

import numpy as np
import torch

from fitclip_torch.convert.from_jax import fit_params_from_jax
from fitclip_torch.models.clip.load import _DTYPES, LoadedEncoder, resolve_device
from fitclip_torch.models.clip.model import _truncated_normal
from fitclip_torch.models.frozen_in_time.encoder import (FrozenInTimeConfig,
                                                         FrozenInTimeVideoTextEncoder,
                                                         frozen_in_time_params_from_torch)
from fitclip_torch.ops.quant import FIT_DENSE_NAMES, quantize_clip_params

LOGGER = logging.getLogger(__name__)


def init_fit_params(config: FrozenInTimeConfig, seed: int) -> dict:
    """A seeded float parameter tree in the JAX layout, with the JAX package's
    initializers: LeCun-normal (truncated) dense and patch kernels, zero biases,
    cls and temporal embeddings zero, normal(0.02) positions and word/position
    embeddings, normal(0.02) projections, LayerNorms at ones and zeros. Drawn
    on a CPU torch.Generator."""
    gen = torch.Generator().manual_seed(seed)

    def dense(fan_in, fan_out):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        return {"kernel": _truncated_normal((fan_in, fan_out), std, gen).numpy(),
                "bias": np.zeros(fan_out, np.float32)}

    def normal(*shape, std=0.02):
        return (torch.randn(shape, generator=gen) * std).numpy()

    def norm(width):
        return {"weight": np.ones(width, np.float32), "bias": np.zeros(width, np.float32)}

    d, p = config.embed_dim, config.patch_size
    patches = (config.img_size // p) ** 2
    video = {"patch_embed": dense(p * p * 3, d), "cls_token": np.zeros(d, np.float32),
             "pos_embed": normal(patches + 1, d),
             "temporal_embed": np.zeros((config.num_frames, d), np.float32), "norm": norm(d)}
    for i in range(config.depth):
        video[f"blocks_{i}"] = {
            "norm1": norm(d), "norm2": norm(d), "norm3": norm(d),
            "attn": {"qkv": dense(d, 3 * d), "proj": dense(d, d)},
            "timeattn": {"qkv": dense(d, 3 * d), "proj": dense(d, d)},
            "mlp_fc1": dense(d, 4 * d), "mlp_fc2": dense(4 * d, d)}
    t = config.text
    text = {"word_embeddings": normal(t.vocab_size, t.dim),
            "position_embeddings": normal(t.max_position_embeddings, t.dim),
            "embeddings_layer_norm": norm(t.dim)}
    for i in range(t.n_layers):
        text[f"layer_{i}"] = {
            **{f"attention_{n}": dense(t.dim, t.dim) for n in ("q_lin", "k_lin", "v_lin",
                                                                "out_lin")},
            "sa_layer_norm": norm(t.dim), "ffn_lin1": dense(t.dim, t.hidden_dim),
            "ffn_lin2": dense(t.hidden_dim, t.dim), "output_layer_norm": norm(t.dim)}
    projection = config.projection_dim
    return {"video": video, "text": text,
            "vid_proj": {"kernel": normal(d, projection),
                         "bias": np.zeros(projection, np.float32)},
            "txt_proj": {"kernel": normal(t.dim, projection),
                         "bias": np.zeros(projection, np.float32)}}


def _read_checkpoint(path: str) -> dict:
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = state.get("state_dict", state)
    # DataParallel prefix (frozen_in_time.py:22-32).
    return {(k[len("module."):] if k.startswith("module.") else k): v.float().numpy()
            for k, v in state.items()}


def load_frozen_in_time_encoder(checkpoint_path: Optional[str] = None, dtype: str = "float32",
                                device="cuda", seed: int = 0, num_frames: int = 4,
                                max_tokens: int = 77, vocab_path: Optional[str] = None,
                                temporal_inflation: str = "zeros",
                                fused_attention: Optional[bool] = None,
                                fused_block: Optional[bool] = None) -> LoadedEncoder:
    """FiT base (Bain et al., ICCV 2021: base_patch16_224, 4 frames,
    DistilBERT) as a ``FrozenInTimeVideoTextEncoder`` on ``device``."""
    quantized = str(dtype) == "int8"
    if not quantized and str(dtype) not in _DTYPES:
        raise ValueError(f"Unknown encoder dtype {dtype!r} — expected one of "
                         f"{sorted(_DTYPES)} or 'int8'")
    device = resolve_device(device)
    if fused_attention is None:
        fused_attention = device.type == "cuda"
    config = FrozenInTimeConfig(num_frames=num_frames)
    encoder = FrozenInTimeVideoTextEncoder(
        config, num_frames=num_frames, max_tokens=max_tokens,
        dtype=_DTYPES["bfloat16" if quantized else str(dtype)], quantized=quantized,
        fused_attention=fused_attention, fused_block=fused_block, vocab_path=vocab_path)
    if checkpoint_path:
        params = frozen_in_time_params_from_torch(_read_checkpoint(checkpoint_path), config,
                                                  temporal_inflation)
    else:
        LOGGER.warning("No checkpoint for Frozen-in-Time: initializing from seed %d.", seed)
        params = init_fit_params(config, seed)
    if quantized:
        params = dict(params, video=quantize_clip_params(params["video"], FIT_DENSE_NAMES))
    encoder.load_state_dict(fit_params_from_jax(params, config))
    return LoadedEncoder(encoder.to(device))
