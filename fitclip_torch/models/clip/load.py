"""Encoder factory (port of ``fitclip_tpu/models/clip/load.py``): a preset
name and a dtype give a ``ClipVideoTextEncoder`` on a device.

There are no released weights here, so the encoder is initialized from a
seed (``model.init_float_params``). ``dtype="int8"`` is the W8A8 inference
configuration: bf16 activations and int8 block denses, quantized from the
seeded float weights, so a float and an int8 encoder of one seed share them.

The encoder runs on CUDA unless the caller asks for another device
(``device="cpu"``); without a card a CUDA request raises. The kernel defaults
follow the device: on CUDA ``fused_attention`` is True and ``fused_block``
follows ``quantized`` (the Hopper kernels); on the CPU both are False (the
module path, plain PyTorch).
"""

import dataclasses
import logging
from typing import Optional, Union

import torch

from fitclip_torch.convert.from_jax import params_from_jax, params_to_jax
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, init_float_params
from fitclip_torch.ops.quant import quantize_clip_params

LOGGER = logging.getLogger(__name__)

PRESETS = {
    "ViT-B/32": CLIPConfig.vit_b_32,
    "ViT-B/16": CLIPConfig.vit_b_16,
    "ViT-L/14": CLIPConfig.vit_l_14,
    "ViT-L/14@336px": lambda: CLIPConfig.vit_l_14(image_size=336),
}

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be present if asked for."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU unless the caller "
                           "asks for the CPU (device='cpu')")
    return device


@dataclasses.dataclass
class LoadedEncoder:
    """An encoder with its weights, as the CLI wires it into task modules."""
    encoder: ClipVideoTextEncoder

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        return self.encoder.encode_video(video)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        return self.encoder.encode_text(text)


def load_clip_encoder(name: str = "ViT-B/16", dtype: str = "float32",
                      device="cuda", seed: int = 0, num_frames: int = 4,
                      fused_attention: Optional[bool] = None,
                      fused_block: Optional[bool] = None,
                      pad_seq: int = 0, remat: Union[bool, str] = False) -> LoadedEncoder:
    if name not in PRESETS:
        raise ValueError(f"Unknown CLIP preset {name!r}. Presets: {sorted(PRESETS)}")
    quantized = str(dtype) == "int8"
    if not quantized and str(dtype) not in _DTYPES:
        raise ValueError(f"Unknown encoder dtype {dtype!r} — expected one of "
                         f"{sorted(_DTYPES)} or 'int8'")
    device = resolve_device(device)
    if fused_attention is None:
        fused_attention = device.type == "cuda"
    config = PRESETS[name]()
    encoder = ClipVideoTextEncoder(config, num_frames=num_frames,
                                   dtype=_DTYPES["bfloat16" if quantized else str(dtype)],
                                   fused_attention=fused_attention, quantized=quantized,
                                   fused_block=fused_block, pad_seq=pad_seq, device="cpu",
                                   remat=remat)
    LOGGER.warning("No checkpoint for CLIP %s: initializing from seed %d.", name, seed)
    float_model = init_float_params(CLIPModel(config), seed)
    state = float_model.state_dict()
    if quantized:
        state = params_from_jax(quantize_clip_params(params_to_jax(state, config)), config)
    encoder.model.load_state_dict(state)
    return LoadedEncoder(encoder.to(device))
