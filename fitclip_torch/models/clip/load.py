"""Encoder factories (port of ``fitclip_tpu/models/clip/load.py``): the
``_target_``s behind ``config/encoder/clip*.yaml``.

A preset name, or a torch checkpoint (``checkpoint_path``, OpenAI or HF
layout, read by ``convert/torch_state_dict.py``; an OpenAI one gives its own
architecture), and a dtype give a ``ClipVideoTextEncoder`` on a device.
Without a checkpoint the encoder is initialized from a seed
(``model.init_float_params``). ``dtype="int8"`` is the W8A8 inference
configuration: bf16 activations and int8 block denses, quantized from the
float weights, so a float and an int8 encoder of one seed or checkpoint share
them.

The encoder runs on CUDA unless the caller asks for another device
(``device="cpu"``); without a card a CUDA request raises. The kernel defaults
follow the device: on CUDA ``fused_attention`` is True and ``fused_block``
follows ``quantized`` (the Hopper kernels); on the CPU both are False (the
module path, plain PyTorch). ``fused_block=True`` with ``dtype="bfloat16"``
runs the float layer kernels (K2).

A ResNet preset name (``RESNET_PRESETS``: RN50, RN101, RN50x4, RN50x16,
RN50x64), or a checkpoint with a ResNet's attention pool
(``visual.attnpool.q_proj.weight``, the preset then named by ``name``), gives
a ``ResNetClipVideoTextEncoder`` (``resnet_clip.py``), in a float dtype only.
``wise_encoder`` is WiSE-FT over two loaded encoders (``config/encoder/
wise.yaml``).
"""

import dataclasses
import logging
from typing import Optional, Union

import torch

from fitclip_torch.convert.from_jax import (params_from_jax, params_to_jax,
                                           resnet_clip_params_from_jax)
from fitclip_torch.convert.torch_state_dict import (clip_tree_from_torch,
                                                    config_from_openai_state_dict,
                                                    detect_schema, load_torch_state_dict)
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import (CLIPConfig, CLIPModel, TextConfig,
                                             init_float_params)
from fitclip_torch.models.clip.resnet import ModifiedResNetConfig
from fitclip_torch.models.clip.resnet_clip import (RESNET_PRESETS, ResNetCLIPConfig,
                                                   ResNetClipVideoTextEncoder,
                                                   init_resnet_clip_params,
                                                   resnet_clip_params_from_torch)
from fitclip_torch.models.clip.tokenizer import ClipTokenizer
from fitclip_torch.models.wise import wise_params
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
    encoder: torch.nn.Module

    def encode_video(self, video: torch.Tensor) -> torch.Tensor:
        return self.encoder.encode_video(video)

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        return self.encoder.encode_text(text)

    def get_tokenizer(self):
        return self.encoder.get_tokenizer()

    def decode_text(self, ids):
        return self.encoder.decode_text(ids)

    @property
    def preprocess(self):
        return self.encoder.preprocess


def load_clip_encoder(name: str = "ViT-B/16", checkpoint_path: Optional[str] = None,
                      num_frames: int = 4, dtype: str = "float32",
                      remat: Union[bool, str] = False,
                      fused_attention: Optional[bool] = None,
                      fused_block: Optional[bool] = None, bpe_path: Optional[str] = None,
                      seed: int = 0, strip_prefix: Optional[str] = None, device="cuda",
                      pad_seq: int = 0) -> LoadedEncoder:
    quantized = str(dtype) == "int8"
    if not quantized and str(dtype) not in _DTYPES:
        raise ValueError(f"Unknown encoder dtype {dtype!r} — expected one of "
                         f"{sorted(_DTYPES)} or 'int8'")
    state_dict = None
    resnet = dict(num_frames=num_frames, dtype=dtype, remat=remat,
                  fused_attention=fused_attention, fused_block=fused_block, bpe_path=bpe_path,
                  seed=seed, device=device)
    if checkpoint_path:
        state_dict = load_torch_state_dict(checkpoint_path, strip_prefix=strip_prefix)
        # As in JAX, a ResNet's architecture is its preset's: the checkpoint
        # only tells that it is a ResNet.
        if "visual.attnpool.q_proj.weight" in state_dict or name in RESNET_PRESETS:
            return _load_resnet_clip(name, state_dict, **resnet)
        if detect_schema(state_dict) == "openai":
            config = config_from_openai_state_dict(state_dict)
        else:
            config = PRESETS[name]()
    elif name in RESNET_PRESETS:
        return _load_resnet_clip(name, None, **resnet)
    elif name in PRESETS:
        config = PRESETS[name]()
    else:
        raise ValueError(f"Unknown CLIP preset {name!r} and no checkpoint_path given. "
                         f"Presets: {sorted(PRESETS) + sorted(RESNET_PRESETS)}")
    device = resolve_device(device)
    if fused_attention is None:
        fused_attention = device.type == "cuda"
    encoder = ClipVideoTextEncoder(config, num_frames=num_frames,
                                   dtype=_DTYPES["bfloat16" if quantized else str(dtype)],
                                   fused_attention=fused_attention, quantized=quantized,
                                   fused_block=fused_block, pad_seq=pad_seq, device="cpu",
                                   remat=remat, bpe_path=bpe_path)
    if state_dict is not None:
        tree = clip_tree_from_torch(state_dict, config)
        state = params_from_jax(quantize_clip_params(tree) if quantized else tree, config)
    else:
        LOGGER.warning("No checkpoint for CLIP %s: initializing from seed %d.", name, seed)
        state = init_float_params(CLIPModel(config), seed).state_dict()
        if quantized:
            state = params_from_jax(quantize_clip_params(params_to_jax(state, config)), config)
    encoder.model.load_state_dict(state)
    return LoadedEncoder(encoder.to(device))


def _load_resnet_clip(name: str, state_dict, num_frames: int, dtype: str, remat,
                      fused_attention: Optional[bool], fused_block: Optional[bool],
                      bpe_path: Optional[str], seed: int, device) -> LoadedEncoder:
    """A CLIP ResNet of the preset ``name``, from an OpenAI-schema state dict
    or from a seed. Float dtypes only; the live batch-statistics BatchNorm
    must not run twice in a step, so there is no remat; there is no fused
    layer path."""
    config = RESNET_PRESETS[name]
    if str(dtype) == "int8":
        raise ValueError("encoder.dtype=int8 is transformer-only (whole-layer "
                         "megakernels); CLIP ResNets support float dtypes — "
                         "use bfloat16 for the throughput configuration.")
    if remat:
        raise ValueError(f"remat={remat!r} on CLIP {name}: recomputing a ResNet block would "
                         "apply its BatchNorm EMA update twice; CLIP ResNets train without remat")
    if fused_block:
        raise ValueError(f"fused_block=True on CLIP {name}: the fused layer kernels are "
                         "transformer layers; a CLIP ResNet has no fused layer path")
    device = resolve_device(device)
    if fused_attention is None:
        fused_attention = device.type == "cuda"
    encoder = ResNetClipVideoTextEncoder(config, num_frames=num_frames,
                                         dtype=_DTYPES[str(dtype)],
                                         fused_attention=fused_attention, device="cpu",
                                         bpe_path=bpe_path)
    if state_dict is not None:
        encoder.model.load_state_dict(resnet_clip_params_from_jax(
            resnet_clip_params_from_torch(state_dict, config), config))
    else:
        LOGGER.warning("No checkpoint for CLIP %s: initializing from seed %d.", name, seed)
        init_resnet_clip_params(encoder.model, seed)
    return LoadedEncoder(encoder.to(device))


def load_clip_from_scratch(name: str = "ViT-B/16", **kwargs) -> LoadedEncoder:
    """A fresh seeded initialization (config/encoder/clip_from_scratch_*.yaml)."""
    return load_clip_encoder(name=name, checkpoint_path=None, **kwargs)


def load_tiny_test_encoder(num_frames: int = 4, seed: int = 0, bpe_path: Optional[str] = None,
                           vocab_path: Optional[str] = None, device="cuda") -> LoadedEncoder:
    """A tiny seeded CLIP (``CLIPConfig.tiny_test``, context 16) for tests and
    CLI dry runs; its vocabulary is the tokenizer's when ``bpe_path`` is given."""
    tokenizer = None
    if bpe_path:
        tokenizer = ClipTokenizer(bpe_path=bpe_path, vocab_path=vocab_path, context_length=16)
    config = CLIPConfig.tiny_test(vocab_size=tokenizer.vocab_size if tokenizer else 64)
    device = resolve_device(device)
    # head_dim 12: the module path with plain attention on either device.
    encoder = ClipVideoTextEncoder(config, num_frames=num_frames, device="cpu",
                                   tokenizer=tokenizer)
    encoder.model.load_state_dict(init_float_params(CLIPModel(config), seed).state_dict())
    return LoadedEncoder(encoder.to(device))


def load_tiny_rn_test_encoder(num_frames: int = 2, seed: int = 0,
                              bpe_path: Optional[str] = None,
                              vocab_path: Optional[str] = None, device="cuda") -> LoadedEncoder:
    """A tiny seeded ResNet-CLIP (layers (1, 1, 1, 1), width 8, 32^2 frames,
    text 16 wide x 2 layers, context 16) for tests and CLI dry runs: the
    trainable batch-statistics BatchNorm path end to end."""
    tokenizer = None
    if bpe_path:
        tokenizer = ClipTokenizer(bpe_path=bpe_path, vocab_path=vocab_path, context_length=16)
    config = ResNetCLIPConfig(
        embed_dim=16,
        vision=ModifiedResNetConfig(layers=(1, 1, 1, 1), width=8, output_dim=16,
                                    input_resolution=32, heads=4),
        text=TextConfig(context_length=16, vocab_size=tokenizer.vocab_size if tokenizer else 64,
                        width=16, heads=2, layers=2))
    device = resolve_device(device)
    # head_dim 8: the text tower's plain attention on either device.
    encoder = ResNetClipVideoTextEncoder(config, num_frames=num_frames, device="cpu",
                                         tokenizer=tokenizer)
    init_resnet_clip_params(encoder.model, seed)
    return LoadedEncoder(encoder.to(device))


def wise_encoder(model1: LoadedEncoder, model2: LoadedEncoder,
                 weight_for_2: float = 0.5) -> LoadedEncoder:
    """WiSE-FT at instantiation time (config/encoder/wise.yaml; the released
    recipe uses weight_for_2=0.4): model1's encoder, on model1's device, with
    the weights (1 - weight_for_2) * model1's + weight_for_2 * model2's
    (``models/wise.py``)."""
    model = model1.encoder.model
    model.load_state_dict(wise_params(model.state_dict(), model2.encoder.model.state_dict(),
                                      weight_for_2=weight_for_2))
    return LoadedEncoder(model1.encoder)
