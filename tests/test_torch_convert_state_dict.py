"""fitclip_torch/convert/torch_state_dict.py and load_clip_encoder(checkpoint_path=...)
against the JAX package: synthetic OpenAI- and HF-layout CLIP state dicts,
written with torch.save, read by both converters and held leaf for leaf (the
JAX tree carried to the port's modules by convert/from_jax.py), and an encoder
loaded from a checkpoint that embeds as JAX's does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.convert import torch_state_dict as jax_convert
from fitclip_tpu.models.clip import load as jax_load
from fitclip_tpu.ops import quant as jax_quant
from fitclip_torch.convert import torch_state_dict as convert
from fitclip_torch.convert.from_jax import params_from_jax
from fitclip_torch.models.clip import load
from fitclip_torch.models.clip.model import CLIPConfig, TextConfig, VisionConfig

# heads = width / 64, as config_from_openai_state_dict infers them.
CONFIG = CLIPConfig(embed_dim=32,
                    vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                                        heads=1),
                    text=TextConfig(context_length=16, vocab_size=100, width=64, layers=2,
                                    heads=1))


def _normal(rng, *shape, std=0.05):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _ln(rng, prefix, width, out):
    out[f"{prefix}.weight"] = 1.0 + _normal(rng, width, std=0.1)
    out[f"{prefix}.bias"] = _normal(rng, width, std=0.1)


def openai_state_dict(config: CLIPConfig = CONFIG, seed: int = 0):
    """A CLIP state dict in the ``clip`` package's layout, seeded."""
    rng = np.random.default_rng(seed)
    v, t = config.vision, config.text
    sd = {"visual.conv1.weight": _normal(rng, v.width, 3, v.patch_size, v.patch_size),
          "visual.class_embedding": _normal(rng, v.width),
          "visual.positional_embedding": _normal(rng, v.grid_size ** 2 + 1, v.width),
          "visual.proj": _normal(rng, v.width, config.embed_dim),
          "token_embedding.weight": _normal(rng, t.vocab_size, t.width),
          "positional_embedding": _normal(rng, t.context_length, t.width),
          "text_projection": _normal(rng, t.width, config.embed_dim),
          "logit_scale": np.float32(4.6)}
    _ln(rng, "visual.ln_pre", v.width, sd)
    _ln(rng, "visual.ln_post", v.width, sd)
    _ln(rng, "ln_final", t.width, sd)
    for prefix, width, layers in (("visual.transformer", v.width, v.layers),
                                  ("transformer", t.width, t.layers)):
        for i in range(layers):
            r = f"{prefix}.resblocks.{i}."
            sd[r + "attn.in_proj_weight"] = _normal(rng, 3 * width, width)
            sd[r + "attn.in_proj_bias"] = _normal(rng, 3 * width)
            sd[r + "attn.out_proj.weight"] = _normal(rng, width, width)
            sd[r + "attn.out_proj.bias"] = _normal(rng, width)
            sd[r + "mlp.c_fc.weight"] = _normal(rng, 4 * width, width)
            sd[r + "mlp.c_fc.bias"] = _normal(rng, 4 * width)
            sd[r + "mlp.c_proj.weight"] = _normal(rng, width, 4 * width)
            sd[r + "mlp.c_proj.bias"] = _normal(rng, width)
            _ln(rng, r + "ln_1", width, sd)
            _ln(rng, r + "ln_2", width, sd)
    return sd


def hf_state_dict(config: CLIPConfig = CONFIG, seed: int = 1, misspelled: bool = True):
    """A CLIP state dict in HuggingFace ``CLIPModel``'s layout, seeded."""
    rng = np.random.default_rng(seed)
    v, t = config.vision, config.text
    pre = "vision_model.pre_layrnorm" if misspelled else "vision_model.pre_layernorm"
    sd = {"vision_model.embeddings.patch_embedding.weight":
          _normal(rng, v.width, 3, v.patch_size, v.patch_size),
          "vision_model.embeddings.class_embedding": _normal(rng, v.width),
          "vision_model.embeddings.position_embedding.weight":
          _normal(rng, v.grid_size ** 2 + 1, v.width),
          "visual_projection.weight": _normal(rng, config.embed_dim, v.width),
          "text_model.embeddings.token_embedding.weight": _normal(rng, t.vocab_size, t.width),
          "text_model.embeddings.position_embedding.weight":
          _normal(rng, t.context_length, t.width),
          "text_projection.weight": _normal(rng, config.embed_dim, t.width)}
    _ln(rng, pre, v.width, sd)
    _ln(rng, "vision_model.post_layernorm", v.width, sd)
    _ln(rng, "text_model.final_layer_norm", t.width, sd)
    for prefix, width, layers in (("vision_model.encoder", v.width, v.layers),
                                  ("text_model.encoder", t.width, t.layers)):
        for i in range(layers):
            r = f"{prefix}.layers.{i}."
            for p in ("q", "k", "v", "out"):
                sd[r + f"self_attn.{p}_proj.weight"] = _normal(rng, width, width)
                sd[r + f"self_attn.{p}_proj.bias"] = _normal(rng, width)
            sd[r + "mlp.fc1.weight"] = _normal(rng, 4 * width, width)
            sd[r + "mlp.fc1.bias"] = _normal(rng, 4 * width)
            sd[r + "mlp.fc2.weight"] = _normal(rng, width, 4 * width)
            sd[r + "mlp.fc2.bias"] = _normal(rng, width)
            _ln(rng, r + "layer_norm1", width, sd)
            _ln(rng, r + "layer_norm2", width, sd)
    return sd


def _save(path, sd, wrap=None):
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    torch.save(wrap(tensors) if wrap else tensors, str(path))
    return str(path)


def _jax_config(config: CLIPConfig):
    from fitclip_tpu.models.clip.model import CLIPConfig as C, TextConfig as T, VisionConfig as V

    return C(embed_dim=config.embed_dim, vision=V(**dataclasses.asdict(config.vision)),
             text=T(**dataclasses.asdict(config.text)), quick_gelu=config.quick_gelu)


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("layout", ["openai", "hf", "hf_pre_layernorm"])
def test_converter_matches_jax_leaf_for_leaf(tmp_path, layout):
    sd = (openai_state_dict() if layout == "openai"
          else hf_state_dict(misspelled=layout == "hf"))
    path = _save(tmp_path / "clip.pt", sd)
    port_sd, jax_sd = convert.load_torch_state_dict(path), jax_convert.load_torch_state_dict(path)
    assert sorted(port_sd) == sorted(jax_sd)
    for key in jax_sd:
        np.testing.assert_array_equal(port_sd[key], jax_sd[key])
    schema = "openai" if layout == "openai" else "hf"
    assert convert.detect_schema(port_sd) == jax_convert.detect_schema(jax_sd) == schema
    want = params_from_jax(jax_convert.clip_params_from_torch(jax_sd, _jax_config(CONFIG)),
                           CONFIG)
    _assert_same_state(convert.clip_params_from_torch(port_sd, CONFIG), want)


def test_config_inference_matches_jax():
    sd = openai_state_dict()
    got = convert.config_from_openai_state_dict(sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_convert.config_from_openai_state_dict(sd))
    assert got == CONFIG
    with pytest.raises(ValueError):
        convert.config_from_openai_state_dict(hf_state_dict())
    with pytest.raises(ValueError):
        convert.detect_schema({"encoder.weight": np.zeros(1)})


def test_strip_prefix_and_lightning_checkpoints(tmp_path):
    sd = openai_state_dict()
    path = _save(tmp_path / "lightning.ckpt", sd, wrap=lambda t: {
        "state_dict": {**{f"encoder.model.{k}": v for k, v in t.items()},
                       "other.weight": torch.ones(3)}, "epoch": 3})
    port_sd = convert.load_torch_state_dict(path, strip_prefix="encoder.model.")
    jax_sd = jax_convert.load_torch_state_dict(path, strip_prefix="encoder.model.")
    assert sorted(port_sd) == sorted(jax_sd) == sorted(sd)
    for key in sd:
        np.testing.assert_array_equal(port_sd[key], sd[key])
    assert "encoder.model.visual.proj" in convert.load_torch_state_dict(path)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return _save(tmp_path_factory.mktemp("ckpt") / "clip.pt", openai_state_dict(seed=3))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, size=(3, 2, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 98, size=(4, 16)).astype(np.int32)
    ids[:, 9] = 99  # the EOT token carries the largest id of its row
    ids[:, 10:] = 0
    return video, ids


def test_encoder_from_checkpoint_embeds_as_jax(checkpoint):
    video, ids = _inputs()
    port = load.load_clip_encoder(checkpoint_path=checkpoint, num_frames=2, device="cpu")
    ref = jax_load.load_clip_encoder(checkpoint_path=checkpoint, num_frames=2)
    assert port.encoder.config == CONFIG
    with torch.no_grad():
        got_v = port.encode_video(torch.from_numpy(video)).numpy()
        got_t = port.encode_text(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got_v, np.asarray(ref.encode_video(jnp.asarray(video))),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got_t, np.asarray(ref.encode_text(jnp.asarray(ids))),
                               atol=2e-4, rtol=2e-4)


def test_int8_encoder_from_checkpoint_quantizes_as_jax(checkpoint):
    """dtype="int8" quantizes the checkpoint's weights as JAX's loader does."""
    port = load.load_clip_encoder(checkpoint_path=checkpoint, num_frames=2, dtype="int8",
                                  device="cpu")
    ref = jax_load.load_clip_encoder(checkpoint_path=checkpoint, num_frames=2, dtype="int8")
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params), CONFIG)
    _assert_same_state(port.encoder.model.state_dict(), want)
    assert port.encoder.quantized and port.encoder.dtype == torch.bfloat16
    qtree = jax_quant.quantize_clip_params(jax_convert.clip_params_from_torch(
        convert.load_torch_state_dict(checkpoint), _jax_config(CONFIG)))
    _assert_same_state(port.encoder.model.state_dict(), params_from_jax(qtree, CONFIG))


def test_loader_refusals(checkpoint):
    with pytest.raises(ValueError, match="Unknown CLIP preset"):
        load.load_clip_encoder("ViT-X/1", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        load.load_clip_encoder(checkpoint_path=checkpoint, dtype="int4", device="cpu")
