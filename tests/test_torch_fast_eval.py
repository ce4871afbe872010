"""The port's int8 slice against the JAX package: ``encode_frames_fast`` /
``encode_text_fast`` against ``encode_frames_int8`` / ``encode_text_int8``
(whose int8 layer kernel runs in Pallas interpret mode), the encoder on uint8
clips with the pixel normalization folded, and ``load_clip_encoder``'s
device-dependent defaults. int8 bound atol/rtol 2e-3 and cosine >= 0.999
against the float model, as in tests/test_block_kernel.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip import CLIPConfig as JaxConfig
from fitclip_tpu.models.clip import CLIPModel as JaxModel
from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.clip.fast_eval import encode_frames_int8, encode_text_int8
from fitclip_tpu.models.clip.model import TextConfig as JaxText
from fitclip_tpu.models.clip.model import VisionConfig as JaxVision
from fitclip_tpu.models.clip.model import fold_pixel_normalization as jax_fold
from fitclip_tpu.ops import quant as jax_quant
from fitclip_torch.convert.from_jax import params_from_jax, params_to_jax
from fitclip_torch.models.clip import fast_eval
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder, l2_normalize
from fitclip_torch.models.clip.load import load_clip_encoder
from fitclip_torch.models.clip.model import (CLIPConfig, CLIPModel, TextConfig, VisionConfig,
                                             init_float_params)

NARROW = dict(embed_dim=32, vision=dict(image_size=32, patch_size=16, width=128, layers=2,
                                        heads=2),
              text=dict(context_length=16, vocab_size=64, width=128, layers=2, heads=2))


def _configs(name):
    if name == "tiny":
        return JaxConfig.tiny_test(), CLIPConfig.tiny_test()
    return (JaxConfig(embed_dim=NARROW["embed_dim"], vision=JaxVision(**NARROW["vision"]),
                      text=JaxText(**NARROW["text"])),
            CLIPConfig(embed_dim=NARROW["embed_dim"], vision=VisionConfig(**NARROW["vision"]),
                       text=TextConfig(**NARROW["text"])))


def _calibrate(cfg, params):
    """The int8 tree with scales calibrated by the port (the calibration itself
    is held against JAX in test_torch_quant.py)."""
    rng = np.random.default_rng(9)
    enc = ClipVideoTextEncoder(cfg, num_frames=1, quantized=True)
    enc.model.load_state_dict(params_from_jax(jax_quant.quantize_clip_params(params), cfg))
    enc.calibrate(torch.from_numpy(rng.normal(size=(4, 1, 32, 32, 3)).astype(np.float32)),
                  torch.from_numpy(rng.integers(1, 60, size=(4, 16))))
    return params_to_jax(enc.model.state_dict(), cfg)


@pytest.fixture(scope="module", params=["tiny", "narrow"])
def setup(request):
    jax_cfg, cfg = _configs(request.param)
    params = JaxModel(jax_cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                    jnp.zeros((1, 16), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jax_cfg, cfg, params, _calibrate(cfg, params)


def _cosine(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_fast_path_matches_jax_int8(setup):
    jax_cfg, cfg, params, qparams = setup
    rng = np.random.default_rng(3)
    images = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 60, size=(4, 16)).astype(np.int32)
    img_ref = encode_frames_int8(qparams, images, jax_cfg, dtype=jnp.float32)
    txt_ref = encode_text_int8(qparams, ids, jax_cfg, dtype=jnp.float32)
    model = CLIPModel(cfg, quantized=True)
    model.load_state_dict(params_from_jax(qparams, cfg))
    img = fast_eval.encode_frames_fast(model, torch.from_numpy(images))
    txt = fast_eval.encode_text_fast(model, torch.from_numpy(ids).long())
    np.testing.assert_allclose(img.numpy(), np.asarray(img_ref), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(txt.numpy(), np.asarray(txt_ref), atol=2e-3, rtol=2e-3)
    img_f, txt_f = JaxModel(jax_cfg).apply({"params": params}, images, ids)
    assert _cosine(img_f, img.numpy()).min() >= 0.999
    assert _cosine(txt_f, txt.numpy()).min() >= 0.999


def test_padded_sequence_matches_unpadded(setup):
    _, cfg, _, qparams = setup
    model = CLIPModel(cfg, quantized=True)
    model.load_state_dict(params_from_jax(qparams, cfg))
    images = torch.from_numpy(np.random.default_rng(11).normal(size=(3, 32, 32, 3))
                              .astype(np.float32))
    base = fast_eval.encode_frames_fast(model, images)
    padded = fast_eval.encode_frames_fast(model, images, pad_seq=16)
    torch.testing.assert_close(padded, base, atol=2e-5, rtol=2e-5)


def test_encoder_on_folded_uint8_clips_matches_jax(setup):
    jax_cfg, cfg, params, qparams = setup
    mean, std = JaxEncoder(jax_cfg).preprocess.mean, JaxEncoder(jax_cfg).preprocess.std
    folded = jax_fold(qparams, mean, std)
    rng = np.random.default_rng(5)
    video = rng.integers(0, 256, size=(2, 3, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 60, size=(3, 16)).astype(np.int32)
    jax_enc = JaxEncoder(jax_cfg, num_frames=3, quantized=True, fused_attention=True,
                         fused_block=True, pixel_normalization_folded=True)
    video_ref = jax_enc.encode_video(folded, jnp.asarray(video))
    text_ref = jax_enc.encode_text(folded, jnp.asarray(ids))

    enc = ClipVideoTextEncoder(cfg, num_frames=3, quantized=True, fused_attention=True,
                               fused_block=True)
    enc.model.load_state_dict(params_from_jax(qparams, cfg))
    enc.fold_pixel_normalization()
    out = enc.encode_video(torch.from_numpy(video))
    assert out.shape == (2, cfg.embed_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(video_ref), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(enc.encode_text(torch.from_numpy(ids).long()).numpy(),
                               np.asarray(text_ref), atol=2e-3, rtol=2e-3)


def test_float_model_has_no_fast_path_yet():
    """The name predates the float layer: a float model's fast path now runs K2
    (ops/block.fused_bf16_layer, its plain versions on the CPU) and agrees with
    the module path; the encoder with fused_block=True takes it."""
    cfg = CLIPConfig.tiny_test()
    model = init_float_params(CLIPModel(cfg), seed=0)
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(1, 60, size=(2, 16)))
    with torch.no_grad():
        torch.testing.assert_close(fast_eval.encode_frames_fast(model, images),
                                   model.encode_image(images), atol=2e-4, rtol=2e-4)
        enc = ClipVideoTextEncoder(cfg, fused_block=True)
        enc.model.load_state_dict(model.state_dict())
        torch.testing.assert_close(enc.encode_text(ids), l2_normalize(model.encode_text(ids)),
                                   atol=2e-4, rtol=2e-4)


def test_load_clip_encoder_cpu_defaults(monkeypatch):
    """The defaults do not depend on the preset's widths: the preset builds
    the tiny test config here."""
    from fitclip_torch.models.clip import load

    monkeypatch.setitem(load.PRESETS, "ViT-B/32", CLIPConfig.tiny_test)
    loaded = load_clip_encoder("ViT-B/32", dtype="int8", device="cpu", seed=0)
    enc = loaded.encoder
    assert enc.quantized and enc.dtype == torch.bfloat16
    assert not enc.fused_attention and not enc.fused_block  # the CPU takes the plain path
    assert enc.model.visual.transformer.blocks[0].mlp_fc.weight_q.dtype == torch.int8
    with pytest.raises(ValueError, match="dtype"):
        load_clip_encoder("ViT-B/32", dtype="int4")
    with pytest.raises(ValueError, match="preset"):
        load_clip_encoder("ViT-H/14")
