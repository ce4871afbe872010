"""fitclip_torch/models/clip/model.py and convert/from_jax.py against the flax
CLIPModel: the float model on both towers at the reference's float bound
(atol/rtol 2e-4, tests/test_block_kernel.py), at the tiny test config and at a
narrow config with the real head_dim 64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip import CLIPConfig as JaxConfig
from fitclip_tpu.models.clip import CLIPModel as JaxModel
from fitclip_tpu.models.clip.model import TextConfig as JaxText
from fitclip_tpu.models.clip.model import VisionConfig as JaxVision
from fitclip_tpu.models.clip.model import fold_pixel_normalization as jax_fold
from fitclip_tpu.ops.quant import quantize_clip_params as jax_quantize
from fitclip_torch.convert.from_jax import params_from_jax, params_to_jax
from fitclip_torch.models.clip import model as M

NARROW = dict(embed_dim=32, vision=dict(image_size=32, patch_size=16, width=128, layers=2,
                                        heads=2),
              text=dict(context_length=16, vocab_size=64, width=128, layers=2, heads=2))
MEAN, STD = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)


def _configs(name):
    if name == "tiny":
        return JaxConfig.tiny_test(), M.CLIPConfig.tiny_test()
    return (JaxConfig(embed_dim=NARROW["embed_dim"], vision=JaxVision(**NARROW["vision"]),
                      text=JaxText(**NARROW["text"])),
            M.CLIPConfig(embed_dim=NARROW["embed_dim"], vision=M.VisionConfig(**NARROW["vision"]),
                         text=M.TextConfig(**NARROW["text"])))


@pytest.fixture(scope="module", params=["tiny", "narrow"])
def setup(request):
    jax_cfg, cfg = _configs(request.param)
    params = JaxModel(jax_cfg).init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                                    jnp.zeros((1, 16), jnp.int32))["params"]
    return jax_cfg, cfg, jax.tree_util.tree_map(np.asarray, params)


def test_float_model_matches_flax(setup):
    jax_cfg, cfg, params = setup
    rng = np.random.default_rng(7)
    images = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 60, size=(3, 16)).astype(np.int32)
    img_ref, txt_ref = JaxModel(jax_cfg).apply({"params": params}, images, ids)
    for fused in (False, True):
        model = M.CLIPModel(cfg, fused_attention=fused)
        model.load_state_dict(params_from_jax(params, cfg))
        with torch.no_grad():
            img, txt = model(torch.from_numpy(images), torch.from_numpy(ids).long())
        np.testing.assert_allclose(img.numpy(), np.asarray(img_ref), atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(txt.numpy(), np.asarray(txt_ref), atol=2e-4, rtol=2e-4)


def test_params_round_trip(setup):
    _, cfg, params = setup
    for tree in (params, jax_quantize(params)):
        back = params_to_jax(params_from_jax(tree, cfg), cfg)
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


def test_fold_pixel_normalization_matches_jax(setup):
    _, cfg, params = setup
    model = M.CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    M.fold_pixel_normalization(model, MEAN, STD)
    folded = params_to_jax(model.state_dict(), cfg)["visual"]["patch_embed"]
    ref = jax_fold(params, MEAN, STD)["visual"]["patch_embed"]
    np.testing.assert_allclose(folded["kernel"], ref["kernel"], rtol=1e-6)
    np.testing.assert_allclose(folded["bias"], ref["bias"], rtol=1e-5, atol=1e-6)
    # uint8 pixels through the folded model == normalized pixels through the original.
    original = M.CLIPModel(cfg)
    original.load_state_dict(params_from_jax(params, cfg))
    pixels = np.random.default_rng(8).integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    normalized = ((pixels / 255.0 - np.array(MEAN)) / np.array(STD)).astype(np.float32)
    with torch.no_grad():
        torch.testing.assert_close(model.encode_image(torch.from_numpy(pixels)),
                                   original.encode_image(torch.from_numpy(normalized)),
                                   atol=2e-4, rtol=2e-4)


def test_seeded_init():
    cfg = M.CLIPConfig.tiny_test()
    a = M.init_float_params(M.CLIPModel(cfg), seed=3).state_dict()
    b = M.init_float_params(M.CLIPModel(cfg), seed=3).state_dict()
    c = M.init_float_params(M.CLIPModel(cfg), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["visual.proj"], c["visual.proj"])
    w = a["visual.transformer.blocks.0.mlp_fc.weight"]  # LeCun normal, truncated at 2 std
    assert w.abs().max() <= 2 / 48 ** 0.5 / 0.87962566103423978 + 1e-6
    assert abs(float(w.std()) - 48 ** -0.5) < 0.02
    assert torch.equal(a["text.ln_final.weight"], torch.ones(32))
    with pytest.raises(ValueError, match="float model"):
        M.init_float_params(M.CLIPModel(cfg, quantized=True), seed=0)
