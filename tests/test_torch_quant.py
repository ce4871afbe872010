"""fitclip_torch/ops/quant.py and the port's calibration against the JAX package:
the same quantized arrays, act-scale files that load in either package, the
fail-closed uncalibrated check, and calibrated scales that match."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip import CLIPConfig as JaxConfig
from fitclip_tpu.models.clip import CLIPModel as JaxModel
from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
from fitclip_tpu.ops import quant as jax_quant
from fitclip_torch.convert.from_jax import params_from_jax
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel
from fitclip_torch.ops import quant


@pytest.fixture(scope="module")
def float_params():
    params = JaxModel(JaxConfig.tiny_test()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 16), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params["params"])


def _int8_model(tree):
    model = CLIPModel(CLIPConfig.tiny_test(), quantized=True)
    model.load_state_dict(params_from_jax(tree, CLIPConfig.tiny_test()))
    return model


def _scales(model):
    return {site: np.stack([m.act_scale.numpy() for m in modules])
            for site, modules in quant.act_scale_sites(model).items()}


def _jax_scales(tree):
    return {path: np.asarray(node["act_scale"])
            for path, node in jax_quant._act_scale_items(tree)}


def test_quantize_clip_params_matches_jax_exactly(float_params):
    ref = jax.tree_util.tree_map(np.asarray, jax_quant.quantize_clip_params(float_params))
    ours = quant.quantize_clip_params(float_params)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_int8_denses_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32) * 2
    node = jax_quant._quantize_dense_node({"kernel": rng.normal(size=(32, 24)).astype(np.float32),
                                           "bias": rng.normal(size=(24,)).astype(np.float32)})
    w = torch.from_numpy(node["kernel_q"].T.copy())
    scale, bias = torch.from_numpy(node["scale"]), torch.from_numpy(node["bias"])
    act = np.array([4.5], np.float32)
    np.testing.assert_allclose(
        quant.int8_dense(torch.from_numpy(x), w, scale, bias).numpy(),
        np.asarray(jax_quant.int8_dense(x, node["kernel_q"], node["scale"], node["bias"])),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        quant.int8_dense_static(torch.from_numpy(x), w, scale, bias, torch.from_numpy(act)).numpy(),
        np.asarray(jax_quant.int8_dense_static(x, node["kernel_q"], node["scale"],
                                               node["bias"], act)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_act_scale_files_load_in_either_package(float_params, tmp_path, writer):
    rng = np.random.default_rng(2)
    tree = jax_quant.quantize_clip_params(float_params)
    for _, node in jax_quant._act_scale_items(tree):
        node["act_scale"] = rng.uniform(0.5, 8.0, node["act_scale"].shape).astype(np.float32)
    path = str(tmp_path / "scales.npz")
    if writer == "jax":
        jax_quant.save_act_scales(path, tree)
        model = quant.load_act_scales(path, _int8_model(jax_quant.quantize_clip_params(
            float_params)))
        got, want = _scales(model), _jax_scales(tree)
    else:
        quant.save_act_scales(path, _int8_model(tree))
        loaded = jax_quant.load_act_scales(path, jax_quant.quantize_clip_params(float_params))
        got, want = _jax_scales(loaded), _jax_scales(tree)
    assert sorted(got) == sorted(want)
    for site in want:
        np.testing.assert_array_equal(got[site].reshape(want[site].shape), want[site])


def test_partial_act_scale_file_is_refused(float_params, tmp_path):
    path = str(tmp_path / "partial.npz")
    np.savez(path, **{"visual/transformer/blocks/mlp_fc": np.ones((2, 1), np.float32)})
    with pytest.raises(KeyError):
        quant.load_act_scales(path, _int8_model(jax_quant.quantize_clip_params(float_params)))


def test_require_calibrated_fails_closed(float_params):
    model = _int8_model(jax_quant.quantize_clip_params(float_params))
    with pytest.raises(ValueError, match="uncalibrated"):
        quant.require_calibrated(model, "test")
    quant.apply_act_scales(model, {site: np.full((2, 1), 2.0, np.float32)
                                   for site in quant.act_scale_sites(model)})
    quant.require_calibrated(model, "test")


def test_merge_act_amax():
    a = {"s": np.array([[1.0], [5.0]], np.float32)}
    b = {"s": np.array([[3.0], [2.0]], np.float32)}
    assert quant.merge_act_amax(None, b) is b and quant.merge_act_amax(a, None) is a
    np.testing.assert_array_equal(quant.merge_act_amax(a, b)["s"], [[3.0], [5.0]])


@pytest.mark.parametrize("fused_attention", [False, True])
def test_calibration_matches_jax(float_params, fused_attention):
    """Both packages calibrate in dynamic-quant mode on uint8 clips (normalized
    on the device) and token rows; the scales agree."""
    rng = np.random.default_rng(3)
    video = rng.integers(0, 256, size=(2, 2, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 60, size=(3, 16)).astype(np.int32)
    qtree = jax_quant.quantize_clip_params(float_params)
    jax_enc = JaxEncoder(JaxConfig.tiny_test(), num_frames=2, quantized=True,
                         fused_attention=fused_attention)
    ref = jax_enc.calibrate(qtree, jnp.asarray(video), jnp.asarray(ids), margin=1.1)

    enc = ClipVideoTextEncoder(CLIPConfig.tiny_test(), num_frames=2, quantized=True,
                               fused_attention=fused_attention)
    enc.model.load_state_dict(params_from_jax(qtree, CLIPConfig.tiny_test()))
    enc.calibrate(torch.from_numpy(video), torch.from_numpy(ids).long(), margin=1.1)
    got, want = _scales(enc.model), _jax_scales(ref)
    assert sorted(got) == sorted(want)
    for site in want:
        np.testing.assert_allclose(got[site].reshape(want[site].shape), want[site], rtol=1e-4)
        assert not np.all(want[site] == 1.0)
