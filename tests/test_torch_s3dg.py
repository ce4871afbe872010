"""The port's S3D-G (fitclip_torch/models/s3dg.py, s3dg_fast.py) against the JAX
package on the CPU: the TF-'SAME' max pool, the fp32 module path against the
Flax module, the fast eval forward against ``s3dg_fast_apply`` (fp32 with the
XLA stem, bf16 with the Pallas stem in interpret mode), and the int8 sites:
quantization, one site's arithmetic, calibration and the calibrated embedding
(in fp32, where a bf16 rounding cannot flip an int8 quantization).

The parameters are one seeded numpy tree in the JAX layout
(``init_s3dg_params``, the Flax tree's structure), loaded into the port with
``s3dg_params_from_jax``; inputs are made with numpy. Bounds: fp32 2e-4 of the
output's max and bf16 0.05 of it with cosine > 0.999 (tests/test_s3dg_fast.py),
int8 cosine > 0.999 against JAX's int8 embedding.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.s3dg import S3DG as JaxS3DG
from fitclip_tpu.models import s3dg_fast as jax_s3dg_fast
from fitclip_tpu.models.s3dg import max_pool_3d_tf_padding as jax_pool
from fitclip_tpu.models.s3dg_fast import _int8_conv1x1
from fitclip_tpu.models.s3dg_fast import quantize_s3dg_fast as jax_quantize
from fitclip_tpu.models.s3dg_fast import s3dg_fast_apply as jax_fast
from fitclip_tpu.ops.quant import apply_act_scales as jax_apply_act_scales
from fitclip_torch.convert.from_jax import s3dg_params_from_jax
from fitclip_torch.models import s3dg as M
from fitclip_torch.models.clip.model import QuantDense
from fitclip_torch.models import s3dg_fast as port_s3dg_fast
from fitclip_torch.models.s3dg_fast import (_int8_site, fast_operands, quantize_s3dg_fast,
                                            s3dg_fast_apply)
from fitclip_torch.ops.block import dense_operands, int8_gemm_bias
from fitclip_torch.ops.quant import (act_scale_sites, dynamic_observing, observed_act_amax,
                                     quantize_weight)

VIDEO_SHAPE = (2, 8, 32, 32, 3)


def _cosine(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def _port(tree, dtype=torch.float32, int8_from=False):
    model = M.S3DG(dtype=dtype, int8_from=int8_from)
    model.load_state_dict(s3dg_params_from_jax(tree))
    return model


def _flat_amax(collect, prefix=""):
    out = {}
    for key, node in collect.items():
        if "act_amax" in node:
            out[f"{prefix}{key}"] = float(np.asarray(node["act_amax"][0]).reshape(-1)[0])
        else:
            out.update(_flat_amax(node, f"{prefix}{key}/"))
    return out


@pytest.fixture(scope="module")
def setup():
    tree = M.init_s3dg_params(0)
    video = np.random.default_rng(1).random(VIDEO_SHAPE).astype(np.float32)
    return tree, video


@pytest.mark.parametrize("size", [(2, 5, 7, 9, 4), (2, 4, 8, 8, 4)])
@pytest.mark.parametrize("kernel,stride", [((1, 3, 3), (1, 2, 2)), (3, 1), (3, 2), (2, 2)])
def test_max_pool_tf_padding_bit_equal(size, kernel, stride):
    x = np.random.default_rng(0).normal(size=size).astype(np.float32)
    ref = np.asarray(jax_pool(jnp.asarray(x), kernel, stride))
    got = M.max_pool_3d_tf_padding(torch.from_numpy(x), kernel, stride).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_seeded_tree_has_the_flax_structure(setup):
    tree, _ = setup
    shapes = jax.eval_shape(lambda: JaxS3DG().init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 16, 32, 32, 3))))["params"]
    assert (jax.tree_util.tree_map(lambda a: a.shape, shapes)
            == jax.tree_util.tree_map(lambda a: a.shape, tree))


def test_module_fp32_matches_flax(setup):
    tree, video = setup
    ref = np.asarray(jax.jit(lambda p, v: JaxS3DG().apply({"params": p}, v))(tree, video))
    with torch.no_grad():
        got = _port(tree)(torch.from_numpy(video)).numpy()
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, ref, atol=2e-4 * np.abs(ref).max(), rtol=0)


def test_fast_fp32_matches_jax_fast(setup):
    tree, video = setup
    ref = np.asarray(jax.jit(lambda p, v: jax_fast(p, v, dtype=jnp.float32,
                                                   stem_kernel=False))(tree, video))
    with torch.no_grad():
        got = s3dg_fast_apply(_port(tree), torch.from_numpy(video), torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4 * np.abs(ref).max(), rtol=0)


def test_fast_bf16_matches_jax_stem_kernel_path(setup):
    tree, video = setup
    ref = np.asarray(jax.jit(lambda p, v: jax_fast(p, v, dtype=jnp.bfloat16,
                                                   stem_kernel=True))(tree, video), np.float32)
    model = _port(tree, torch.bfloat16)
    with torch.no_grad():
        got = s3dg_fast_apply(model, torch.from_numpy(video)).float().numpy()
        module = model(torch.from_numpy(video)).float().numpy()
    for out in (got, module):
        np.testing.assert_allclose(out, ref, atol=0.05 * np.abs(ref).max(), rtol=0)
        assert _cosine(out, ref) > 0.999


@pytest.mark.parametrize("from_block", [None, "mixed_4b", "mixed_5b"])
def test_quantize_matches_jax(setup, from_block):
    """The same sites, and the same int8 leaves up to the fold's reciprocal square
    root (XLA's CPU rsqrt against the port's 1 / sqrt, a few fp32 ulp): scales
    and biases to 1e-6, weights one step apart on at most 1e-4 of entries."""
    tree, _ = setup
    ref, got = jax_quantize(tree, from_block)["int8"], quantize_s3dg_fast(tree, from_block)["int8"]
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(got)
    assert set(got) == {p.split("/")[0] for p in M.int8_site_names(from_block)}
    for r, g in zip(jax.tree_util.tree_leaves_with_path(ref), jax.tree_util.tree_leaves(got)):
        path, r = r
        r = np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, path
        if r.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - r.astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() <= 1e-4, path
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-8, err_msg=str(path))


def test_int8_site_matches_jax():
    """One quantized 1x1x1 site on the same input: the dynamic (calibration) mode
    with its recorded abs-max, and the static mode through int8_gemm_bias."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 2, 3, 3, 64)).astype(np.float32)
    node = quantize_weight(rng.normal(size=(64, 96)).astype(np.float32) * 0.1)
    node.update(bias=rng.normal(size=96).astype(np.float32), act_scale=np.float32([3.5]))
    site = QuantDense(64, 96, torch.float32)
    site.load_state_dict({"weight_q": torch.from_numpy(node["kernel_q"].T.copy()),
                          "scale": torch.from_numpy(node["scale"]),
                          "bias": torch.from_numpy(node["bias"]),
                          "act_scale": torch.from_numpy(node["act_scale"])})
    xt = torch.from_numpy(x)
    collect = {}
    ref = np.asarray(_int8_conv1x1(node, jnp.asarray(x), collect, "site"))
    with torch.no_grad(), dynamic_observing(site):
        got = _int8_site(site, None, xt, True, int8_gemm_bias).numpy()
        amax = float(site.observed_amax)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert amax == _flat_amax(collect)["site"]
    ref = np.asarray(_int8_conv1x1(node, jnp.asarray(x), None, "site"))
    with torch.no_grad():
        got = _int8_site(site, dense_operands(site), xt, True, int8_gemm_bias).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def _jax_calibrate(qtree, video):
    """JAX's dynamic-quant forward in fp32 (XLA stem), its abs-maxes as {site: amax}."""
    def collect(p, v):
        out = {}
        jax_fast(p, v, dtype=jnp.float32, int8=True, collect=out, stem_kernel=False)
        return out

    return jax.jit(collect)(qtree, video)


def _dynamic_quant(x):
    """int8_dense's dynamic per-row quantization in fp32: (int8 values, x / step)."""
    amax = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-6))
    steps = x / (amax / np.float32(127.0))
    return np.clip(np.round(steps), -127, 127), steps


@pytest.fixture(scope="module")
def calibration(setup):
    """from_block=None on JAX's quantized tree, in fp32: both packages' whole
    dynamic-quant forwards, each site's abs-max and input ({site: array}),
    and the port's model."""
    tree, video = setup
    qtree = jax.tree_util.tree_map(np.asarray, jax_quantize(tree, None))

    def jax_run(p, v):
        inputs, collect = {}, {}

        def site(node, x, collect, name, relu=True):
            inputs[name] = x
            return _int8_conv1x1(node, x, collect, name, relu)

        with mock.patch.object(jax_s3dg_fast, "_int8_conv1x1", site):
            jax_fast(p, v, dtype=jnp.float32, int8=True, collect=collect, stem_kernel=False)
        return collect, inputs

    jax_amax, jax_inputs = jax.jit(jax_run)(qtree, video)
    model = _port(qtree, int8_from=None)
    names = {id(m): path for path, (m,) in act_scale_sites(model.int8).items()}
    port_inputs = {}

    def port_site(site, operands, x, relu, gemm):
        port_inputs[names[id(site)]] = x.numpy().copy()
        return _int8_site(site, operands, x, relu, gemm)

    with torch.no_grad(), dynamic_observing(model.int8), \
            mock.patch.object(port_s3dg_fast, "_int8_site", port_site):
        s3dg_fast_apply(model, torch.from_numpy(video), torch.float32, int8=True)
    port_amax = {site: float(v.reshape(-1)[0]) for site, v in observed_act_amax(model.int8).items()}
    return dict(qtree=qtree, model=model, jax_amax=_flat_amax(jax_amax), port_amax=port_amax,
                jax_inputs={k: np.asarray(v) for k, v in jax_inputs.items()},
                port_inputs=port_inputs)


# The forward's int8 stages, each one function of the two packages: conv_2b's
# site, the nine Inception blocks (sites merged and b3), the FC's site.
STAGES = ["conv_2b", *M.BLOCKS, "fc"]


def _jax_stage(qtree, stage, x):
    """JAX's function of one stage on x: (its output, {site: abs-max})."""
    def run(p, x):
        collect = {}
        if stage in ("conv_2b", "fc"):
            out = _int8_conv1x1(p["int8"][stage], x, collect, stage, relu=stage == "conv_2b")
        else:
            out = jax_s3dg_fast._inception_block(p[stage], x, jax_s3dg_fast._BLOCK_WIDTHS[stage],
                                                 jnp.float32, q_block=p["int8"][stage],
                                                 collect=collect, site=stage)
        return out, collect

    out, collect = jax.jit(run)(qtree, x)
    return np.asarray(out), _flat_amax(collect)


def _port_stage(model, stage, x):
    """The port's function of one stage on x: (its output, {site: abs-max})."""
    ops = fast_operands(model, torch.float32)
    with torch.no_grad(), dynamic_observing(model.int8):
        if stage in ("conv_2b", "fc"):
            out = _int8_site(model.int8[stage], None, x, stage == "conv_2b", int8_gemm_bias)
        else:
            out = port_s3dg_fast._block(model, ops, stage, x, torch.float32, True, int8_gemm_bias)
        amax = {site: float(m.observed_amax.reshape(-1)[0])
                for site, (m,) in act_scale_sites(model.int8).items()
                if site.split("/")[0] == stage}
    return out.numpy(), amax


def test_calibration_covers_every_site_and_matches_jax(calibration):
    """from_block=None, fp32, on JAX's quantized tree. The whole dynamic-quant
    forward of each package observes the same 19 sites (the port in forward
    order). Each site's abs-max is then held at rel 1e-5 where it is defined
    alike on every host: teacher-forced stage by stage, JAX's input to each
    stage (conv_2b's site, an Inception block, the FC's site) goes through
    JAX's function of it and the port's, whose outputs agree within 1e-5 of
    their largest. (Across whole forwards, fp32 sums in another order move a
    few inputs of a dynamic quantization across a rounding boundary, and that
    one-step flip grows downstream: see the next test.)"""
    c = calibration
    names = list(M.int8_site_names(None))
    assert list(c["port_inputs"]) == list(c["port_amax"]) == names
    assert sorted(c["jax_amax"]) == sorted(c["jax_inputs"]) == sorted(names)
    assert all(np.isfinite(v) and v > 0 for v in (*c["jax_amax"].values(),
                                                  *c["port_amax"].values()))
    seen = []
    for stage in STAGES:
        x = c["jax_inputs"]["fc" if stage == "fc" else stage if stage == "conv_2b"
                            else f"{stage}/merged"]
        ref, ref_amax = _jax_stage(c["qtree"], stage, x)
        got, got_amax = _port_stage(c["model"], stage, torch.from_numpy(x.copy()))
        assert sorted(got_amax) == sorted(ref_amax)
        for site in ref_amax:
            assert got_amax[site] == pytest.approx(ref_amax[site], rel=1e-5), site
            assert ref_amax[site] == pytest.approx(c["jax_amax"][site], rel=1e-5), site
        seen += ref_amax
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()),
                                   err_msg=stage)
    assert sorted(seen) == sorted(names)


def test_calibration_chains_part_only_at_quantization_boundaries(calibration):
    """Where the whole forwards' abs-maxes part, they part at a flip: the
    first site whose dynamic per-row quantization differs between the
    packages takes inputs that differ by less than a thousandth of a
    quantization step, yet quantizes some of them one step apart, so each
    sat at a rounding boundary (k + 1/2 steps). Printed: the site, the count,
    the inputs' distance in ulps and their distance to the boundary. On a
    host where no quantization differs, there is nothing to show."""
    c = calibration
    for site in M.int8_site_names(None):
        got, ref = c["port_inputs"][site], c["jax_inputs"][site]
        q_got, steps_got = _dynamic_quant(got)
        q_ref, steps_ref = _dynamic_quant(ref)
        flipped = q_got != q_ref
        if flipped.any():
            break
    else:
        return
    ulps = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    to_boundary = np.abs(np.abs(steps_ref - np.floor(steps_ref)) - 0.5)
    print(f"\nfirst quantization that differs: {site}, {int(flipped.sum())} of {got.size} "
          f"elements one step apart; their inputs {ulps[flipped].tolist()} ulp apart, "
          f"{to_boundary[flipped].tolist()} steps from a rounding boundary")
    assert np.all(np.abs(q_got - q_ref)[flipped] == 1)
    assert float(np.abs(steps_got - steps_ref)[flipped].max()) < 1e-3


@pytest.mark.parametrize("from_block", ["mixed_4b", None])
def test_calibrated_int8_embedding_matches_jax(setup, from_block):
    """The int8 forward on JAX's calibrated tree, fp32 activations: the port's
    embedding against JAX's. (In bf16 both packages' int8 embeddings sit at
    cosine 0.998 from their bf16 ones, and from each other: a one-ulp bf16
    difference flips a static quantization.)"""
    tree, video = setup
    qtree = jax_quantize(tree, from_block)
    qtree = jax.tree_util.tree_map(np.asarray, jax_apply_act_scales(
        qtree, {"int8": _jax_calibrate(qtree, video)}))
    ref = np.asarray(jax.jit(lambda p, v: jax_fast(p, v, dtype=jnp.float32, int8=True,
                                                   stem_kernel=False))(qtree, video))
    model = _port(qtree, int8_from=from_block)
    with torch.no_grad():
        got = s3dg_fast_apply(model, torch.from_numpy(video), torch.float32, int8=True).numpy()
    assert _cosine(got, ref) > 0.999
