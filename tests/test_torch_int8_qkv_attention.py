"""K8 (``ops/attention.fused_int8_qkv_attention``: the int8 QKV projection and
the attention in one call) and the int8 module path with fused attention,
against the JAX package.

The port runs its plain versions on the CPU; the JAX side runs
``fused_int8_qkv_attention`` in Pallas interpret mode, jitted. K8 alone is
held at atol/rtol 2e-4 (fp32 throughout, exact int32 products); the whole
int8 module path at the int8 bound 2e-3 (tests/test_quant.py:268-282). The
width-128 config has the real head_dim 64.

An int8 activation that sits on a rounding boundary can round the other way
when the reference sums in another order (XLA:CPU splits its reductions over
the test mesh's threads), which moves an embedding by ~1e-2 whatever the
attention; the module-path inputs are drawn from a seed whose activations
keep clear of that in both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip import CLIPConfig as JaxConfig
from fitclip_tpu.models.clip import CLIPModel as JaxModel
from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.clip.model import TextConfig as JaxText
from fitclip_tpu.models.clip.model import VisionConfig as JaxVision
from fitclip_tpu.ops import attention as jax_attention
from fitclip_tpu.ops import quant as jax_quant
from fitclip_torch.convert.from_jax import params_from_jax, params_to_jax
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, TextConfig, VisionConfig
from fitclip_torch.ops import attention as A
from fitclip_torch.ops import block as K
from fitclip_torch.ops import quant

NARROW = dict(embed_dim=32, vision=dict(image_size=32, patch_size=16, width=128, layers=2,
                                        heads=2),
              text=dict(context_length=16, vocab_size=64, width=128, layers=2, heads=2))


@functools.partial(jax.jit, static_argnames=("heads", "causal"))
def _jax_k8(x_q, kernel_q, out_scale, bias, heads, causal):
    return jax_attention.fused_int8_qkv_attention(x_q, kernel_q, out_scale, bias, heads,
                                                  64 ** -0.5, causal, interpret=True,
                                                  out_dtype=jnp.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_k8_matches_pallas_interpret(causal):
    rng = np.random.default_rng(0)
    width, heads = 128, 2
    x_q = rng.integers(-127, 128, size=(3, 7, width)).astype(np.int8)
    kernel_q = rng.integers(-127, 128, size=(width, 3 * width)).astype(np.int8)
    out_scale = (rng.uniform(0.5, 1.5, 3 * width) / (127.0 * 127.0)).astype(np.float32)
    bias = (0.1 * rng.normal(size=3 * width)).astype(np.float32)
    ref = _jax_k8(x_q, kernel_q, out_scale, bias, heads, causal)
    before = A.fused_int8_qkv_attention.launches
    out = A.fused_int8_qkv_attention(torch.from_numpy(x_q), torch.from_numpy(kernel_q.T.copy()),
                                     torch.from_numpy(out_scale), torch.from_numpy(bias), heads,
                                     64 ** -0.5, causal, out_dtype=torch.float32)
    assert A.fused_int8_qkv_attention.launches == before  # the CPU takes the plain version
    assert out.dtype == torch.float32 and out.shape == (3, 7, width)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


def test_k8_bf16_output_is_the_qkv_mode_on_the_rounded_projection():
    """qkv = (acc * scale + bias) cast to out_dtype, then the qkv-mode softmax."""
    gen = torch.Generator().manual_seed(1)
    x_q = torch.randint(-127, 128, (2, 5, 128), generator=gen, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (384, 128), generator=gen, dtype=torch.int8)
    scale, bias = torch.full((384,), 1.0 / 127 ** 2), torch.randn(384, generator=gen)
    out = A.fused_int8_qkv_attention(x_q, w_q, scale, bias, 2, 0.125, False)
    qkv = K.int8_gemm_bias_plain(x_q.view(10, 128), w_q, scale, bias, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, A.fused_attention_qkv(qkv.view(2, 5, 384), 2, 0.125),
                               atol=0, rtol=0)


@pytest.fixture(scope="module")
def calibrated():
    jax_cfg = JaxConfig(embed_dim=NARROW["embed_dim"], vision=JaxVision(**NARROW["vision"]),
                        text=JaxText(**NARROW["text"]))
    cfg = CLIPConfig(embed_dim=NARROW["embed_dim"], vision=VisionConfig(**NARROW["vision"]),
                     text=TextConfig(**NARROW["text"]))
    params = JaxModel(jax_cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                    jnp.zeros((1, 16), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(9)
    enc = ClipVideoTextEncoder(cfg, num_frames=1, quantized=True)
    enc.model.load_state_dict(params_from_jax(jax_quant.quantize_clip_params(params), cfg))
    enc.calibrate(torch.from_numpy(rng.normal(size=(4, 1, 32, 32, 3)).astype(np.float32)),
                  torch.from_numpy(rng.integers(1, 60, size=(4, 16))))
    return jax_cfg, cfg, params_to_jax(enc.model.state_dict(), cfg)


def test_int8_module_path_with_fused_attention_matches_jax(calibrated):
    """CLIPModel(quantized=True, fused_attention=True): K8 in every block."""
    jax_cfg, cfg, qparams = calibrated
    rng = np.random.default_rng(5)
    images = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 60, size=(3, 16)).astype(np.int32)
    jax_model = JaxModel(jax_cfg, quantized=True, fused_attention=True)
    img_ref, txt_ref = jax.jit(jax_model.apply)({"params": qparams}, images, ids)
    model = CLIPModel(cfg, quantized=True, fused_attention=True)
    model.load_state_dict(params_from_jax(qparams, cfg))
    with torch.no_grad():
        img, txt = model(torch.from_numpy(images), torch.from_numpy(ids).long())
    np.testing.assert_allclose(img.numpy(), np.asarray(img_ref), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(txt.numpy(), np.asarray(txt_ref), atol=2e-3, rtol=2e-3)


def test_int8_encoder_module_path_on_uint8_clips_matches_jax(calibrated):
    jax_cfg, cfg, qparams = calibrated
    rng = np.random.default_rng(5)
    video = rng.integers(0, 256, size=(2, 2, 32, 32, 3), dtype=np.uint8)
    jax_enc = JaxEncoder(jax_cfg, num_frames=2, quantized=True, fused_attention=True,
                         fused_block=False)
    ref = jax.jit(jax_enc.encode_video)(qparams, jnp.asarray(video))
    enc = ClipVideoTextEncoder(cfg, num_frames=2, quantized=True, fused_attention=True,
                               fused_block=False)
    enc.model.load_state_dict(params_from_jax(qparams, cfg))
    with torch.no_grad():
        out = enc.encode_video(torch.from_numpy(video))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def test_k8_path_keeps_the_calibration_sites(calibrated):
    """The in_proj still records its input's abs-max under the K8 branch, and
    calibration (dynamic mode) names the same sites as without fused attention."""
    _, cfg, qparams = calibrated
    model = CLIPModel(cfg, quantized=True, fused_attention=True)
    model.load_state_dict(params_from_jax(qparams, cfg))
    dense = model.visual.transformer.blocks[0].attn.in_proj
    dense.observe = True
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        model.encode_image(x)
    assert dense.observed_amax is not None and float(dense.observed_amax) > 0
    assert sorted(quant.act_scale_sites(model)) == sorted(
        quant.act_scale_sites(CLIPModel(cfg, quantized=True)))


def test_static_int8_dense_on_the_cpu_is_unchanged():
    """int8_dense_static's CPU product stays the exact integer one."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 6, 64, generator=gen) * 2
    w_q = torch.randint(-127, 128, (48, 64), generator=gen, dtype=torch.int8)
    scale, bias, act = torch.rand(48, generator=gen) / 100, torch.randn(48, generator=gen), \
        torch.tensor([3.0])
    before = K.int8_gemm_bias.launches
    out = quant.int8_dense_static(x, w_q, scale, bias, act)
    x_q = quant.quantize_rint(x * (127.0 / 3.0)).view(-1, 64)
    want = (x_q.int() @ w_q.int().T).float() * ((act / 127.0) * scale) + bias
    torch.testing.assert_close(out, want.view(4, 6, 48), atol=0, rtol=0)
    assert K.int8_gemm_bias.launches == before
