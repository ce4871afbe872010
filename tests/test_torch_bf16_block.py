"""fitclip_torch's float layer (K2, ``ops/block.fused_bf16_layer``) and CLIP's
float fast path against the JAX package.

The port's layer runs its plain versions on the CPU and is held against the
TPU kernel ``fused_bf16_layer`` in Pallas interpret mode (fp32,
Precision.HIGHEST) on the same float parameters, at atol/rtol 2e-4
(tests/test_block_kernel.py's float bound). The width-128 config has the real
head_dim 64. The JAX side is jitted: eager interpret mode is slow here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip import CLIPConfig as JaxConfig
from fitclip_tpu.models.clip import CLIPModel as JaxModel
from fitclip_tpu.models.clip import fast_eval as jax_fast
from fitclip_tpu.models.clip.model import TextConfig as JaxText
from fitclip_tpu.models.clip.model import VisionConfig as JaxVision
from fitclip_tpu.ops import block as jax_block
from fitclip_torch.convert.from_jax import params_from_jax
from fitclip_torch.models.clip import fast_eval
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, TextConfig, VisionConfig
from fitclip_torch.ops import attention as A
from fitclip_torch.ops import block as K

TOL = dict(atol=2e-4, rtol=2e-4)
NARROW = dict(embed_dim=32, vision=dict(image_size=32, patch_size=16, width=128, layers=2,
                                        heads=2),
              text=dict(context_length=16, vocab_size=64, width=128, layers=2, heads=2))


@pytest.fixture(scope="module")
def narrow():
    """The JAX float tree (numpy) and the same weights in the port's model."""
    jax_cfg = JaxConfig(embed_dim=NARROW["embed_dim"], vision=JaxVision(**NARROW["vision"]),
                        text=JaxText(**NARROW["text"]))
    cfg = CLIPConfig(embed_dim=NARROW["embed_dim"], vision=VisionConfig(**NARROW["vision"]),
                     text=TextConfig(**NARROW["text"]))
    params = JaxModel(jax_cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                    jnp.zeros((1, 16), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    # Non-trivial LayerNorm and bias leaves, so every operand is exercised.
    rng = np.random.default_rng(1)
    blocks = params["visual"]["transformer"]["blocks"]
    for node in (blocks["ln_1"]["ln"], blocks["ln_2"]["ln"]):
        node["scale"] = (1 + 0.1 * rng.normal(size=node["scale"].shape)).astype(np.float32)
        node["bias"] = (0.1 * rng.normal(size=node["bias"].shape)).astype(np.float32)
    for node in (blocks["attn"]["in_proj"], blocks["attn"]["out_proj"], blocks["mlp_fc"],
                 blocks["mlp_proj"]):
        node["bias"] = (0.1 * rng.normal(size=node["bias"].shape)).astype(np.float32)
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    return jax_cfg, cfg, params, model


@functools.partial(jax.jit, static_argnames=("heads", "causal", "quick_gelu", "seq_valid"))
def _jax_layer(x, node, heads, causal, quick_gelu, seq_valid):
    return jax_block.fused_bf16_layer(x, node, heads, causal=causal, quick_gelu=quick_gelu,
                                      interpret=True, seq_valid=seq_valid)


@pytest.mark.parametrize("quick_gelu,causal,seq_valid", [
    (True, False, None), (True, True, None), (False, False, None), (False, True, None),
    (True, False, 4), (False, True, 5)])
def test_float_layer_matches_pallas_interpret(narrow, quick_gelu, causal, seq_valid):
    _, _, params, model = narrow
    node = jax.tree_util.tree_map(lambda a: a[1], params["visual"]["transformer"]["blocks"])
    x = np.random.default_rng(5).normal(size=(3, 6, 128)).astype(np.float32)
    ref = _jax_layer(jnp.asarray(x), node, 2, causal, quick_gelu, seq_valid)
    ops = K.prepare_bf16_layer(model.visual.transformer.blocks[1])
    out = K.fused_bf16_layer(torch.from_numpy(x), ops, 2, causal=causal, quick_gelu=quick_gelu,
                             seq_valid=seq_valid)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_exact_gelu_plain_matches_jax():
    h = np.random.default_rng(2).normal(size=(4, 257)).astype(np.float32) * 4
    np.testing.assert_allclose(K.exact_gelu_plain(torch.from_numpy(h)).numpy(),
                               np.asarray(jax_block._exact_gelu(jnp.asarray(h))),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal,seq_valid", [(False, None), (True, None), (False, 5)])
def test_block_attention_plain_matches_jax_core(causal, seq_valid):
    """The block mode's plain version against block.py:_attention_core
    without out_mul (weights exps * (1 / denom), fp32 out)."""
    qkv = np.random.default_rng(3).normal(size=(2, 7, 3 * 128)).astype(np.float32)
    ref = jax_block._attention_core(jnp.asarray(qkv), 2, 64 ** -0.5, causal, jnp.float32,
                                    seq_valid=seq_valid)
    out = A.attention_block(torch.from_numpy(qkv), 2, 64 ** -0.5, causal, seq_valid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_ln_cast_plain_rounds_jax_ln_once():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 96)).astype(np.float32) * 3
    w, b = (1 + 0.1 * rng.normal(size=96)).astype(np.float32), rng.normal(size=96).astype(
        np.float32)
    ref = jax_block._ln(jnp.asarray(x), jnp.asarray(w)[None], jnp.asarray(b)[None], 1e-6)
    out = K.ln_cast(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                    torch.float32, 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    bf16 = K.ln_cast(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), torch.from_numpy(b),
                     torch.bfloat16, 1e-6)
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, K.layer_norm_plain(torch.from_numpy(x).bfloat16(),
                                                        torch.from_numpy(w), torch.from_numpy(b),
                                                        1e-6).bfloat16(), atol=0, rtol=0)


@pytest.fixture(scope="module")
def jax_fast_float(narrow):
    jax_cfg, _, params, _ = narrow
    frames = jax.jit(functools.partial(jax_fast.encode_frames_fast, config=jax_cfg,
                                       dtype=jnp.float32))
    text = jax.jit(functools.partial(jax_fast.encode_text_fast, config=jax_cfg,
                                     dtype=jnp.float32))
    rng = np.random.default_rng(6)
    images = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 60, size=(3, 16)).astype(np.int32)
    return images, ids, np.asarray(frames(params, images)), np.asarray(text(params, ids))


def test_float_fast_path_matches_jax(narrow, jax_fast_float):
    _, _, _, model = narrow
    images, ids, img_ref, txt_ref = jax_fast_float
    img = fast_eval.encode_frames_fast(model, torch.from_numpy(images))
    txt = fast_eval.encode_text_fast(model, torch.from_numpy(ids).long())
    np.testing.assert_allclose(img.numpy(), img_ref, **TOL)
    np.testing.assert_allclose(txt.numpy(), txt_ref, **TOL)


def test_float_encoder_with_fused_block_runs_the_float_layer(narrow, jax_fast_float):
    """ClipVideoTextEncoder(fused_block=True) on a float model takes K2's path
    (its plain versions here) and launches nothing on the CPU."""
    _, cfg, params, _ = narrow
    images, ids, img_ref, txt_ref = jax_fast_float
    enc = ClipVideoTextEncoder(cfg, num_frames=3, fused_block=True)
    enc.model.load_state_dict(params_from_jax(params, cfg))
    wrappers = (K.ln_cast, K.bf16_gemm_bias, K.bf16_gemm_residual, K.bf16_gemm_gelu,
                A.attention_block)
    before = [fn.launches for fn in wrappers]
    video = enc.encode_video(torch.from_numpy(images)[None])
    text = enc.encode_text(torch.from_numpy(ids).long())
    assert [fn.launches for fn in wrappers] == before
    emb = img_ref / np.linalg.norm(img_ref, axis=-1, keepdims=True)
    np.testing.assert_allclose(video.numpy()[0], emb.mean(0), **TOL)
    np.testing.assert_allclose(
        text.numpy(), txt_ref / np.linalg.norm(txt_ref, axis=-1, keepdims=True), **TOL)


def test_float_operands_are_cached_and_refold(narrow):
    _, cfg, params, _ = narrow
    model = CLIPModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    block = model.visual.transformer.blocks[0]
    first = block.bf16_operands()
    assert block.bf16_operands() is first
    assert first.wq.shape == (3 * 128, 128) and first.wq.is_contiguous()
    bias = first.fb.clone()
    with torch.no_grad():
        block.mlp_fc.bias.add_(1.0)
    second = block.bf16_operands()
    assert second is not first
    torch.testing.assert_close(second.fb, bias + 1.0)


def test_bf16_model_folds_bf16_weights(narrow):
    _, cfg, params, _ = narrow
    model = CLIPModel(cfg, dtype=torch.bfloat16)
    model.load_state_dict(params_from_jax(params, cfg))
    ops = model.text.transformer.blocks[0].bf16_operands()
    assert ops.wq.dtype == torch.bfloat16 and ops.qb.dtype == torch.float32
    assert ops.ln1_weight.dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 16, 128)).astype(np.float32))
    out = K.fused_bf16_layer(x.bfloat16(), ops, 2, causal=True, quick_gelu=True)
    ref = K.fused_bf16_layer_plain(x.bfloat16(), ops, 2, causal=True, quick_gelu=True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
