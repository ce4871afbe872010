"""fitclip_torch/ops/block.py (the int8 layer) against the JAX package.

The port's layer runs its plain versions on the CPU and is held against the
TPU kernel ``fused_int8_layer`` in Pallas interpret mode (which divides
exactly), on the same calibrated int8 parameters, at the reference's own int8
bound (atol/rtol 2e-3, tests/test_block_kernel.py). The width-128 config has
the real head_dim 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip import CLIPConfig as JaxConfig
from fitclip_tpu.models.clip import CLIPModel as JaxModel
from fitclip_tpu.models.clip.model import TextConfig as JaxText
from fitclip_tpu.models.clip.model import VisionConfig as JaxVision
from fitclip_tpu.ops import quant as jax_quant
from fitclip_tpu.ops.block import _dense_operands
from fitclip_tpu.ops.block import fused_int8_layer as jax_fused_int8_layer
from fitclip_torch.convert.from_jax import params_from_jax, params_to_jax
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, TextConfig, VisionConfig
from fitclip_torch.ops import block as K
from fitclip_torch.ops.quant import apply_act_scales, load_act_scales, save_act_scales

NARROW = dict(embed_dim=32, vision=dict(image_size=32, patch_size=16, width=128, layers=2,
                                        heads=2),
              text=dict(context_length=16, vocab_size=64, width=128, layers=2, heads=2))


def _configs():
    jax_cfg = JaxConfig(embed_dim=NARROW["embed_dim"], vision=JaxVision(**NARROW["vision"]),
                        text=JaxText(**NARROW["text"]))
    cfg = CLIPConfig(embed_dim=NARROW["embed_dim"], vision=VisionConfig(**NARROW["vision"]),
                     text=TextConfig(**NARROW["text"]))
    return jax_cfg, cfg


@pytest.fixture(scope="module")
def calibrated():
    """A calibrated int8 tree (JAX), and the same weights in the port's model."""
    jax_cfg, cfg = _configs()
    params = JaxModel(jax_cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                    jnp.zeros((1, 16), jnp.int32))["params"]
    # Scales calibrated by the port (held against JAX's in test_torch_quant.py).
    rng = np.random.default_rng(9)
    enc = ClipVideoTextEncoder(cfg, num_frames=1, quantized=True)
    enc.model.load_state_dict(params_from_jax(jax_quant.quantize_clip_params(params), cfg))
    enc.calibrate(torch.from_numpy(rng.normal(size=(4, 1, 32, 32, 3)).astype(np.float32)),
                  torch.from_numpy(rng.integers(1, 60, size=(4, 16))))
    model = enc.model
    qparams = params_to_jax(model.state_dict(), cfg)
    return qparams, model


@pytest.mark.parametrize("quick_gelu,causal,seq_valid", [
    (True, False, None), (True, True, None), (False, False, None), (False, True, None),
    (True, False, 4)])
def test_int8_layer_matches_pallas_interpret(calibrated, quick_gelu, causal, seq_valid):
    qparams, model = calibrated
    node = jax.tree_util.tree_map(lambda a: a[1], qparams["visual"]["transformer"]["blocks"])
    x = np.random.default_rng(5).normal(size=(3, 6, 128)).astype(np.float32)
    ref = jax_fused_int8_layer(jnp.asarray(x), node, 2, causal=causal, quick_gelu=quick_gelu,
                               interpret=True, seq_valid=seq_valid)
    ops = K.prepare_int8_layer(model.visual.transformer.blocks[1], quick_gelu)
    out = K.fused_int8_layer(torch.from_numpy(x), ops, 2, causal=causal, seq_valid=seq_valid)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-3, rtol=2e-3)


def test_folded_operands_match_jax_folding(calibrated):
    """_dense_operands and the fs2/fb2/kv/invs folding of fused_int8_layer."""
    qparams, model = calibrated
    node = jax.tree_util.tree_map(lambda a: a[0], qparams["text"]["transformer"]["blocks"])
    ops = model.text.transformer.blocks[0].int8_operands()
    _, fs, fb, _ = _jax_dense_operands(node["mlp_fc"])
    inv_p = 127.0 / max(float(node["mlp_proj"]["act_scale"][0]), jax_quant.QUANT_EPS)
    np.testing.assert_allclose(ops.fs2.numpy(), fs * np.float32(inv_p), rtol=1e-6)
    np.testing.assert_allclose(ops.fb2.numpy(), fb * np.float32(inv_p), rtol=1e-6, atol=1e-7)
    assert ops.inv_o == pytest.approx(127.0 / float(node["attn"]["out_proj"]["act_scale"][0]),
                                      rel=1e-6)
    assert ops.kv == pytest.approx(-1.702 * K.LOG2E / inv_p, rel=1e-6)


def _jax_dense_operands(node):
    kernel_q, out_scale, bias, inv = _dense_operands(node)
    return kernel_q, np.asarray(out_scale)[0], np.asarray(bias)[0], float(inv)


def test_operands_refold_when_act_scales_change(calibrated, tmp_path):
    """Stale folded operands after calibration would silently use the old
    scales: every path that writes act_scale must refold."""
    qparams, _ = calibrated
    _, cfg = _configs()
    fresh = CLIPModel(cfg, quantized=True)
    fresh.load_state_dict(params_from_jax(qparams, cfg))
    block = fresh.visual.transformer.blocks[0]
    first = block.int8_operands()
    assert block.int8_operands() is first  # cached while nothing changes

    save_act_scales(str(tmp_path / "scales.npz"), fresh)
    apply_act_scales(fresh, {"visual/transformer/blocks/mlp_proj": np.full((2, 1), 3.0,
                                                                           np.float32)})
    second = block.int8_operands()
    assert second is not first
    assert second.kv == pytest.approx(-1.702 * K.LOG2E / (127.0 / 3.0), rel=1e-6)
    torch.testing.assert_close(second.fs2, K.prepare_int8_layer(block, True).fs2)

    load_act_scales(str(tmp_path / "scales.npz"), fresh)
    third = block.int8_operands()
    assert third.kv == pytest.approx(first.kv, rel=1e-7)
    torch.testing.assert_close(third.fs2, first.fs2)
