"""The port's encoder can be trained through, with and without remat.

- ``encode_video``/``encode_text`` carry a gradient (the JAX train steps
  differentiate through them), and the fused attention's gradient reaches
  ``in_proj`` (on the CPU through the K3 Function's plain backward);
- the gradients agree with the JAX package's ``jax.grad`` through the same
  encoder at the tiny config (fp32, atol/rtol 2e-4, the float bound of
  tests/test_block_kernel.py);
- ``remat=True`` and ``remat="dots"`` give the gradients of ``remat=False``,
  and "dots" keeps the fused attention's output instead of recomputing it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.clip.model import CLIPConfig as JaxConfig
from fitclip_torch.convert.from_jax import params_to_jax
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.load import load_clip_encoder
from fitclip_torch.models.clip.model import CLIPConfig, init_float_params
from fitclip_torch.ops import attention as A


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(3, 2, 32, 32, 3), dtype=np.uint8),
            rng.integers(1, 60, size=(3, 16)).astype(np.int32))


def _loss_and_grads(encoder, video, ids):
    loss = (encoder.encode_video(torch.from_numpy(video))
            @ encoder.encode_text(torch.from_numpy(ids)).T).square().sum()
    names, params = zip(*encoder.model.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


def _encoder(**kwargs):
    enc = ClipVideoTextEncoder(CLIPConfig.tiny_test(), num_frames=2, **kwargs)
    init_float_params(enc.model, seed=0)
    return enc


def test_encoder_gradient_matches_jax():
    enc = _encoder(fused_attention=True)
    video, ids = _batch()
    out = enc.encode_video(torch.from_numpy(video))
    assert out.requires_grad and out.grad_fn is not None
    loss, grads = _loss_and_grads(enc, video, ids)
    in_proj = grads["visual.transformer.blocks.0.attn.in_proj.weight"]
    assert bool(torch.isfinite(in_proj).all()) and float(in_proj.abs().max()) > 0

    jax_enc = JaxEncoder(JaxConfig.tiny_test(), num_frames=2, fused_attention=True)
    params = params_to_jax(enc.model.state_dict(), enc.config)

    def jax_loss(p):
        v = jax_enc.encode_video(p, jnp.asarray(video))
        t = jax_enc.encode_text(p, jnp.asarray(ids))
        return jnp.square(v @ t.T).sum()

    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(jax.tree_util.tree_map(jnp.asarray, params))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    got = params_to_jax(grads, enc.config)
    for (path, ref), value in zip(jax.tree_util.tree_leaves_with_path(ref_grads),
                                  jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(value, np.asarray(ref), atol=2e-4, rtol=2e-4, err_msg=str(path))


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_gives_the_same_gradients(remat, monkeypatch):
    video, ids = _batch(1)
    ref_loss, ref = _loss_and_grads(_encoder(fused_attention=True), video, ids)
    forwards = []
    original = A.attention_core_plain

    def counting(*args, **kwargs):
        forwards.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(A, "attention_core_plain", counting)
    loss, grads = _loss_and_grads(_encoder(fused_attention=True, remat=remat), video, ids)
    assert loss.item() == ref_loss.item()
    for name, value in ref.items():
        torch.testing.assert_close(grads[name], value, rtol=0, atol=0, msg=name)
    layers = 2 * 2  # two towers of two layers
    # Full remat runs each attention forward again in the backward pass; "dots"
    # keeps its output.
    assert len(forwards) == (2 * layers if remat is True else layers)


def test_remat_is_off_without_grad_and_checked():
    enc = _encoder(remat=True)
    with torch.no_grad():
        out = enc.encode_text(torch.ones(2, 16, dtype=torch.long))
    assert out.grad_fn is None
    with pytest.raises(ValueError, match="remat"):
        _encoder(remat="everything")


def test_load_clip_encoder_passes_remat():
    enc = load_clip_encoder("ViT-B/32", dtype="float32", device="cpu", remat="dots").encoder
    assert enc.model.visual.transformer.remat == enc.model.text.transformer.remat == "dots"
