"""The port's MIL-NCE encoder (fitclip_torch/models/mil_nce.py) against the JAX
package on the CPU: the word tokenizer, the text tower, the checkpoint
converter, the encoder's input handling and the loader.

Parameters are the port's seeded numpy tree in the JAX layout, loaded into the
port with ``mil_nce_params_from_jax`` and applied as they are by Flax; inputs are
made with numpy. The text tower is fp32 on both sides: 1e-5.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.mil_nce import MilNceTokenizer as JaxTokenizer
from fitclip_tpu.models.mil_nce import mil_nce_params_from_torch as jax_from_torch
from fitclip_tpu.models.s3dg import MilNceTextEncoder as JaxText
from fitclip_torch.convert.from_jax import mil_nce_params_from_jax
from fitclip_torch.models import mil_nce as N
from fitclip_torch.models.s3dg import int8_site_names

VOCAB = 100


def _encoder(dtype=torch.float32, quantized=False, seed=0):
    enc = N.MilNceVideoTextEncoder(dtype, quantized, vocab_size=VOCAB)
    tree = N.init_mil_nce_params(seed, vocab_size=VOCAB)
    if quantized:
        tree = dict(tree, video=N.quantize_s3dg_fast(tree["video"], "mixed_4b"))
    enc.load_state_dict(mil_nce_params_from_jax(tree))
    return enc, tree


def _torch_layout(tree, prefix=""):
    """A JAX-layout tree back to a torch state dict (the released checkpoint's
    layout): THWIO kernels to (O, I, kT, kH, kW), dense kernels transposed."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_torch_layout(value, f"{prefix}{key}."))
        elif key == "kernel":
            out[f"{prefix}weight"] = (value.transpose(4, 3, 0, 1, 2) if value.ndim == 5
                                      else value.T)
        elif key == "word_embd":
            out[f"{prefix}word_embd.weight"] = value
        else:
            out[f"{prefix}{key}"] = value
    return out


def test_tokenizer_matches_jax(tmp_path):
    words = np.array(["the", "dog", "runs", "don't", "fast", "über", "a"]
                     + [f"w{i}" for i in range(30)])
    path = tmp_path / "s3d_dict.npy"
    np.save(path, words)
    texts = ["The dog runs FAST!", "don't stop, über-dog", "", "unknown words only",
             " ".join(["a"] * 30), "w1 w2, w3; W4"]
    ref, got = JaxTokenizer.from_npy(str(path)), N.MilNceTokenizer.from_npy(str(path))
    np.testing.assert_array_equal(got(texts), ref(texts))
    assert got(texts).dtype == np.int32 and got(texts).shape == (6, 20)
    assert got.decode(got("the dog")[0]) == ref.decode(ref("the dog")[0]) == "the dog"
    assert N.MilNceTokenizer.from_npy(str(path), max_tokens=4)(texts[4]).shape == (1, 4)


def test_text_tower_matches_jax():
    enc, tree = _encoder()
    ids = np.random.default_rng(0).integers(1, VOCAB, (3, 20)).astype(np.int32)
    ids[0, 5:] = 0
    ref = np.asarray(JaxText(vocab_size=VOCAB).apply({"params": tree["text"]}, jnp.asarray(ids)))
    with torch.no_grad():
        got = enc.encode_text(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (3, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_encoder_video_shapes_dtypes_and_uint8():
    """fp32 (module path) and bf16 (fast path) give (B, 512) in the tower's dtype;
    uint8 becomes video.to(dtype) / 255 in that dtype, as JAX rounds it."""
    video = np.random.default_rng(1).integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8)
    uint8 = torch.from_numpy(video)
    f32, _ = _encoder()
    bf16, _ = _encoder(torch.bfloat16)
    assert not f32.fast and bf16.fast
    with torch.no_grad():
        a = f32.encode_video(uint8)
        b = bf16.encode_video(uint8)
        np.testing.assert_array_equal(a.numpy(), f32.encode_video(uint8.float() / 255.0).numpy())
    assert a.shape == b.shape == (2, 512) and a.dtype == torch.float32
    assert b.dtype == torch.bfloat16
    ref = np.asarray(jnp.asarray(video).astype(jnp.bfloat16) / 255.0, np.float32)
    np.testing.assert_array_equal(bf16._prepare_video(uint8).float().numpy(), ref)
    cos = torch.nn.functional.cosine_similarity(a, b.float(), dim=-1)
    assert float(cos.min()) > 0.999


def test_int8_encoder_calibrates_its_sites():
    video = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 8, 32, 32, 3),
                                                               dtype=np.uint8))
    enc, _ = _encoder(quantized=True)
    assert enc.dtype == torch.bfloat16 and enc.fast
    with pytest.raises(ValueError, match="fast"):
        N.MilNceVideoTextEncoder(quantized=True, fast=False, vocab_size=VOCAB)
    amax = enc.collect_act_amax(video)
    assert sorted(amax) == sorted(f"video/int8/{s}" for s in int8_site_names("mixed_4b"))
    enc.calibrate(video)
    assert float(enc.video.int8["fc"].act_scale) == pytest.approx(
        float(amax["video/int8/fc"].reshape(-1)[0]))
    with torch.no_grad():
        out = enc.encode_video(video)
        ref = _encoder(torch.bfloat16)[0].encode_video(video)
    assert out.shape == (2, 512) and out.dtype == torch.bfloat16
    assert float(torch.nn.functional.cosine_similarity(out.float(), ref.float()).min()) > 0.99


@pytest.mark.parametrize("text_prefix", ["text_module.", ""])
def test_params_from_torch_matches_jax_leaf_for_leaf(text_prefix):
    """A synthetic checkpoint in the released layout (BatchNorm counters
    included): the port's converter gives JAX's tree, leaf for leaf."""
    tree = N.init_mil_nce_params(3, vocab_size=VOCAB)
    video_sd = _torch_layout(tree["video"])
    video_sd.update({k.replace("running_var", "num_batches_tracked"): np.int64(7)
                     for k in list(video_sd) if k.endswith("running_var")})
    text_sd = _torch_layout(tree["text"])
    full = {**video_sd, **{f"{text_prefix}{k}": v for k, v in text_sd.items()}}
    video, text = N.split_mil_nce_state_dict(full)
    got, ref = N.mil_nce_params_from_torch(video, text), jax_from_torch(video, text)

    def leaves(node, prefix=""):
        for key, value in sorted(node.items()):
            if isinstance(value, dict):
                yield from leaves(value, f"{prefix}{key}/")
            else:
                yield f"{prefix}{key}", value

    ref_leaves, got_leaves = dict(leaves(ref)), dict(leaves(got))
    assert list(got_leaves) == list(ref_leaves)
    for name, value in ref_leaves.items():
        assert got_leaves[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got_leaves[name], value, err_msg=name)
    # The converted tree loads into the encoder (counters dropped).
    N.MilNceVideoTextEncoder(vocab_size=VOCAB).load_state_dict(mil_nce_params_from_jax(got))


def test_loader_on_the_cpu_reads_a_checkpoint_and_shares_weights(tmp_path):
    tree = N.init_mil_nce_params(5)
    sd = {**_torch_layout(tree["video"]),
          **{f"text_module.{k}": v for k, v in _torch_layout(tree["text"]).items()}}
    path = tmp_path / "s3d_howto100m.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    float_enc = N.load_mil_nce_encoder(str(path), device="cpu").encoder
    int8_enc = N.load_mil_nce_encoder(str(path), dtype="int8", device="cpu",
                                      int8_from="mixed_5b").encoder
    want = mil_nce_params_from_jax(tree)
    for name, value in float_enc.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0, msg=name)
    assert sorted(n for n, m in int8_enc.named_modules() if hasattr(m, "act_scale")) == sorted(
        f"video.int8.{s.replace('/', '.')}" for s in int8_site_names("mixed_5b"))
    torch.testing.assert_close(int8_enc.text.word_embd, float_enc.text.word_embd)
    with pytest.raises(ValueError, match="dtype"):
        N.load_mil_nce_encoder(dtype="int4", device="cpu")


def test_loader_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    assert inspect.signature(N.load_mil_nce_encoder).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        N.load_mil_nce_encoder()
