"""The port's VideoCLIP encoder (fitclip_torch/models/videoclip.py) against the
JAX package on the CPU: the fusion model's forward_video and forward_text at
BertConfig.tiny_test, fp32 (1e-4) and bf16 (cosine > 0.999 against JAX's bf16,
tests/test_videoclip.py), the whole encoder with 8-frame clips, the checkpoint
converter, the tokenizer's [CLS] [SEP] framing and the loader.

Parameters are the port's seeded numpy tree in the JAX layout (its structure
checked against the Flax init's), loaded into the port with
``videoclip_params_from_jax``; inputs are made with numpy.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models import videoclip as JV
from fitclip_torch.convert.from_jax import videoclip_params_from_jax
from fitclip_torch.models import videoclip as V
from fitclip_torch.models.s3dg import int8_site_names

CFG = V.BertConfig.tiny_test(vocab_size=120)  # holds the [CLS] 101 and [SEP] 102 ids
JAX_CFG = JV.BertConfig.tiny_test(vocab_size=120)
FEATURES = 512


def _cosine(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def _port(tree, dtype=torch.float32, **kwargs):
    enc = V.VideoClipVideoTextEncoder(CFG, dtype, num_frames=16, frames_per_clip=8, **kwargs)
    enc.load_state_dict(videoclip_params_from_jax(tree))
    return enc


@pytest.fixture(scope="module")
def setup():
    tree = V.init_videoclip_params(CFG, seed=0)
    rng = np.random.default_rng(0)
    vfeats = rng.normal(size=(2, 3, FEATURES)).astype(np.float32)
    vmasks = np.array([[1, 1, 1], [1, 1, 0]], np.int32)
    ids = np.zeros((3, 14), np.int32)
    ids[:, 0], ids[:, 1] = 101, 102
    for row, n in enumerate((7, 10, 3)):
        ids[row, 2:2 + n] = rng.integers(1, 100, n)
        ids[row, 2 + n] = 102
    return tree, vfeats, vmasks, ids


def _jax_model(dtype):
    return JV.VideoClipModel(JAX_CFG, dtype=dtype)


def test_seeded_fusion_tree_has_the_flax_structure(setup):
    tree = setup[0]["model"]
    model = _jax_model(jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 512)),
                                               jnp.ones((1, 1), jnp.int32), 101, 102,
                                               method=JV.VideoClipModel.forward_video))["params"]
    text = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                                             jnp.ones((1, 8), jnp.int32),
                                             method=JV.VideoClipModel.forward_text))["params"]
    shapes = {**text, **shapes}
    assert (jax.tree_util.tree_map(lambda a: a.shape, shapes)
            == jax.tree_util.tree_map(lambda a: a.shape, tree))


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_fusion_matches_jax(setup, dtype, jdtype):
    tree, vfeats, vmasks, ids = setup
    model, params = _jax_model(jdtype), {"params": tree["model"]}
    ref_v = np.asarray(model.apply(params, jnp.asarray(vfeats, jdtype), jnp.asarray(vmasks), 101,
                                   102, method=JV.VideoClipModel.forward_video))
    mask = (ids != 0).astype(np.int32)
    ref_t = np.asarray(model.apply(params, jnp.asarray(ids), jnp.asarray(mask),
                                   method=JV.VideoClipModel.forward_text))
    port = _port(tree, dtype).model
    with torch.no_grad():
        got_v = port.forward_video(torch.from_numpy(vfeats).to(dtype), torch.from_numpy(vmasks),
                                   101, 102).numpy()
        got_t = port.forward_text(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert got_v.shape == (2, CFG.hidden_size) and got_t.shape == (3, CFG.hidden_size)
    if dtype == torch.float32:
        np.testing.assert_allclose(got_v, ref_v, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got_t, ref_t, atol=1e-4, rtol=1e-4)
    else:
        assert _cosine(got_v, ref_v) > 0.999 and _cosine(got_t, ref_t) > 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_with_8_frame_clips_matches_jax(setup, dtype, monkeypatch):
    """(1, 16, 32, 32, 3) uint8 -> two 8-frame S3D-G clips -> the video BERT, the
    whole encode_video of both packages (fp32: module path, 1e-4; bf16: the fast
    forward, with JAX's stem kernel in interpret mode, cosine > 0.999)."""
    tree = setup[0]
    video = np.random.default_rng(1).integers(0, 256, (1, 16, 32, 32, 3), dtype=np.uint8)
    jax_enc = JV.VideoClipVideoTextEncoder(JAX_CFG, num_frames=16, frames_per_clip=8,
                                           dtype=dtype)
    if dtype == "bfloat16":  # the encoder's S3D-G through the Pallas stem, as on the TPU
        from fitclip_tpu.models import s3dg_fast

        fast = s3dg_fast.s3dg_fast_apply
        monkeypatch.setattr(s3dg_fast, "s3dg_fast_apply",
                            lambda *a, **k: fast(*a, stem_kernel=True, **k))
    ref = np.asarray(jax.jit(jax_enc.encode_video)(tree, jnp.asarray(video)))
    port = _port(tree, V._DTYPES[dtype])
    with torch.no_grad():
        got = port.encode_video(torch.from_numpy(video)).numpy()
        features = port.clip_features(torch.from_numpy(video))
    assert features.shape == (1, 2, FEATURES) and got.shape == (1, CFG.hidden_size)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    else:
        assert _cosine(got, ref) > 0.999


def _checkpoint(tree, num_video_layers):
    """The fusion tree back to the released checkpoint's names (MMPT layout)."""
    sd = {"video_encoder.bert.embeddings.word_embeddings.weight": tree["video_word_embeddings"],
          "text_encoder.embeddings.word_embeddings.weight": tree["text_word_embeddings"]}
    mlp = tree["videomlp"]
    for name, key in (("linear1", "linear1"), ("linear2", "linear2")):
        sd[f"video_encoder.videomlp.{key}.weight"] = mlp[name]["kernel"].T
        sd[f"video_encoder.videomlp.{key}.bias"] = mlp[name]["bias"]
    sd["video_encoder.videomlp.LayerNorm.weight"] = mlp["layernorm"]["weight"]
    sd["video_encoder.videomlp.LayerNorm.bias"] = mlp["layernorm"]["bias"]
    names = {"attention_query": "attention.self.query", "attention_key": "attention.self.key",
             "attention_value": "attention.self.value",
             "attention_output": "attention.output.dense",
             "attention_layernorm": "attention.output.LayerNorm",
             "intermediate": "intermediate.dense", "output": "output.dense",
             "output_layernorm": "output.LayerNorm"}
    for tower, prefix, layers in (("video_bert", "video_encoder.bert", num_video_layers),
                                  ("text_bert", "text_encoder", CFG.num_layers)):
        node = tree[tower]
        sd[f"{prefix}.embeddings.position_embeddings.weight"] = node["position_embeddings"]
        sd[f"{prefix}.embeddings.token_type_embeddings.weight"] = node["token_type_embeddings"]
        sd[f"{prefix}.embeddings.LayerNorm.weight"] = node["embeddings_layernorm"]["weight"]
        sd[f"{prefix}.embeddings.LayerNorm.bias"] = node["embeddings_layernorm"]["bias"]
        for i in range(layers):
            for name, path in names.items():
                leaf = node[f"layer_{i}"][name]
                base = f"{prefix}.encoder.layer.{i}.{path}"
                if "kernel" in leaf:
                    sd[f"{base}.weight"], sd[f"{base}.bias"] = leaf["kernel"].T, leaf["bias"]
                else:
                    sd[f"{base}.weight"], sd[f"{base}.bias"] = leaf["weight"], leaf["bias"]
    return sd


def _s3dg_checkpoint(tree, prefix=""):
    """An S3D-G tree back to torch names and layouts: (O, I, kT, kH, kW) convs,
    (out, in) denses."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_s3dg_checkpoint(value, f"{prefix}{key}."))
        elif key == "kernel":
            out[f"{prefix}weight"] = value.transpose(4, 3, 0, 1, 2) if value.ndim == 5 else value.T
        else:
            out[f"{prefix}{key}"] = value
    return out


def test_params_from_torch_matches_jax_leaf_for_leaf(setup):
    tree = setup[0]["model"]
    sd = _checkpoint(tree, 6)
    got = V.videoclip_params_from_torch(sd, CFG)
    ref = JV.videoclip_params_from_torch(sd, JAX_CFG)
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in got_leaves] == [p for p, _ in ref_leaves]
    for (path, g), (_, r) in zip(got_leaves, ref_leaves):
        np.testing.assert_array_equal(g, r, err_msg=str(path))
    for (path, g), (_, r) in zip(got_leaves, jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(g, r, err_msg=str(path))


def test_tokenizer_prefix_sep_framing(tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "dog", "runs", "##s",
                                "fast", "the", "."]) + "\n")
    texts = ["The dog runs fast.", "dogs", "a " * 40]
    got = V.VideoClipVideoTextEncoder(CFG, max_tokens=8, vocab_path=str(vocab)).get_tokenizer()
    ref = JV.VideoClipVideoTextEncoder(JAX_CFG, max_tokens=8,
                                       vocab_path=str(vocab)).get_tokenizer()
    np.testing.assert_array_equal(got(texts), ref(texts))
    np.testing.assert_array_equal(got(texts)[0], [2, 3, 9, 5, 6, 8, 10, 3])  # [CLS] [SEP] ... [SEP]
    assert got.inner.decode(got(texts)[1]) == "dogs"


def test_int8_encoder_calibrates_the_s3dg_sites():
    tree = V.init_videoclip_params(CFG, seed=1)
    tree = dict(tree, s3dg=V.quantize_s3dg_fast(tree["s3dg"], "mixed_4b"))
    enc = _port(tree, quantized=True)
    assert enc.dtype == torch.bfloat16 and enc.fast
    video = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 8, 32, 32, 3),
                                                               dtype=np.uint8))
    amax = enc.calibrate(video).collect_act_amax(video)
    assert sorted(amax) == sorted(f"s3dg/int8/{s}" for s in int8_site_names("mixed_4b"))
    with torch.no_grad():
        out = enc.encode_video(video)
    assert out.shape == (1, CFG.hidden_size) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())


def test_loader_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    assert inspect.signature(V.load_videoclip_encoder).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.load_videoclip_encoder()


def test_loader_on_the_cpu_reads_both_checkpoints(tmp_path):
    tree = V.init_videoclip_params(CFG, seed=3)
    model_path, s3dg_path = tmp_path / "checkpoint_best.pt", tmp_path / "s3d_howto100m.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in _checkpoint(tree["model"], 6).items()}, model_path)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _s3dg_checkpoint(
        tree["s3dg"]).items()}, s3dg_path)
    enc = V.load_videoclip_encoder(str(model_path), str(s3dg_path), device="cpu",
                                   config=CFG).encoder
    want = videoclip_params_from_jax(tree)
    for name, value in enc.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0, msg=name)
