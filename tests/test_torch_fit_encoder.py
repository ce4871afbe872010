"""The port's Frozen-in-Time encoder against the JAX package on the CPU: the
towers, the bf16 fused-attention path (plain K5/K6), the int8 slice through
fit_fast (plain K4), calibration, the checkpoint converter and the loader.

Parameters come from the JAX init of FrozenInTimeConfig.tiny_test and are
carried over with fit_params_from_jax; inputs are made with numpy. Bounds are
the reference's own: fp32 towers atol = rtol = 1e-4 and text embeddings 1e-5
(tests/test_frozen_in_time.py), bf16 against JAX bf16 2e-2 and against fp32
cosine > 0.999, the int8 slice cosine > 0.9995 against the JAX fast path and
> 0.99 against fp32 (tests/test_fit_fast.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.frozen_in_time.encoder import FrozenInTimeConfig as JaxConfig
from fitclip_tpu.models.frozen_in_time.encoder import FrozenInTimeVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.frozen_in_time.encoder import frozen_in_time_params_from_torch as jax_ckpt
from fitclip_tpu.models.frozen_in_time.encoder import quantize_fit_video_params
from fitclip_tpu.ops.quant import apply_act_scales
from fitclip_torch.convert.from_jax import fit_params_from_jax
from fitclip_torch.models.clip.load import load_clip_encoder
from fitclip_torch.models.frozen_in_time import encoder as E
from fitclip_torch.models.frozen_in_time.load import init_fit_params, load_frozen_in_time_encoder
from fitclip_torch.ops.quant import FIT_DENSE_NAMES, act_scale_sites, quantize_clip_params

CFG = E.FrozenInTimeConfig.tiny_test()
JAX_CFG = JaxConfig.tiny_test()
FRAMES = CFG.num_frames


def _cosine(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def _np(t):
    return t.detach().float().numpy()


def _port(params, **kwargs):
    enc = E.FrozenInTimeVideoTextEncoder(CFG, num_frames=FRAMES, **kwargs)
    enc.load_state_dict(fit_params_from_jax(params, CFG))
    return enc


@pytest.fixture(scope="module")
def setup():
    fp32 = JaxEncoder(JAX_CFG, num_frames=FRAMES, fused_attention=False)
    params = jax.tree_util.tree_map(np.asarray, fp32.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    video = rng.integers(0, 256, (3, FRAMES, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 90, (3, 10)).astype(np.int32)
    ids[0, 6:] = 0  # [PAD]
    return fp32, params, video, ids


def test_video_tower_fp32_matches_jax(setup):
    fp32, params, video, _ = setup
    enc = _port(params)
    v = jnp.asarray(video)
    ref = fp32.video_model.apply({"params": params["video"]}, fp32._prepare_video(v))
    with torch.no_grad():
        got = enc.video(enc._prepare_video(torch.from_numpy(video)))
        emb = enc.encode_video(torch.from_numpy(video))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(emb), np.asarray(fp32.encode_video(params, v)),
                               atol=1e-4, rtol=1e-4)


def test_distilbert_fp32_matches_jax(setup):
    fp32, params, _, ids = setup
    enc = _port(params)
    mask = (ids != 0).astype(np.int32)
    ref = fp32.text_model.apply({"params": params["text"]}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = enc.text(torch.from_numpy(ids).long(), torch.from_numpy(mask) > 0)
    valid = mask.astype(bool)
    np.testing.assert_allclose(_np(got)[valid], np.asarray(ref)[valid], atol=1e-4, rtol=1e-4)


def test_encode_text_fp32_matches_jax(setup):
    fp32, params, _, ids = setup
    with torch.no_grad():
        got = _port(params).encode_text(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(got), np.asarray(fp32.encode_text(params, jnp.asarray(ids))),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(_np(got), axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_matches_jax_bf16_and_stays_close_to_fp32(setup, fused):
    fp32, params, video, ids = setup
    jax_bf16 = JaxEncoder(JAX_CFG, num_frames=FRAMES, dtype="bfloat16", fused_attention=fused)
    enc = _port(params, dtype=torch.bfloat16, fused_attention=fused)
    with torch.no_grad():
        got_v = _np(enc.encode_video(torch.from_numpy(video)))
        got_t = _np(enc.encode_text(torch.from_numpy(ids).long()))
    ref_v = np.asarray(jax_bf16.encode_video(params, jnp.asarray(video)), np.float32)
    ref_t = np.asarray(jax_bf16.encode_text(params, jnp.asarray(ids)), np.float32)
    np.testing.assert_allclose(got_v, ref_v, atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got_t, ref_t, atol=2e-2, rtol=2e-2)
    assert _cosine(got_v, fp32.encode_video(params, jnp.asarray(video))) > 0.999
    assert _cosine(got_t, fp32.encode_text(params, jnp.asarray(ids))) > 0.999


@pytest.fixture(scope="module")
def calibrated(setup):
    """The int8 tree calibrated by JAX (dynamic quant, einsum attention) and
    the JAX fast-path encoder."""
    _, params, video, _ = setup
    fast = JaxEncoder(JAX_CFG, num_frames=FRAMES, dtype="int8", fused_attention=False,
                      fused_block=True)
    qparams = dict(params, video=quantize_fit_video_params(params["video"]))
    return apply_act_scales(qparams, fast.collect_act_amax(qparams, jnp.asarray(video))), fast


@pytest.mark.parametrize("frames", [FRAMES, 1])
def test_int8_slice_matches_the_jax_fast_path(setup, calibrated, frames):
    fp32, params, video, _ = setup
    qparams, fast = calibrated
    clip = video[:, :frames]
    enc = _port(qparams, dtype=torch.bfloat16, quantized=True, fused_block=True)
    with torch.no_grad():
        got = _np(enc.encode_video(torch.from_numpy(clip)))
    assert got.shape == (3, CFG.projection_dim)
    assert _cosine(got, fast.encode_video(qparams, jnp.asarray(clip))) > 0.9995
    assert _cosine(got, fp32.encode_video(params, jnp.asarray(clip))) > 0.99


def test_calibration_matches_jax_site_by_site(setup):
    """Both packages observe the video tower's dense inputs in dynamic-quant
    mode with the einsum attention (fp32 compute here)."""
    _, params, video, _ = setup
    qparams = dict(params, video=quantize_fit_video_params(params["video"]))
    jax_enc = JaxEncoder(JAX_CFG, num_frames=FRAMES, dtype="int8", fused_attention=True)
    jax_enc.dtype = jnp.float32
    want = jax_enc.collect_act_amax(qparams, jnp.asarray(video))["video"]
    enc = _port(qparams, quantized=True, fused_attention=True)
    got = enc.collect_act_amax(torch.from_numpy(video))
    assert sorted(got) == sorted(f"video/blocks/{p}" for p in (
        "attn/qkv", "attn/proj", "timeattn/qkv", "timeattn/proj", "mlp_fc1", "mlp_fc2"))
    for site, amax in got.items():
        path = site.split("/")[2:]
        ref = []
        for i in range(CFG.depth):
            node = want[f"blocks_{i}"]
            for key in path:
                node = node[key]
            ref.append(np.asarray(node["act_amax"][0]))
        np.testing.assert_allclose(amax, np.stack(ref), rtol=1e-5)
    assert all(m.fused for m in enc.video.modules() if isinstance(m, E.VarAttention))
    enc.calibrate(torch.from_numpy(video))
    for site, modules in act_scale_sites(enc).items():
        np.testing.assert_allclose(np.concatenate([m.act_scale.numpy() for m in modules]),
                                   got[site].ravel())


def _synthetic_checkpoint(seed=1, frames=3):
    """A FrozenInTime state dict of the tiny config's shapes, with a temporal
    embedding of ``frames`` frames."""
    rng = np.random.default_rng(seed)
    d, t, p = CFG.embed_dim, CFG.text, CFG.patch_size
    shapes = {"video_model.patch_embed.proj.weight": (d, 3, p, p),
              "video_model.patch_embed.proj.bias": (d,), "video_model.cls_token": (1, 1, d),
              "video_model.pos_embed": (1, 5, d), "video_model.temporal_embed": (1, frames, d),
              "video_model.norm.weight": (d,), "video_model.norm.bias": (d,),
              "vid_proj.0.weight": (CFG.projection_dim, d),
              "vid_proj.0.bias": (CFG.projection_dim,),
              "txt_proj.1.weight": (CFG.projection_dim, t.dim),
              "txt_proj.1.bias": (CFG.projection_dim,),
              "text_model.embeddings.word_embeddings.weight": (t.vocab_size, t.dim),
              "text_model.embeddings.position_embeddings.weight": (t.max_position_embeddings,
                                                                  t.dim),
              "text_model.embeddings.LayerNorm.weight": (t.dim,),
              "text_model.embeddings.LayerNorm.bias": (t.dim,)}
    for i in range(CFG.depth):
        b = f"video_model.blocks.{i}"
        for n in ("norm1", "norm2", "norm3"):
            shapes.update({f"{b}.{n}.weight": (d,), f"{b}.{n}.bias": (d,)})
        for a in ("attn", "timeattn"):
            shapes.update({f"{b}.{a}.qkv.weight": (3 * d, d), f"{b}.{a}.qkv.bias": (3 * d,),
                           f"{b}.{a}.proj.weight": (d, d), f"{b}.{a}.proj.bias": (d,)})
        shapes.update({f"{b}.mlp.fc1.weight": (4 * d, d), f"{b}.mlp.fc1.bias": (4 * d,),
                       f"{b}.mlp.fc2.weight": (d, 4 * d), f"{b}.mlp.fc2.bias": (d,)})
    for i in range(t.n_layers):
        b = f"text_model.transformer.layer.{i}"
        for n in ("q_lin", "k_lin", "v_lin", "out_lin"):
            shapes.update({f"{b}.attention.{n}.weight": (t.dim, t.dim),
                           f"{b}.attention.{n}.bias": (t.dim,)})
        for n in ("sa_layer_norm", "output_layer_norm"):
            shapes.update({f"{b}.{n}.weight": (t.dim,), f"{b}.{n}.bias": (t.dim,)})
        shapes.update({f"{b}.ffn.lin1.weight": (t.hidden_dim, t.dim),
                       f"{b}.ffn.lin1.bias": (t.hidden_dim,),
                       f"{b}.ffn.lin2.weight": (t.dim, t.hidden_dim),
                       f"{b}.ffn.lin2.bias": (t.dim,)})
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), np.asarray(tree)


@pytest.mark.parametrize("inflation", ["zeros", "interp"])
def test_checkpoint_converter_matches_jax_leaf_for_leaf(inflation):
    sd = _synthetic_checkpoint(frames=1)
    got = dict(_leaves(E.frozen_in_time_params_from_torch(sd, CFG, inflation)))
    want = dict(_leaves(jax_ckpt(sd, JAX_CFG, inflation)))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_inflate_temporal_embed_both_modes():
    embed = np.arange(8, dtype=np.float32).reshape(4, 2)
    zeros = E.inflate_temporal_embed(embed, 6, "zeros")
    assert zeros.shape == (6, 2) and zeros[4:].sum() == 0
    np.testing.assert_array_equal(zeros[:4], embed)
    interp = E.inflate_temporal_embed(embed, 7, "interp")
    assert interp.shape == (7, 2)
    np.testing.assert_allclose(interp[0], embed[0])
    np.testing.assert_allclose(interp[-1], embed[-1])
    np.testing.assert_allclose(interp[1], embed[0] + 0.5 * (embed[1] - embed[0]))
    assert E.inflate_temporal_embed(embed, 2).shape == (2, 2)
    with pytest.raises(ValueError, match="mode"):
        E.inflate_temporal_embed(embed, 6, "nearest")


@pytest.mark.parametrize("loader", [load_clip_encoder, load_frozen_in_time_encoder])
def test_loaders_default_to_cuda_and_refuse_without_it(loader, monkeypatch):
    import inspect

    assert inspect.signature(loader).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader()


def test_loader_on_the_cpu_shares_weights_and_reads_a_checkpoint(tmp_path, monkeypatch):
    """Seeded float and int8 encoders share weights; a checkpoint (DataParallel
    prefix, 1 temporal frame inflated to 4) loads through the converter."""
    import fitclip_torch.models.frozen_in_time.load as L

    monkeypatch.setattr(L, "FrozenInTimeConfig",
                        lambda num_frames: E.FrozenInTimeConfig.tiny_test())
    float_enc = L.load_frozen_in_time_encoder(device="cpu", seed=3).encoder
    int8_enc = L.load_frozen_in_time_encoder(dtype="int8", device="cpu", seed=3).encoder
    assert not float_enc.fused_attention and not int8_enc.fused_block and int8_enc.quantized
    tree = init_fit_params(CFG, 3)
    qtree = quantize_clip_params(tree["video"], FIT_DENSE_NAMES)
    np.testing.assert_array_equal(int8_enc.video.blocks[1].attn.qkv.weight_q.numpy(),
                                  qtree["blocks_1"]["attn"]["qkv"]["kernel_q"].T)
    np.testing.assert_array_equal(float_enc.text.word_embeddings.detach().numpy(),
                                  int8_enc.text.word_embeddings.detach().numpy())
    with pytest.raises(ValueError, match="dtype"):
        L.load_frozen_in_time_encoder(dtype="int4", device="cpu")

    sd = _synthetic_checkpoint(frames=1)
    path = tmp_path / "fit.pth"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}},
               path)
    enc = L.load_frozen_in_time_encoder(str(path), device="cpu").encoder
    want = fit_params_from_jax(E.frozen_in_time_params_from_torch(sd, CFG), CFG)
    for name, value in enc.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=0, atol=0, msg=name)
