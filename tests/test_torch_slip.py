"""fitclip_torch's SLIP (``models/slip.py``, ``models/slip_fast.py``) against
the JAX package's, on the same numpy parameters carried by
``convert/from_jax.slip_params_from_jax``.

The module path and the fast path (K2 for float, K1 with the exact-GELU
epilogue for int8, their plain versions here) are held against the JAX
SlipModel and ``slip_fast`` (Pallas interpret mode, jitted): float at
atol/rtol 2e-4, int8 at 2e-3 (tests/test_slip_fast.py's bounds), calibration
at rtol 1e-5, layer by layer on JAX's inputs. The config is SLIP's at narrow
widths with the real head_dim 64.
"""

import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models import slip as jax_slip
from fitclip_tpu.models import slip_fast as jax_slip_fast
from fitclip_tpu.models.clip import model as jax_clip_model
from fitclip_tpu.models.clip.model import TextConfig as JaxText
from fitclip_tpu.ops import quant as jax_quant
from fitclip_torch.convert.from_jax import slip_params_from_jax, slip_params_to_jax
from fitclip_torch.models import slip, slip_fast
from fitclip_torch.models.clip.model import TextConfig
from fitclip_torch.ops import attention as A
from fitclip_torch.ops import block as K
from fitclip_torch.ops import quant

FLOAT_TOL = dict(atol=2e-4, rtol=2e-4)
INT8_TOL = dict(atol=2e-3, rtol=2e-3)
NARROW = dict(embed_dim=32, vision_width=128, vision_layers=2, vision_heads=2, image_size=32,
              patch_size=16)
NARROW_TEXT = dict(context_length=16, vocab_size=64, width=128, layers=2, heads=2)


def _jax_config():
    return jax_slip.SlipConfig(**NARROW, text=JaxText(**NARROW_TEXT))


def _config():
    return slip.SlipConfig(**NARROW, text=TextConfig(**NARROW_TEXT))


@pytest.fixture(scope="module")
def setup():
    """The JAX float tree, a calibrated int8 tree (scales from the port), inputs."""
    jax_cfg, cfg = _jax_config(), _config()
    params = jax_slip.SlipModel(jax_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 16), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(9)
    # Non-trivial CLS token, LayerNorm and bias leaves.
    params["visual"]["cls_token"] = (0.02 * rng.normal(size=128)).astype(np.float32)
    for tower in (params["visual"]["blocks"]["blocks"], params["transformer"]["blocks"]):
        for name in ("mlp_fc", "mlp_proj"):
            tower[name]["bias"] = (0.1 * rng.normal(size=tower[name]["bias"].shape)).astype(
                np.float32)
        tower["ln_2"]["ln"]["scale"] = (1 + 0.1 * rng.normal(
            size=tower["ln_2"]["ln"]["scale"].shape)).astype(np.float32)
    video = rng.integers(0, 256, size=(2, 2, 32, 32, 3), dtype=np.uint8)
    calib_ids = rng.integers(1, 60, size=(4, 16)).astype(np.int32)
    enc = slip.SlipVideoTextEncoder(cfg, num_frames=2, quantized=True)
    enc.model.load_state_dict(slip_params_from_jax(jax_quant.quantize_clip_params(params), cfg))
    enc.calibrate(torch.from_numpy(video), torch.from_numpy(calib_ids).long())
    qparams = slip_params_to_jax(enc.model.state_dict(), cfg)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 60, size=(3, 16)).astype(np.int32)
    return dict(jax_cfg=jax_cfg, cfg=cfg, params=params, qparams=qparams, video=video,
                calib_ids=calib_ids, images=images, ids=ids)


def _model(cfg, tree, **kwargs):
    model = slip.SlipModel(cfg, **kwargs)
    model.load_state_dict(slip_params_from_jax(tree, cfg))
    return model


def _jax_module(jax_cfg, tree, images, ids, **kwargs):
    model = jax_slip.SlipModel(jax_cfg, **kwargs)
    image = jax.jit(functools.partial(model.apply, method=jax_slip.SlipModel.encode_image))
    text = jax.jit(functools.partial(model.apply, method=jax_slip.SlipModel.encode_text))
    return (np.asarray(image({"params": tree}, images), np.float32),
            np.asarray(text({"params": tree}, ids), np.float32))


def _jax_fast(jax_cfg, tree, images, ids):
    image = jax.jit(functools.partial(jax_slip_fast.encode_frames_fast, config=jax_cfg,
                                      dtype=jnp.float32))
    text = jax.jit(functools.partial(jax_slip_fast.encode_text_fast, config=jax_cfg,
                                     dtype=jnp.float32))
    return np.asarray(image(tree, images)), np.asarray(text(tree, ids))


def _torch_module(model, images, ids):
    with torch.no_grad():
        return (model.encode_image(torch.from_numpy(images)).numpy(),
                model.encode_text(torch.from_numpy(ids).long()).numpy())


def _torch_fast(model, images, ids):
    return (slip_fast.encode_frames_fast(model, torch.from_numpy(images)).numpy(),
            slip_fast.encode_text_fast(model, torch.from_numpy(ids).long()).numpy())


def _assert_close(got, want, tol):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


def test_float_module_path_matches_jax(setup):
    s = setup
    want = _jax_module(s["jax_cfg"], s["params"], s["images"], s["ids"])
    _assert_close(_torch_module(_model(s["cfg"], s["params"]), s["images"], s["ids"]), want,
                  FLOAT_TOL)


def test_float_fast_path_matches_jax(setup):
    """The vision tower's K2 layers with exact GELU and eps 1e-6, text's with
    QuickGELU, causal, eps 1e-5."""
    s = setup
    want = _jax_fast(s["jax_cfg"], s["params"], s["images"], s["ids"])
    _assert_close(_torch_fast(_model(s["cfg"], s["params"]), s["images"], s["ids"]), want,
                  FLOAT_TOL)


def test_int8_fast_path_matches_jax(setup):
    s = setup
    want = _jax_fast(s["jax_cfg"], s["qparams"], s["images"], s["ids"])
    model = _model(s["cfg"], s["qparams"], quantized=True)
    _assert_close(_torch_fast(model, s["images"], s["ids"]), want, INT8_TOL)


def test_int8_module_path_with_fused_attention_matches_jax(setup):
    """K8 in every block of both towers."""
    s = setup
    want = _jax_module(s["jax_cfg"], s["qparams"], s["images"], s["ids"], quantized=True,
                       fused_attention=True)
    model = _model(s["cfg"], s["qparams"], quantized=True, fused_attention=True)
    _assert_close(_torch_module(model, s["images"], s["ids"]), want, INT8_TOL)


def _jax_inputs(jax_cfg, qtree, frames, ids):
    """JAX's calibration forward (both towers in dynamic-quant mode) with the
    input of each layer and of each int8 site sown as it is called:
    {(tower, "layer" or site path within the layer): (layers, ...) array}."""
    def sow_input(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and isinstance(
                context.module, (jax_clip_model.ResidualBlock, jax_clip_model.QuantDense)):
            context.module.sow("intermediates", "input", args[0])
        return next_fun(*args, **kwargs)

    def flat(node, prefix=""):
        for key, child in node.items():
            if key == "input":
                yield prefix[:-1] or "layer", np.asarray(child[0])
            elif isinstance(child, dict):
                yield from flat(child, f"{prefix}{key}/")

    model = jax_slip.SlipModel(jax_cfg, quantized="dynamic")
    inputs = {}
    with flax_nn.intercept_methods(sow_input):
        for tower, method, x in (("visual", jax_slip.SlipModel.encode_image, frames),
                                 ("transformer", jax_slip.SlipModel.encode_text, ids)):
            _, state = model.apply({"params": qtree}, x, method=method, mutable=["intermediates"])
            node = state["intermediates"][tower]["blocks"]
            node = node["blocks"] if tower == "visual" else node
            inputs.update({(tower, path): value for path, value in flat(node)})
    return inputs


def _port_calibrate_teacher_forced(enc, video, ids, jax_inputs):
    """The port's own calibration (``enc.calibrate``: both towers in
    dynamic-quant mode, then the observed abs-maxes written into act_scale),
    teacher-forced: each layer and each int8 site computes its input from
    JAX's values where the previous one took them, records it, and goes on
    with JAX's input in its place. Returns {(tower, path): [the input each
    layer computed]}."""
    computed, hooks = {}, []

    def substitute(key, layer):
        def hook(module, args):
            computed.setdefault(key, []).append(args[0].detach().clone())
            return (torch.from_numpy(np.array(jax_inputs[key][layer])),)
        return hook

    for tower, layers in (("visual", enc.model.visual.blocks.blocks),
                          ("transformer", enc.model.transformer.blocks)):
        for i, layer in enumerate(layers):
            hooks.append(layer.register_forward_pre_hook(substitute((tower, "layer"), i)))
            for path, (site,) in quant.act_scale_sites(layer).items():
                hooks.append(site.register_forward_pre_hook(substitute((tower, path), i)))
    try:
        enc.calibrate(video, ids)
    finally:
        for hook in hooks:
            hook.remove()
    return computed


def test_calibration_matches_jax(setup):
    """The whole calibration of each package covers the same 8 sites (both
    towers' in_proj, out_proj, mlp_fc and mlp_proj, a scale per layer), all
    calibrated. The port's calibration is then held to JAX's at rtol 1e-5
    where it is defined alike on every host: ``enc.calibrate`` runs
    teacher-forced, each layer and each site on JAX's input, and every
    act_scale it writes (the two towers merged, layer by layer) is held to
    JAX's calibrated act_scale. Each input the port computed from JAX's input
    where the previous one took it (no int8 rounding in between) is held to
    JAX's within 1e-5 of its largest. (Across whole towers, fp32 sums in
    another order can move an input of a dynamic quantization across a
    rounding boundary, and that one-step flip moves every abs-max downstream:
    tests/test_torch_s3dg.py shows one.)"""
    s = setup
    cfg, jax_cfg = s["cfg"], s["jax_cfg"]
    qtree = jax_quant.quantize_clip_params(s["params"])
    jax_enc = jax_slip.SlipVideoTextEncoder(jax_cfg, num_frames=2, quantized=True)
    ids = jnp.asarray(s["calib_ids"])
    ref = jax_enc.calibrate(qtree, jnp.asarray(s["video"]), ids)
    want = {path: np.asarray(node["act_scale"]) for path, node in jax_quant._act_scale_items(ref)}
    calibrated = _model(cfg, s["qparams"], quantized=True)
    whole = {site: np.stack([m.act_scale.numpy() for m in modules])
             for site, modules in quant.act_scale_sites(calibrated).items()}
    assert sorted(whole) == sorted(want) and len(want) == 8
    for site in want:
        assert whole[site].size == want[site].size == 2
        assert not np.all(want[site] == 1.0) and not np.all(whole[site] == 1.0)

    jax_inputs = _jax_inputs(jax_cfg, qtree, jax_enc._prepare_frames(jnp.asarray(s["video"])),
                             ids)
    enc = slip.SlipVideoTextEncoder(cfg, num_frames=2, quantized=True)
    enc.model.load_state_dict(slip_params_from_jax(qtree, cfg))
    computed = _port_calibrate_teacher_forced(enc, torch.from_numpy(s["video"]),
                                              torch.from_numpy(s["calib_ids"]).long(),
                                              jax_inputs)
    got = {site: np.stack([m.act_scale.numpy() for m in modules])
           for site, modules in quant.act_scale_sites(enc.model).items()}
    assert sorted(got) == sorted(want)
    for site in want:
        np.testing.assert_allclose(got[site].reshape(want[site].shape), want[site], rtol=1e-5,
                                   err_msg=site)

    assert sorted(computed) == sorted(jax_inputs) and len(computed) == 10
    for (tower, path), per_layer in computed.items():
        assert len(per_layer) == 2
        for layer, x in enumerate(per_layer):
            ref_x = jax_inputs[tower, path][layer]
            np.testing.assert_allclose(x.numpy(), ref_x, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(ref_x).max()),
                                       err_msg=f"{tower} layer {layer} {path}")
            if path == "layer":
                continue
            amax = want[f"{tower}/blocks/blocks/{path}" if tower == "visual"
                        else f"{tower}/blocks/{path}"].reshape(-1)[layer]
            assert float(np.abs(ref_x).max()) == amax, (tower, path, layer)
            assert float(x.abs().max()) == pytest.approx(amax, rel=1e-5), (tower, path, layer)


@pytest.mark.parametrize("fused_block", [False, True])
def test_encoder_on_uint8_clips_matches_jax(setup, fused_block):
    """ImageNet normalization on the device, frame-mean of L2-normalized
    embeddings; float encoder, module path or K2's fast path."""
    s = setup
    jax_enc = jax_slip.SlipVideoTextEncoder(s["jax_cfg"], num_frames=2, fused_block=fused_block)
    want_video = jax.jit(jax_enc.encode_video)(s["params"], jnp.asarray(s["video"]))
    want_text = jax.jit(jax_enc.encode_text)(s["params"], jnp.asarray(s["ids"]))
    enc = slip.SlipVideoTextEncoder(s["cfg"], num_frames=2, fused_block=fused_block)
    enc.model.load_state_dict(slip_params_from_jax(s["params"], s["cfg"]))
    launches = [fn.launches for fn in (K.ln_cast, K.bf16_gemm_gelu, A.attention_block)]
    with torch.no_grad():
        video = enc.encode_video(torch.from_numpy(s["video"]))
        text = enc.encode_text(torch.from_numpy(s["ids"]).long())
    assert launches == [fn.launches for fn in (K.ln_cast, K.bf16_gemm_gelu, A.attention_block)]
    np.testing.assert_allclose(video.numpy(), np.asarray(want_video), **FLOAT_TOL)
    np.testing.assert_allclose(text.numpy(), np.asarray(want_text), **FLOAT_TOL)


def _timm_state_dict(cfg, rng):
    """A synthetic SLIP checkpoint: timm ViT + OpenAI text tower names and layouts."""
    vw, tw, p = cfg.vision_width, cfg.text.width, cfg.patch_size
    g = cfg.image_size // p
    shapes = {"visual.patch_embed.proj.weight": (vw, 3, p, p), "visual.patch_embed.proj.bias": (vw,),
              "visual.cls_token": (1, 1, vw), "visual.pos_embed": (1, g * g + 1, vw),
              "visual.norm.weight": (vw,), "visual.norm.bias": (vw,),
              "ln_final.weight": (tw,), "ln_final.bias": (tw,),
              "token_embedding.weight": (cfg.text.vocab_size, tw),
              "positional_embedding": (cfg.text.context_length, tw),
              "image_projection": (vw, cfg.embed_dim), "text_projection": (tw, cfg.embed_dim),
              "image_mlp.layer1.weight": (8, vw)}  # an SSL head, dropped
    for i in range(cfg.vision_layers):
        b = f"visual.blocks.{i}."
        shapes.update({b + "attn.qkv.weight": (3 * vw, vw), b + "attn.qkv.bias": (3 * vw,),
                       b + "attn.proj.weight": (vw, vw), b + "attn.proj.bias": (vw,),
                       b + "norm1.weight": (vw,), b + "norm1.bias": (vw,),
                       b + "norm2.weight": (vw,), b + "norm2.bias": (vw,),
                       b + "mlp.fc1.weight": (4 * vw, vw), b + "mlp.fc1.bias": (4 * vw,),
                       b + "mlp.fc2.weight": (vw, 4 * vw), b + "mlp.fc2.bias": (vw,)})
    for i in range(cfg.text.layers):
        b = f"transformer.resblocks.{i}."
        shapes.update({b + "attn.in_proj_weight": (3 * tw, tw), b + "attn.in_proj_bias": (3 * tw,),
                       b + "attn.out_proj.weight": (tw, tw), b + "attn.out_proj.bias": (tw,),
                       b + "ln_1.weight": (tw,), b + "ln_1.bias": (tw,),
                       b + "ln_2.weight": (tw,), b + "ln_2.bias": (tw,),
                       b + "mlp.c_fc.weight": (4 * tw, tw), b + "mlp.c_fc.bias": (4 * tw,),
                       b + "mlp.c_proj.weight": (tw, 4 * tw), b + "mlp.c_proj.bias": (tw,)})
    return {k: rng.normal(size=v).astype(np.float32) for k, v in shapes.items()}


def test_slip_params_from_torch_matches_jax():
    cfg, jax_cfg = _config(), _jax_config()
    sd = _timm_state_dict(cfg, np.random.default_rng(7))
    got = slip.slip_params_from_torch(sd, cfg)
    want = slip_params_from_jax(jax_slip.slip_params_from_torch(sd, jax_cfg), cfg)
    assert sorted(got) == sorted(want)
    assert sorted(got) == sorted(slip.SlipModel(cfg).state_dict())
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0)


def test_checkpoint_round_trip_through_load_slip_encoder(tmp_path):
    """A checkpoint ({"state_dict": {"module." ...}}) loads into the CPU encoder
    with the same weights as slip_params_from_torch gives."""
    cfg = slip.SlipConfig.vit_s16()
    sd = _timm_state_dict(cfg, np.random.default_rng(8))
    path = tmp_path / "slip.pt"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    loaded = slip.load_slip_encoder(str(path), model="SLIP_VITS16", device="cpu")
    state = loaded.encoder.model.state_dict()
    for key, value in slip.slip_params_from_torch(sd, cfg).items():
        torch.testing.assert_close(state[key], value, atol=0, rtol=0)


def test_load_slip_encoder_needs_a_card_by_default():
    if torch.cuda.is_available():
        assert slip.load_slip_encoder(model="SLIP_VITS16").encoder.model.dtype == torch.float32
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slip.load_slip_encoder(model="SLIP_VITS16")


def test_load_slip_encoder_cpu_defaults_and_errors():
    enc = slip.load_slip_encoder(model="SLIP_VITS16", dtype="int8", device="cpu").encoder
    assert enc.quantized and enc.dtype == torch.bfloat16
    assert not enc.fused_attention and not enc.fused_block  # the CPU takes the plain path
    assert enc.model.visual.blocks.blocks[0].mlp_fc.weight_q.dtype == torch.int8
    assert enc.model.visual.blocks.blocks[0].ln_eps == 1e-6
    assert not enc.model.visual.blocks.blocks[0].quick_gelu
    assert enc.model.transformer.blocks[0].quick_gelu and enc.model.transformer.blocks[0].causal
    with pytest.raises(ValueError, match="dtype"):
        slip.load_slip_encoder(dtype="int4", device="cpu")
    with pytest.raises(ValueError, match="SLIP model"):
        slip.load_slip_encoder(model="SLIP_VITH14", device="cpu")


def test_encoder_is_evaluation_only(monkeypatch):
    monkeypatch.delenv("FITCLIP_BPE_PATH", raising=False)
    enc = slip.SlipVideoTextEncoder(slip.SlipConfig.tiny_test())
    assert not enc.trainable
    with pytest.raises(NotImplementedError, match="evaluation-only"):
        enc.train_frame_sampler(8)
    with pytest.raises(FileNotFoundError, match="BPE"):  # CLIP's BPE needs its merges file
        enc.get_tokenizer()
    with pytest.raises(ValueError, match="quantized"):
        enc.calibrate(torch.zeros(1, 1, 32, 32, 3, dtype=torch.uint8))
