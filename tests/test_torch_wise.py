"""WiSE-FT (fitclip_torch/models/wise.py, models/clip/load.py:wise_encoder) and
the OpenAI-schema exporter (convert/openai_state_dict.py,
convert/checkpoint_to_state_dict.py) against the JAX package on the CPU:

- wise_params bit-equal to JAX's over the same ViT and ResNet weights (the
  running statistics merge as the other leaves); a structure mismatch raises
  in both, and the port names the key or the shape;
- two int8-loaded encoders: JAX merges kernel_q into fractional floats (no
  int8 weight is left); the port refuses them before merging;
- wise_encoder embeds as JAX's at 2e-4 (ViT and ResNet members), and is
  model1's module, on model1's device, with the merged weights;
- the exporter gives the keys and the bits of
  ``fitclip_tpu/convert/flax_to_torch.py:clip_torch_state_dict_from_params``
  on the same tree (``visual.conv1.bias`` only when it is non-zero), and
  ``convert/torch_state_dict.py`` reads it back to the same state;
- checkpoint_to_state_dict exports a train-state file's encoder so that
  load_clip_encoder(checkpoint_path=...) loads the same weights, and keeps
  a Lightning checkpoint's prefixed keys as ``scripts/checkpoint_to_state_dict.py``."""

import importlib.util
import io
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fitclip_tpu.convert.flax_to_torch import clip_torch_state_dict_from_params
from fitclip_tpu.models import wise as jax_wise
from fitclip_tpu.models.clip import load as jax_load
from fitclip_tpu.models.clip import resnet_clip as jax_resnet_clip
from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.clip.model import CLIPConfig as JaxConfig
from fitclip_tpu.ops.quant import quantize_clip_params
from fitclip_torch.convert import checkpoint_to_state_dict as export_script
from fitclip_torch.convert.from_jax import (params_from_jax, params_to_jax,
                                            resnet_clip_params_to_jax)
from fitclip_torch.convert.openai_state_dict import openai_state_dict
from fitclip_torch.convert.torch_state_dict import clip_params_from_torch
from fitclip_torch.models.clip import load
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, init_float_params
from fitclip_torch.models.wise import wise_params
from fitclip_torch.training.checkpointing import save_checkpoint
from fitclip_torch.training.state import init_train_state, make_optimizer

from tests.test_torch_convert_state_dict import CONFIG, _save
from tests.test_torch_resnet import _inputs as rn_inputs
from tests.test_torch_resnet import _jax_config as jax_rn_config
from tests.test_torch_resnet import _run, port_tiny

W = 0.4
FLOAT_TOL = 2e-4
SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "checkpoint_to_state_dict.py"


def _port(family, seed):
    if family == "vit":
        return load.load_tiny_test_encoder(num_frames=2, seed=seed, device="cpu")
    return port_tiny(seed=seed)


def _jax_tree(loaded):
    encoder = loaded.encoder
    to_jax = params_to_jax if family_of(loaded) == "vit" else resnet_clip_params_to_jax
    return jax.tree_util.tree_map(np.array, to_jax(encoder.model.state_dict(), encoder.config))


def family_of(loaded):
    return "vit" if isinstance(loaded.encoder, ClipVideoTextEncoder) else "resnet"


def _jax_loaded(loaded):
    encoder = loaded.encoder
    if family_of(loaded) == "vit":
        ref = JaxEncoder(JaxConfig.tiny_test(), num_frames=2)
    else:
        ref = jax_resnet_clip.ResNetClipVideoTextEncoder(jax_rn_config(encoder.config),
                                                         num_frames=2)
    return jax_load.LoadedEncoder(encoder=ref, params=_jax_tree(loaded))


@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_wise_params_are_jax_s(family):
    a, b = _port(family, 0), _port(family, 1)
    merged = wise_params(a.encoder.model.state_dict(), b.encoder.model.state_dict(), W)
    want = jax_wise.wise_params(_jax_tree(a), _jax_tree(b), weight_for_2=W)
    a.encoder.model.load_state_dict(merged)
    got = _jax_tree(a)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for path, leaf in leaves:
        value = got
        for key in path:
            value = value[key.key]
        np.testing.assert_array_equal(value, np.asarray(leaf), err_msg=str(path))
    if family == "resnet":
        assert any("running_var" in str(path) for path, _ in leaves)


def test_structure_mismatch_raises_as_in_jax():
    a, b = (_port("vit", s).encoder.model.state_dict() for s in (0, 1))
    with pytest.raises(ValueError):
        jax_wise.wise_params({"a": np.ones(2)}, {"b": np.ones(2)})
    extra = dict(b, **{"visual.extra": torch.zeros(1)})
    with pytest.raises(ValueError, match="visual.extra"):
        wise_params(a, extra)
    wider = dict(b, **{"visual.proj": torch.zeros(48, 33)})
    with pytest.raises(ValueError, match=r"visual.proj is \(48, 32\) in model1 and \(48, 33\)"):
        wise_params(a, wider)
    rn = port_tiny().encoder.model.state_dict()
    with pytest.raises(ValueError, match="only in model2"):
        wise_params(a, rn)


def test_int8_members_are_refused_where_jax_leaves_no_int8_weight():
    """JAX promotes kernel_q under the float weight: the merged "int8" leaves
    are fractional floats, which no int8 kernel can take. The port raises."""
    trees = [_jax_tree(_port("vit", s)) for s in (0, 1)]
    merged = jax_wise.wise_params(*[quantize_clip_params(t) for t in trees], weight_for_2=W)
    kernel_q = np.asarray(merged["visual"]["transformer"]["blocks"]["attn"]["in_proj"]["kernel_q"])
    assert kernel_q.dtype.kind == "f" and not np.array_equal(kernel_q, np.round(kernel_q))

    def int8(tree):
        encoder = ClipVideoTextEncoder(CLIPConfig.tiny_test(), num_frames=2,
                                       dtype=torch.bfloat16, quantized=True, device="cpu")
        encoder.model.load_state_dict(params_from_jax(quantize_clip_params(tree), encoder.config))
        return load.LoadedEncoder(encoder)

    with pytest.raises(ValueError, match="int8"):
        load.wise_encoder(int8(trees[0]), int8(trees[1]), weight_for_2=W)


@pytest.mark.parametrize("family", ["vit", "resnet"])
def test_wise_encoder_embeds_as_jax(family):
    a, b = _port(family, 0), _port(family, 1)
    ref = jax_load.wise_encoder(_jax_loaded(a), _jax_loaded(b), weight_for_2=W)
    module = a.encoder.model
    merged = load.wise_encoder(a, b, weight_for_2=W)
    assert merged.encoder is a.encoder and merged.encoder.model is module
    assert next(module.parameters()).device.type == "cpu"
    video, ids = rn_inputs(5)
    with torch.no_grad():
        got = (merged.encode_video(torch.from_numpy(video)),
               merged.encode_text(torch.from_numpy(ids).long()))
    want = (_run(ref.encoder.encode_video, ref.params, video),
            _run(ref.encoder.encode_text, ref.params, ids))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FLOAT_TOL, rtol=0)


def _state(seed=0, bias=False):
    model = init_float_params(CLIPModel(CONFIG), seed)
    if bias:
        with torch.no_grad():
            model.visual.patch_embed.bias.copy_(torch.linspace(-0.1, 0.1, CONFIG.vision.width))
    return model.state_dict()


@pytest.mark.parametrize("bias", [False, True], ids=["no_conv1_bias", "conv1_bias"])
def test_exporter_is_jax_s_and_reads_back(bias):
    state = _state(bias=bias)
    got = openai_state_dict(state)
    want = clip_torch_state_dict_from_params(params_to_jax(state, CONFIG))
    assert list(got) == list(want)
    assert ("visual.conv1.bias" in got) == bias
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    back = clip_params_from_torch({k: v.numpy() for k, v in got.items()}, CONFIG)
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key


def test_checkpoint_to_state_dict_exports_what_load_clip_encoder_reads(tmp_path):
    encoder = ClipVideoTextEncoder(CONFIG, num_frames=2, device="cpu")
    encoder.model.load_state_dict(_state(seed=3, bias=True))
    state = init_train_state(encoder, make_optimizer(1e-4))
    ckpt, out = tmp_path / "last", tmp_path / "student.pt"
    save_checkpoint(str(ckpt), state)
    export_script.main([str(ckpt), "--output", str(out)])
    loaded = load.load_clip_encoder(checkpoint_path=str(out), device="cpu", num_frames=2)
    assert loaded.encoder.config == CONFIG
    for key, value in encoder.model.state_dict().items():
        assert torch.equal(loaded.encoder.model.state_dict()[key], value), key


def test_checkpoint_to_state_dict_keeps_a_lightning_checkpoint_s_keys_as_the_script(
        tmp_path, monkeypatch, capsysbinary):
    """A checkpoint that is not a train state: the keys under --prefix,
    without it, as the JAX package's script writes them (to stdout)."""
    tensors = {f"encoder.model.{k}": torch.from_numpy(np.asarray(v))
               for k, v in openai_state_dict(_state(seed=4)).items()}
    tensors["teacher.weight"] = torch.ones(2)
    path = _save(tmp_path / "lightning.ckpt", tensors, wrap=lambda t: {"state_dict": t})
    spec = importlib.util.spec_from_file_location("_checkpoint_to_state_dict_script", SCRIPT)
    script = importlib.util.module_from_spec(spec)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)  # nothing written into scripts/
    spec.loader.exec_module(script)
    monkeypatch.setattr("sys.argv", ["checkpoint_to_state_dict.py", path,
                                     "--output", str(tmp_path / "jax.pt")])
    script.main()
    export_script.main([path, "--output", str(tmp_path / "port.pt")])
    got, want = (torch.load(str(tmp_path / name), weights_only=True)
                 for name in ("port.pt", "jax.pt"))
    assert list(got) == list(want) and "teacher.weight" not in got
    for key in want:
        assert torch.equal(got[key], want[key]), key
    capsysbinary.readouterr()
    export_script.main([path])
    streamed = torch.load(io.BytesIO(capsysbinary.readouterr().out), weights_only=True)
    assert list(streamed) == list(want)
