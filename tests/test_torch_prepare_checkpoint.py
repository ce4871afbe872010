"""The port's checkpoint entry points (``python -m fitclip_torch.convert.
{prepare_trained_clip_checkpoint_for_evaluation, prepare_trained_checkpoint_for_evaluation,
apply_wise_ft}``) against the JAX package's scripts, on the CPU, at the cases
of tests/test_convert_roundtrip.py:59-116.

Each JAX script's ``main()`` runs in this process on the same input (its
``sys.argv`` set, the script loaded from ``scripts/`` without leaving
bytecode there); the port's file must hold the same keys and bit-equal
tensors, NaN ``logit_scale`` included. Then the port's own inputs: its
train-state file, which ``load_clip_encoder`` reads back after preparation
(the NaN ``logit_scale`` is accepted), and an Orbax directory, refused.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fitclip_torch.convert import apply_wise_ft, prepare_trained_checkpoint_for_evaluation
from fitclip_torch.convert import prepare_trained_clip_checkpoint_for_evaluation
from fitclip_torch.convert.openai_state_dict import openai_state_dict as port_openai_state_dict
from fitclip_torch.models.clip.load import load_clip_encoder
from fitclip_torch.training.checkpointing import save_checkpoint
from fitclip_torch.training.state import init_train_state, make_optimizer

from tests.test_torch_convert_state_dict import CONFIG, _save, openai_state_dict
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
PORT = {"prepare_trained_clip_checkpoint_for_evaluation":
        prepare_trained_clip_checkpoint_for_evaluation,
        "prepare_trained_checkpoint_for_evaluation": prepare_trained_checkpoint_for_evaluation,
        "apply_wise_ft": apply_wise_ft}


def _jax_main(name: str, argv):
    """scripts/<name>.py's main() in this process with ``argv``."""
    spec = importlib.util.spec_from_file_location(f"_{name}_script", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    saved, sys.dont_write_bytecode = sys.dont_write_bytecode, True
    saved_path = list(sys.path)
    try:
        spec.loader.exec_module(module)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", [f"{name}.py", *argv])
            module.main()
    finally:
        sys.dont_write_bytecode = saved
        sys.path[:] = saved_path


def _both(name, tmp_path, inputs, *flags):
    """(port's output, JAX's output) of one entry point on the same inputs."""
    out = {}
    for side in ("port", "jax"):
        path = str(tmp_path / f"{side}.pt")
        argv = [*inputs, path, *flags]
        PORT[name].main(argv) if side == "port" else _jax_main(name, argv)
        out[side] = torch.load(path, weights_only=False)
    return out["port"], out["jax"]


def _assert_same_file(port, jax):
    assert list(port) == list(jax)
    for key in jax:
        assert port[key].dtype == jax[key].dtype and port[key].shape == jax[key].shape, key
        assert torch.equal(port[key], jax[key]) or (
            torch.isnan(jax[key]).all() and torch.isnan(port[key]).all()), key


def _lightning(path, sd, prefix="encoder.model."):
    return _save(path, {f"{prefix}{k}": v for k, v in sd.items()},
                 wrap=lambda tensors: {"state_dict": tensors, "epoch": 3})


@pytest.mark.parametrize("weight", [0.4, 0.5, 0.73])
def test_apply_wise_ft_is_jax_s(tmp_path, weight):
    sd1 = openai_state_dict(CONFIG, seed=0)
    sd2 = {k: v + np.float32(1.0) for k, v in openai_state_dict(CONFIG, seed=1).items()}
    inputs = [_save(tmp_path / "a.pt", sd1), _save(tmp_path / "b.pt", sd2)]
    port, jax = _both("apply_wise_ft", tmp_path, inputs, "--weight-for-2", str(weight))
    _assert_same_file(port, jax)
    assert torch.isnan(port["logit_scale"]).item()
    key = "visual.class_embedding"
    np.testing.assert_allclose(port[key].numpy(), (1 - weight) * sd1[key] + weight * sd2[key],
                               atol=1e-6)


def test_apply_wise_ft_refuses_other_parameter_sets_as_jax(tmp_path):
    sd1 = openai_state_dict(CONFIG, seed=0)
    sd2 = {k: v for k, v in sd1.items() if k != "visual.proj"}
    inputs = [_save(tmp_path / "a.pt", sd1), _save(tmp_path / "b.pt", sd2)]
    messages = []
    for run in (lambda argv: apply_wise_ft.main(argv),
                lambda argv: _jax_main("apply_wise_ft", argv)):
        with pytest.raises(SystemExit) as info:
            run([*inputs, str(tmp_path / "out.pt")])
        messages.append(str(info.value))
    assert messages[0] == messages[1] and "visual.proj" in messages[0]


@pytest.mark.parametrize("prefix", [None, "model."])
def test_prepare_clip_checkpoint_is_jax_s(tmp_path, prefix):
    sd = openai_state_dict(CONFIG, seed=2)
    ckpt = _lightning(tmp_path / "train.ckpt", sd, prefix or "encoder.model.")
    flags = ["--prefix", prefix] if prefix else []
    port, jax = _both("prepare_trained_clip_checkpoint_for_evaluation", tmp_path, [ckpt], *flags)
    _assert_same_file(port, jax)
    assert "visual.proj" in port and torch.isnan(port["logit_scale"]).item()


@pytest.mark.parametrize("prefix", [None, "encoder.model", "encoder.model."])
def test_prepare_generic_checkpoint_is_jax_s(tmp_path, prefix):
    """No logit_scale surgery; a prefix without its trailing dot gets one."""
    sd = {k: v for k, v in openai_state_dict(CONFIG, seed=3).items() if k != "logit_scale"}
    ckpt = _lightning(tmp_path / "train.ckpt", sd)
    flags = ["--prefix", prefix] if prefix else []
    port, jax = _both("prepare_trained_checkpoint_for_evaluation", tmp_path, [ckpt], *flags)
    _assert_same_file(port, jax)
    assert "logit_scale" not in port and set(port) == set(sd)


def _train_state_file(tmp_path):
    """The port's train-state file of a CONFIG CLIP (heads = width / 64, so
    that load_clip_encoder infers its config), and the model's weights."""
    encoder = load_clip_encoder(checkpoint_path=_save(tmp_path / "sd.pt",
                                                      openai_state_dict(CONFIG, seed=4)),
                                device="cpu").encoder
    with torch.no_grad():
        encoder.model.visual.patch_embed.bias.add_(0.25)  # as after training: conv1.bias kept
    state = init_train_state(encoder, make_optimizer(1e-3))
    path = str(tmp_path / "last")
    save_checkpoint(path, state)
    return path, {k: v.detach().clone() for k, v in encoder.model.state_dict().items()}


def test_prepared_train_state_loads_with_the_nan_logit_scale(tmp_path):
    path, weights = _train_state_file(tmp_path)
    out = str(tmp_path / "eval.pt")
    prepare_trained_clip_checkpoint_for_evaluation.main([path, out])
    prepared = torch.load(out, weights_only=False)
    assert torch.isnan(prepared["logit_scale"]).item()
    want = port_openai_state_dict(weights)
    assert set(prepared) == set(want) | {"logit_scale"}
    for key, value in want.items():
        assert torch.equal(prepared[key], value), key
    loaded = load_clip_encoder(checkpoint_path=out, device="cpu").encoder.model.state_dict()
    for key, value in weights.items():
        assert torch.equal(loaded[key], value), key
    # The generic variant writes the same weights without a logit_scale.
    generic = str(tmp_path / "generic.pt")
    prepare_trained_checkpoint_for_evaluation.main([path, generic])
    assert set(torch.load(generic, weights_only=False)) == set(want)


def test_orbax_directories_are_refused(tmp_path):
    (tmp_path / "orbax").mkdir()
    for module in (prepare_trained_clip_checkpoint_for_evaluation,
                   prepare_trained_checkpoint_for_evaluation):
        with pytest.raises(NotImplementedError, match="Orbax"):
            module.main([str(tmp_path / "orbax"), str(tmp_path / "out.pt")])
