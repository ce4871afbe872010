"""fitclip_torch/training/state.py's AdamW against the JAX package's optimizers.

The same seeded params and gradients go through ``make_optimizer`` of both
packages for 5 steps: the fused path against ``make_fused_adamw`` and the
``fused=False`` path against the optax chain, covering freezing, global-norm
clipping, an lr schedule, bf16 moments and the temperature clamp, at the JAX
test's rtol 2e-5 / atol 1e-7 (tests/test_fused_optimizer.py). The freeze
patterns are the JAX package's slash-joined paths.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.training import state as jax_state
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig
from fitclip_torch.training import state as S

SHAPES = {"encoder.text.w": (16, 8), "encoder.text.b": (8,), "encoder.visual.w": (4, 16),
          "logit_scale": (1,)}


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=shape).astype(np.float32) for name, shape in SHAPES.items()}


def _jax_tree(arrays):
    return {"encoder": {"text": {"w": jnp.asarray(arrays["encoder.text.w"]),
                                 "b": jnp.asarray(arrays["encoder.text.b"])},
                        "visual": {"w": jnp.asarray(arrays["encoder.visual.w"])}},
            "logit_scale": jnp.asarray(arrays["logit_scale"])}


def _run_jax(optimizer, steps, scale, max_logit_scale):
    params = _jax_tree(_arrays(0))
    state = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                 opt_state=optimizer.init(params),
                                 max_logit_scale=jnp.full((1,), max_logit_scale))
    for step in range(steps):
        grads = jax.tree_util.tree_map(lambda g: g * scale, _jax_tree(_arrays(1 + step)))
        state = jax_state.apply_updates_with_clamp(state, grads, optimizer)
    return state


def _run_torch(optimizer, steps, scale, max_logit_scale):
    named = {n: torch.nn.Parameter(torch.from_numpy(a)) for n, a in _arrays(0).items()}
    opt_state = optimizer.init(named)
    for step in range(steps):
        grads = {n: torch.from_numpy(a) * scale for n, a in _arrays(1 + step).items()}
        opt_state = optimizer.apply(named, grads, opt_state)
        with torch.no_grad():
            named["logit_scale"].clamp_(max=max_logit_scale)
    return named, opt_state


def _compare(kwargs, steps=5, scale=1.0, max_logit_scale=10.0, lr=3e-4):
    jax_kwargs = dict(kwargs)
    if "freeze_patterns" in kwargs:
        jax_kwargs["params_example"] = _jax_tree(_arrays(0))
        kwargs = dict(kwargs, params_example={n: torch.zeros(s) for n, s in SHAPES.items()})
    schedule = kwargs.pop("schedule", None)
    jax_kwargs.pop("schedule", None)
    ref = _run_jax(jax_state.make_optimizer(schedule[0] if schedule else lr, **jax_kwargs),
                   steps, scale, max_logit_scale)
    named, opt_state = _run_torch(S.make_optimizer(schedule[1] if schedule else lr, **kwargs),
                                  steps, scale, max_logit_scale)
    leaves = jax.tree_util.tree_leaves_with_path(ref.params)
    for path, leaf in leaves:
        name = ".".join(str(k.key) for k in path)
        np.testing.assert_allclose(named[name].detach().numpy(), np.asarray(leaf),
                                   rtol=2e-5, atol=1e-7, err_msg=name)
    return ref, named, opt_state


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("weight_decay,eps", [(0.01, 1e-8), (0.1, 1e-6)])
def test_adamw_matches_jax(fused, weight_decay, eps):
    ref, _, opt_state = _compare(dict(weight_decay=weight_decay, eps=eps, betas=(0.9, 0.98),
                                      fused=fused))
    assert opt_state["count"] == 5
    if fused:  # the fused layout's moments, leaf for leaf
        np.testing.assert_allclose(opt_state["mu"]["encoder.text.w"].numpy(),
                                   np.asarray(ref.opt_state["mu"]["encoder"]["text"]["w"]),
                                   rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("fused", [True, False])
def test_freeze_is_hard_zero(fused):
    _, named, opt_state = _compare(dict(freeze_patterns=[r"^encoder/text/"], fused=fused), lr=1e-3)
    start = _arrays(0)
    for name in ("encoder.text.w", "encoder.text.b"):
        np.testing.assert_array_equal(named[name].detach().numpy(), start[name])
        assert opt_state["mu"][name].shape == ()  # a placeholder, not a moment
    assert opt_state["mu"]["encoder.visual.w"].shape == (4, 16)


@pytest.mark.parametrize("fused", [True, False])
def test_global_norm_clip_matches(fused):
    _compare(dict(gradient_clip_val=0.5, fused=fused), scale=100.0, lr=1e-3)


@pytest.mark.parametrize("fused", [True, False])
def test_schedule_matches(fused):
    schedule = (lambda count: 1e-3 / (1.0 + count.astype(jnp.float32)),
                lambda count: 1e-3 / (1.0 + count))
    _compare(dict(schedule=schedule, fused=fused))


def test_bf16_moments_match_jax():
    _, _, opt_state = _compare(dict(fused=True, moment_dtype="bfloat16"))
    assert opt_state["mu"]["encoder.text.w"].dtype == torch.bfloat16
    assert opt_state["nu"]["encoder.visual.w"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="fused"):
        S.make_optimizer(1e-3, moment_dtype="bfloat16")


def test_clamp_that_binds_matches_jax():
    """max_logit_scale below the start value (-0.66): the first step's clamp
    binds, and both packages continue from the bound."""
    assert _arrays(0)["logit_scale"].item() > -1.0
    _, named, _ = _compare(dict(fused=True), max_logit_scale=-1.0)
    assert named["logit_scale"].item() <= -1.0


def test_temperature_clamp_and_fit_temperature():
    optimizer = S.make_optimizer(10.0, fused=True, weight_decay=0.0)
    enc = ClipVideoTextEncoder(CLIPConfig.tiny_test())
    state = S.init_train_state(enc, optimizer, init_temperature=0.05, min_temperature=0.5)
    assert state.params["logit_scale"].item() == pytest.approx(-math.log(0.05))
    grads = {n: -torch.ones_like(p) for n, p in state.named_parameters().items()}
    S.apply_updates_with_clamp(state, grads, optimizer)
    assert state.params["logit_scale"].item() == pytest.approx(-math.log(0.5))
    assert state.step == 1

    frozen = S.make_optimizer(1e-3, fit_temperature=False,
                              params_example={"encoder": enc, "logit_scale": torch.zeros(1)})
    assert not frozen.trainable("logit_scale") and frozen.trainable("encoder.visual.proj")


def test_parameter_paths_follow_the_jax_tree():
    enc = ClipVideoTextEncoder(CLIPConfig.tiny_test())
    names = S.named_parameters({"encoder": enc, "logit_scale": torch.zeros(1)})
    paths = {S.jax_param_path(n) for n in names}
    from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
    from fitclip_tpu.models.clip.model import CLIPConfig as JaxConfig

    jax_encoder = JaxEncoder(JaxConfig.tiny_test())
    jax_params = {"encoder": jax.eval_shape(jax_encoder.init_params, jax.random.PRNGKey(0)),
                  "logit_scale": jnp.zeros(1)}
    assert paths == set(jax_state.param_path_strings(jax_params))
    mask = S.freeze_mask(names, [r"visual/transformer/blocks/attn/", r"ln_final"])
    frozen = sorted(n for n, keep in mask.items() if not keep)
    assert frozen == sorted(n for n in names if ".attn." in n and n.startswith("encoder.visual")
                            or ".ln_final." in n)
