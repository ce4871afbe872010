"""fitclip_torch's train steps against the JAX package's, from one TrainState.

Both packages start from the same state, carried across by
``convert.from_jax`` (encoder params, logit scales, clamp, fused AdamW count
and moments), then take 3 steps on the same seeded uint8 clips and token ids,
with fused attention on both sides (the Pallas kernels in interpret mode on the
JAX side, the kernels' plain versions here). Tolerances: the losses and
temperatures of every step at rtol 1e-5; the parameters after 3 steps at atol
5e-5 with lr 1e-4. The one exception is the key third of each in_proj bias:
softmax is invariant to a shift shared by all keys, so its exact gradient is 0
and both packages compute rounding noise, which AdamW (dividing each gradient by
its own magnitude) turns into steps of about lr in a direction of its own in
each package; it is held at 2 * lr per step.

With the int8 teacher, the teacher's embeddings agree with JAX's at the int8
bound (atol/rtol 2e-3, test_torch_fast_eval.py: a requantized activation on a
rounding boundary may land one step off), and the distillation loss sees them
through ts_scale = 20 in the teacher's logits and a factor ts_scale ** 2 = 400.
There the losses are held at rtol 1e-2 and every parameter at 2 * lr per step,
the most two AdamW trajectories can drift apart when their gradients differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.clip.model import CLIPConfig as JaxConfig
from fitclip_tpu.ops.quant import quantize_clip_params
from fitclip_tpu.training import state as jax_state
from fitclip_tpu.training import steps as jax_steps
from fitclip_torch.convert.from_jax import (load_train_state_from_jax, params_from_jax,
                                            params_to_jax, train_state_to_jax)
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, init_float_params
from fitclip_torch.training import state as S
from fitclip_torch.training import steps as T
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LR = 1e-4
FRAMES = 2


def _numpy_state(state):
    return {"step": np.asarray(state.step), "max_logit_scale": np.asarray(state.max_logit_scale),
            **jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                  "opt_state": state.opt_state})}


def _seeded_params(cfg, seed):
    """A JAX CLIP tree (numpy) from the port's seeded init: no JAX init to compile."""
    return params_to_jax(init_float_params(CLIPModel(cfg), seed).state_dict(), cfg)


@pytest.fixture(scope="module")
def setup():
    jax_cfg, cfg = JaxConfig.tiny_test(), CLIPConfig.tiny_test()
    student = JaxEncoder(jax_cfg, num_frames=FRAMES, fused_attention=True)
    return jax_cfg, cfg, student, _seeded_params(cfg, 0)


def _clips(rng, n):
    return rng.integers(0, 256, size=(n, FRAMES, 32, 32, 3), dtype=np.uint8)


def _ids(rng, n):
    return rng.integers(1, 60, size=(n, 16)).astype(np.int32)


def _torch_tree(batch):
    if isinstance(batch, dict):
        return {k: _torch_tree(v) for k, v in batch.items()}
    return torch.from_numpy(batch)


def _run_both(setup, jax_step, torch_step, jax_state0, port_state, batches, loss_rtol=1e-5,
              param_atol=5e-5):
    _, cfg, _, _ = setup
    state, losses = jax_state0, []
    for batch in batches:
        state, metrics = jax_step(state, jax.tree_util.tree_map(jnp.asarray, batch))
        losses.append({k: float(v) for k, v in metrics.items()})
    for i, batch in enumerate(batches):
        port_state, metrics = torch_step(port_state, _torch_tree(batch))
        assert set(metrics) == set(losses[i])
        for key, value in metrics.items():
            np.testing.assert_allclose(float(value), losses[i][key], rtol=loss_rtol, err_msg=key)
    assert port_state.step == int(state.step) == len(batches)
    ref = jax.tree_util.tree_leaves_with_path(_numpy_state(state)["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(train_state_to_jax(port_state, cfg)["params"]))
    width = {"visual": cfg.vision.width, "text": cfg.text.width}
    for path, leaf in ref:
        value = got[path]
        keys = [k.key for k in path]
        if keys[-2:] == ["in_proj", "bias"]:
            key_bias = slice(width[keys[1]], 2 * width[keys[1]])
            np.testing.assert_allclose(value[:, key_bias], leaf[:, key_bias],
                                       atol=2 * LR * len(batches), rtol=0)
            value, leaf = value.copy(), leaf.copy()
            value[:, key_bias] = leaf[:, key_bias]
        np.testing.assert_allclose(value, leaf, atol=param_atol, rtol=0, err_msg=str(path))


def test_contrastive_steps_match_jax(setup):
    jax_cfg, cfg, student, params = setup
    rng = np.random.default_rng(1)
    batches = [{"video": _clips(rng, 3), "text": _ids(rng, 3)} for _ in range(3)]
    jax_opt = jax_state.make_optimizer(LR, fused=True)
    jax_s = jax_state.init_train_state(params, jax_opt)

    encoder = ClipVideoTextEncoder(cfg, num_frames=FRAMES, fused_attention=True)
    opt = S.make_optimizer(LR, fused=True)
    port = load_train_state_from_jax(S.init_train_state(encoder, opt), _numpy_state(jax_s), cfg)
    _run_both(setup, jax.jit(jax_steps.make_contrastive_train_step(student, jax_opt)),
              T.make_contrastive_train_step(encoder, opt), jax_s, port, batches)


def _teacher(setup, kind):
    """(JAX teacher encoder, its params, the port's teacher) of one weight set."""
    jax_cfg, cfg, _, _ = setup
    params = _seeded_params(cfg, 1)
    if kind == "float":
        port = ClipVideoTextEncoder(cfg, num_frames=FRAMES, fused_attention=True)
        port.model.load_state_dict(params_from_jax(params, cfg))
        return JaxEncoder(jax_cfg, num_frames=FRAMES, fused_attention=True), params, port
    # int8, calibrated by the port, on the fused int8 layer path of both packages.
    port = ClipVideoTextEncoder(cfg, num_frames=FRAMES, quantized=True, fused_attention=True,
                                fused_block=True)
    port.model.load_state_dict(params_from_jax(quantize_clip_params(params), cfg))
    rng = np.random.default_rng(9)
    port.calibrate(torch.from_numpy(_clips(rng, 4)), torch.from_numpy(_ids(rng, 4)))
    return (JaxEncoder(jax_cfg, num_frames=FRAMES, quantized=True, fused_attention=True),
            params_to_jax(port.model.state_dict(), cfg), port)


@pytest.mark.parametrize("teacher_kind", ["float", "int8"])
def test_teacher_student_steps_match_jax(setup, teacher_kind):
    jax_cfg, cfg, student, params = setup
    jax_teacher, teacher_params, port_teacher = _teacher(setup, teacher_kind)
    rng = np.random.default_rng(2)

    def sub():
        return {"video_student": _clips(rng, 2), "text_student": _ids(rng, 2),
                "video_teacher": _clips(rng, 2), "text_teacher": _ids(rng, 2)}

    batches = [{"labeled": sub(), "unlabeled": sub()} for _ in range(3)]
    jax_opt = jax_state.make_optimizer(LR, fused=True)
    jax_s = jax_state.init_train_state(params, jax_opt, with_teacher_student_scale=True)
    jax_step = jax.jit(jax_steps.make_teacher_student_train_step(
        student, jax_teacher, jax_opt, labeled_loss_share=0.7))

    encoder = ClipVideoTextEncoder(cfg, num_frames=FRAMES, fused_attention=True)
    opt = S.make_optimizer(LR, fused=True)
    port = load_train_state_from_jax(
        S.init_train_state(encoder, opt, with_teacher_student_scale=True), _numpy_state(jax_s), cfg)
    teacher_params = jax.tree_util.tree_map(jnp.asarray, teacher_params)
    tolerances = {} if teacher_kind == "float" else dict(loss_rtol=1e-2,
                                                        param_atol=2 * LR * len(batches))
    _run_both(setup, lambda s, b: jax_step(s, teacher_params, b),
              T.make_teacher_student_train_step(encoder, port_teacher, opt,
                                                labeled_loss_share=0.7),
              jax_s, port, batches, **tolerances)


def test_eval_step_gives_fp32_embeddings_without_a_graph(setup):
    _, cfg, _, _ = setup
    encoder = ClipVideoTextEncoder(cfg, num_frames=FRAMES, dtype=torch.bfloat16)
    init_float_params(encoder.model, seed=4)
    rng = np.random.default_rng(5)
    batch = {"video": torch.from_numpy(_clips(rng, 3)), "text": torch.from_numpy(_ids(rng, 3))}
    video_emb, text_emb = T.make_eval_step(encoder)(batch)
    assert video_emb.dtype == text_emb.dtype == torch.float32
    assert video_emb.grad_fn is None and text_emb.grad_fn is None
    with torch.no_grad():
        assert torch.equal(video_emb, encoder.encode_video(batch["video"]).float())
        assert torch.equal(text_emb, encoder.encode_text(batch["text"]).float())


def test_train_state_round_trips_through_jax(setup):
    """Port -> JAX -> port keeps every tensor, frozen placeholders and bf16 moments included."""
    _, cfg, _, _ = setup
    encoder = ClipVideoTextEncoder(cfg)
    init_float_params(encoder.model, seed=3)
    opt = S.make_optimizer(LR, fused=True, moment_dtype="bfloat16", freeze_patterns=["ln_final"],
                           params_example={"encoder": encoder, "logit_scale": torch.zeros(1)})
    state = S.init_train_state(encoder, opt, with_teacher_student_scale=True)
    for i, (name, p) in enumerate(state.named_parameters().items()):
        if opt.trainable(name):
            state.opt_state["mu"][name].fill_(0.5 + i)
            state.opt_state["nu"][name].fill_(0.25 * i)
    state.opt_state["count"], state.step = 7, 7
    tree = train_state_to_jax(state, cfg)
    assert tree["opt_state"]["mu"]["encoder"]["text"]["ln_final"]["ln"]["scale"].shape == ()
    back = load_train_state_from_jax(
        S.init_train_state(ClipVideoTextEncoder(cfg), opt, with_teacher_student_scale=True),
        tree, cfg)
    assert back.step == 7 and back.opt_state["count"] == 7
    for name, p in state.named_parameters().items():
        assert torch.equal(back.named_parameters()[name], p)
        for key in ("mu", "nu"):
            assert torch.equal(back.opt_state[key][name], state.opt_state[key][name])
