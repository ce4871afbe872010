"""The port's CLIP ResNet (fitclip_torch/models/clip/{resnet,resnet_clip}.py,
the ResNet branch of load.py, the train steps with a BatchNorm student)
against the JAX package on the CPU, with the weights carried across by
convert/from_jax.py:resnet_clip_params_{from,to}_jax:

- BatchNorm in both forms: outputs, gradients through the batch statistics and
  the EMA updates against JAX's, and the train form against
  torch.nn.BatchNorm2d.train() (JAX's own oracle);
- the tiny encoder (``load_tiny_rn_test_encoder``'s config, BatchNorm
  statistics and affines drawn from a seed so that the fold is not the
  identity): encode_video and encode_text in fp32 at 2e-4 and in bf16 at
  cosine >= 0.999 against JAX's bf16 and the port's own fp32;
- resnet_clip_params_from_torch on one synthetic OpenAI-schema state dict,
  and load_clip_encoder(name=<a tiny preset>, checkpoint_path=...) in both
  packages (the preset set with monkeypatch.setitem on each RESNET_PRESETS);
  int8, remat and fused_block refused;
- one contrastive and one teacher-student step against JAX's (fused AdamW,
  the running statistics frozen by bn_freeze_patterns): the loss, every moved
  weight, and running statistics equal to the EMA of one combined batch;
- a train-state checkpoint keeps the running statistics.

The JAX side is compiled once per function, at XLA's backend optimization
level 0 (``_run``: compiling is this tiny reference's whole cost here)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip import load as jax_load
from fitclip_tpu.models.clip import resnet as jax_resnet
from fitclip_tpu.models.clip import resnet_clip as jax_resnet_clip
from fitclip_tpu.models.clip.model import TextConfig as JaxTextConfig
from fitclip_tpu.training import state as jax_state
from fitclip_tpu.training import steps as jax_steps
from fitclip_torch.convert.from_jax import (resnet_clip_params_from_jax,
                                            resnet_clip_params_to_jax, train_state_to_jax)
from fitclip_torch.models.clip import load
from fitclip_torch.models.clip import resnet_clip
from fitclip_torch.models.clip.resnet import BatchNorm
from fitclip_torch.training import checkpointing
from fitclip_torch.training.state import init_train_state, make_optimizer
from fitclip_torch.training.steps import (make_contrastive_train_step,
                                          make_teacher_student_train_step)

from tests.test_torch_convert_state_dict import _save
from tests.test_torch_convert_state_dict import openai_state_dict as openai_vit_state_dict
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

FLOAT_TOL = 2e-4
LR = 1e-3
FRAMES = 2
TINY = "RN-tiny"


def _jax_config(config):
    return jax_resnet_clip.ResNetCLIPConfig(
        embed_dim=config.embed_dim,
        vision=jax_resnet.ModifiedResNetConfig(**dataclasses.asdict(config.vision)),
        text=JaxTextConfig(**dataclasses.asdict(config.text)))


def _seeded_batch_norms(encoder, seed: int = 7):
    """BatchNorm affines and running statistics drawn from a seed, in place."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for module in encoder.model.modules():
            if isinstance(module, BatchNorm):
                n = module.weight.shape[0]
                module.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
                module.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
                module.running_mean.copy_(
                    torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)))
                module.running_var.copy_(
                    torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)))


def port_tiny(dtype=torch.float32, seed: int = 0):
    loaded = load.load_tiny_rn_test_encoder(num_frames=FRAMES, seed=seed, device="cpu")
    _seeded_batch_norms(loaded.encoder, seed=seed + 7)
    if dtype != torch.float32:
        encoder = resnet_clip.ResNetClipVideoTextEncoder(loaded.encoder.config, FRAMES, dtype)
        encoder.model.load_state_dict(loaded.encoder.model.state_dict())
        loaded = load.LoadedEncoder(encoder)
    return loaded


def _run(fn, *args):
    """fn(*args) jitted, compiled at backend optimization level 0, waited for."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jax.block_until_ready(compiled(*args))


def _tree(encoder):
    """The JAX tree of the encoder's weights, copied (the port updates its own in place)."""
    return jax.tree_util.tree_map(np.array, resnet_clip_params_to_jax(
        encoder.model.state_dict(), encoder.config))


def _inputs(seed: int = 0, clips: int = 4):
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, (clips, FRAMES, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 63, (clips, 16)).astype(np.int32)
    ids[np.arange(clips), rng.integers(4, 16, clips)] = 63  # the EOT: the row's largest id
    return video, ids


@pytest.fixture(scope="module")
def jax_encode():
    """JAX's tiny encoder in fp32 and bf16 on the port's weights: embeddings of
    _inputs() per dtype."""
    port = port_tiny()
    config = _jax_config(port.encoder.config)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(port.encoder))
    video, ids = _inputs()
    out = {}
    for name, dtype in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        enc = jax_resnet_clip.ResNetClipVideoTextEncoder(config, num_frames=FRAMES, dtype=dtype)
        out[name] = (np.asarray(_run(enc.encode_video, params, video), np.float32),
                     np.asarray(_run(enc.encode_text, params, ids), np.float32))
    return out


def _cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) *
                                     np.linalg.norm(b, axis=-1))).min())


@pytest.mark.parametrize("form", ["inference", "train"])
def test_batch_norm_matches_jax(form):
    """Outputs, the gradients of sum(out * g) with respect to x, weight and
    bias (through the batch statistics in the train form), and the EMA updates.
    XLA:CPU's rsqrt is not correctly rounded: the fold may sit 2 ulp off."""
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, (4, 5, 5, 3)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    leaves = {"weight": rng.normal(size=3).astype(np.float32),
              "bias": rng.normal(size=3).astype(np.float32),
              "running_mean": rng.normal(size=3).astype(np.float32),
              "running_var": rng.uniform(0.5, 2.0, size=3).astype(np.float32)}
    train = form == "train"
    module = jax_resnet.BatchNorm(3, use_batch_stats=train)

    def loss(x, params):
        out, mutated = module.apply({"params": params}, x, mutable=["bn_stats"])
        return (out * g).sum(), (out, mutated)

    (_, (want, mutated)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), leaves)

    bn = BatchNorm(3)
    with torch.no_grad():
        for name, value in leaves.items():
            getattr(bn, name).copy_(torch.from_numpy(value))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    updates = [] if train else None
    out = bn(xt, updates)
    (out * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=FLOAT_TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx),
                               atol=FLOAT_TOL, rtol=1e-5)
    for name in ("weight", "bias"):
        np.testing.assert_allclose(getattr(bn, name).grad.numpy(), np.asarray(gp[name]),
                                   atol=FLOAT_TOL, rtol=1e-5)
    if train:
        ((_, mean, var),) = updates
        np.testing.assert_allclose(mean.numpy(), np.asarray(mutated["bn_stats"]["mean"][0]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(var.numpy(), np.asarray(mutated["bn_stats"]["var"][0]),
                                   atol=1e-6, rtol=1e-6)
        assert not mean.requires_grad and not var.requires_grad
    else:
        assert "bn_stats" not in mutated


def test_train_form_batch_norm_matches_torch_batch_norm_2d():
    """JAX's own oracle (tests/test_resnet_train.py::test_train_mode_bn_matches_torch):
    the output and the running statistics of torch's BatchNorm2d.train(),
    while the port's running statistics stay until the updates are applied."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 3, 5, 5)).astype(np.float32))
    bn, oracle = BatchNorm(3), torch.nn.BatchNorm2d(3)
    with torch.no_grad():
        for name, value in (("weight", rng.normal(size=3)), ("bias", rng.normal(size=3)),
                            ("running_mean", rng.normal(size=3)),
                            ("running_var", rng.uniform(0.5, 2.0, size=3))):
            getattr(bn, name).copy_(torch.from_numpy(value.astype(np.float32)))
            getattr(oracle, name).copy_(torch.from_numpy(value.astype(np.float32)))
    before = bn.running_mean.clone()
    updates = []
    out = bn(x, updates)
    want = oracle.train()(x)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), atol=1e-5)
    assert torch.equal(bn.running_mean, before)
    resnet_clip.ResNetClipVideoTextEncoder.apply_bn_updates(updates)
    np.testing.assert_allclose(bn.running_mean.numpy(), oracle.running_mean.numpy(), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), oracle.running_var.numpy(), atol=1e-6)


def test_encoder_matches_jax_fp32(jax_encode):
    video, ids = _inputs()
    port = port_tiny()
    with torch.no_grad():
        got_video = port.encode_video(torch.from_numpy(video))
        got_text = port.encode_text(torch.from_numpy(ids).long())
    want_video, want_text = jax_encode["float32"]
    assert got_video.shape == want_video.shape == (4, 16)
    np.testing.assert_allclose(got_video.numpy(), want_video, atol=FLOAT_TOL, rtol=0)
    np.testing.assert_allclose(got_text.numpy(), want_text, atol=FLOAT_TOL, rtol=0)


def test_encoder_bf16_matches_jax_and_fp32(jax_encode):
    """JAX's rule (tests/test_clip_resnet.py::test_bf16_eval_config_close_to_fp32):
    bf16 within cosine 0.999 of fp32, and of JAX's bf16."""
    video, ids = _inputs()
    port = port_tiny(torch.bfloat16)
    with torch.no_grad():
        got_video = port.encode_video(torch.from_numpy(video))
        got_text = port.encode_text(torch.from_numpy(ids).long())
    assert got_video.dtype == got_text.dtype == torch.bfloat16
    for got, index in ((got_video, 0), (got_text, 1)):
        got = got.float().numpy()
        assert _cosine(got, jax_encode["bfloat16"][index]) >= 0.999
        assert _cosine(got, jax_encode["float32"][index]) >= 0.999


def openai_resnet_state_dict(config, seed: int = 1):
    """A seeded RN-CLIP state dict in OpenAI's layout, with each BatchNorm's
    num_batches_tracked."""
    rng = np.random.default_rng(seed)
    model = resnet_clip.ResNetCLIPModel(config)
    sd = {}
    for name, value in model.visual.state_dict().items():
        if name.endswith("running_var"):
            sd[f"visual.{name}"] = rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
        else:
            sd[f"visual.{name}"] = (rng.normal(size=value.shape) * 0.2).astype(np.float32)
        if name.endswith("running_mean"):
            sd[f"visual.{name[:-len('running_mean')]}num_batches_tracked"] = np.int64(40)
    from fitclip_torch.models.clip.model import CLIPConfig

    text = openai_vit_state_dict(CLIPConfig(embed_dim=config.embed_dim, text=config.text),
                                 seed=seed)
    sd.update((k, v) for k, v in text.items() if not k.startswith("visual."))
    return sd


@pytest.fixture(scope="module")
def tiny_preset():
    return load.load_tiny_rn_test_encoder(device="cpu").encoder.config


def test_params_from_torch_match_jax(tiny_preset):
    sd = openai_resnet_state_dict(tiny_preset)
    got = resnet_clip.resnet_clip_params_from_torch(sd, tiny_preset)
    want = jax_resnet_clip.resnet_clip_params_from_torch(sd, _jax_config(tiny_preset))
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    # The carriers are inverse maps, and num_batches_tracked is dropped.
    state = resnet_clip_params_from_jax(got, tiny_preset)
    assert not any("num_batches_tracked" in k for k in state)
    back = resnet_clip_params_to_jax(state, tiny_preset)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back), got_leaves):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_load_clip_encoder_from_a_resnet_checkpoint_matches_jax(tiny_preset, tmp_path,
                                                                monkeypatch):
    """Both packages read the preset's architecture from ``name``, the weights
    from the checkpoint; their encoders embed alike."""
    monkeypatch.setitem(resnet_clip.RESNET_PRESETS, TINY, tiny_preset)
    monkeypatch.setitem(jax_resnet_clip.RESNET_PRESETS, TINY, _jax_config(tiny_preset))
    path = _save(tmp_path / "rn.pt", openai_resnet_state_dict(tiny_preset))
    port = load.load_clip_encoder(TINY, checkpoint_path=path, num_frames=FRAMES, device="cpu")
    ref = jax_load.load_clip_encoder(TINY, checkpoint_path=path, num_frames=FRAMES)
    assert isinstance(port.encoder, resnet_clip.ResNetClipVideoTextEncoder)
    assert port.preprocess.image_size == ref.encoder.preprocess.image_size == 32
    assert not port.encoder.fused_attention  # the CPU's default
    video, ids = _inputs(1)
    with torch.no_grad():
        got = (port.encode_video(torch.from_numpy(video)),
               port.encode_text(torch.from_numpy(ids).long()))
    want = (_run(ref.encoder.encode_video, ref.params, video),
            _run(ref.encoder.encode_text, ref.params, ids))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FLOAT_TOL, rtol=0)
    # A preset name alone gives a seeded encoder of the same architecture.
    seeded = load.load_clip_encoder(TINY, device="cpu", seed=3)
    assert {k: v.shape for k, v in seeded.encoder.model.state_dict().items()} == \
        {k: v.shape for k, v in port.encoder.model.state_dict().items()}


def test_tiny_rn_test_encoder_has_jax_s_tree(tiny_preset, monkeypatch):
    """load_tiny_rn_test_encoder: JAX's config, preprocess and parameter tree
    (paths and shapes, JAX's init traced by eval_shape; the port draws its own
    seeded values)."""
    init = jax_resnet_clip.ResNetClipVideoTextEncoder.init_params
    monkeypatch.setattr(jax_resnet_clip.ResNetClipVideoTextEncoder, "init_params",
                        lambda self, rng: jax.eval_shape(lambda key: init(self, key), rng))
    ref = jax_load.load_tiny_rn_test_encoder()
    assert _jax_config(tiny_preset) == ref.encoder.config
    port = load.load_tiny_rn_test_encoder(device="cpu")
    tree = _tree(port.encoder)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref.params)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ref.params)):
        assert a.shape == b.shape
    for key in ("num_frames", "image_size", "mean", "std", "max_tokens"):
        assert getattr(port.preprocess, key) == getattr(ref.encoder.preprocess, key)


def test_the_resnet_loaders_run_on_the_card_unless_asked(monkeypatch):
    """No fallback to the CPU: without a card, the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load.load_clip_encoder("RN50")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load.load_tiny_rn_test_encoder()


def test_int8_remat_and_fused_block_are_refused():
    with pytest.raises(ValueError) as jax_error:
        jax_load.load_clip_encoder("RN50", dtype="int8")
    with pytest.raises(ValueError) as port_error:
        load.load_clip_encoder("RN50", dtype="int8", device="cpu")
    assert str(port_error.value) == str(jax_error.value)
    with pytest.raises(ValueError, match="remat"):
        load.load_clip_encoder("RN50", remat=True, device="cpu")
    with pytest.raises(ValueError, match="fused_block"):
        load.load_clip_encoder("RN50", fused_block=True, device="cpu")


# --- the train steps ---------------------------------------------------------------

def _ts_batch(video, ids):
    half = len(video) // 2
    sub = [{"video_student": video[s], "text_student": ids[s], "video_teacher": video[s],
            "text_teacher": ids[s]} for s in (slice(0, half), slice(half, None))]
    return {"labeled": sub[0], "unlabeled": sub[1]}


def _to_torch(batch):
    if isinstance(batch, dict):
        return {k: _to_torch(v) for k, v in batch.items()}
    return torch.from_numpy(batch).long() if batch.dtype == np.int32 else torch.from_numpy(batch)


def _jax_step(mode, port_student, port_teacher, batch):
    config = _jax_config(port_student.encoder.config)
    encoder = jax_resnet_clip.ResNetClipVideoTextEncoder(config, num_frames=FRAMES)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(port_student.encoder))
    template = {"encoder": params, "logit_scale": np.zeros((1,), np.float32)}
    if mode == "teacher_student":
        template["ts_logit_scale"] = np.zeros((1,), np.float32)
    optimizer = jax_state.make_optimizer(LR, freeze_patterns=list(encoder.bn_freeze_patterns),
                                         params_example=template, fused=True)
    state = jax_state.init_train_state(params, optimizer,
                                       with_teacher_student_scale=mode == "teacher_student")
    if mode == "contrastive":
        return _run(jax_steps.make_contrastive_train_step(encoder, optimizer), state, batch)
    teacher_params = jax.tree_util.tree_map(jnp.asarray, _tree(port_teacher.encoder))
    step = jax_steps.make_teacher_student_train_step(encoder, encoder, optimizer,
                                                     labeled_loss_share=0.7)
    return _run(step, state, teacher_params, batch)


@pytest.fixture(scope="module")
def stepped():
    """One step of each mode in both packages from the same weights:
    {mode: (port state, port metrics, JAX state, JAX metrics, the BN updates
    that the port's train-form encode gives on the step's video before it)}."""
    video, ids = _inputs(2)
    out = {}
    for mode in ("contrastive", "teacher_student"):
        student, teacher = port_tiny(), port_tiny(seed=1)
        batch = ({"video": video, "text": ids} if mode == "contrastive" else _ts_batch(video, ids))
        jax_state_after, jax_metrics = _jax_step(mode, student, teacher, batch)
        encoder = student.encoder
        # The combined batch in the teacher-student order: labeled, then unlabeled.
        with torch.no_grad():
            _, updates = encoder.encode_video_train(torch.from_numpy(video))
        expected = {id(bn): (mean, var) for bn, mean, var in updates}
        template = {"encoder": encoder, "logit_scale": torch.zeros(1)}
        if mode == "teacher_student":
            template["ts_logit_scale"] = torch.zeros(1)
        optimizer = make_optimizer(LR, freeze_patterns=list(encoder.bn_freeze_patterns),
                                   params_example=template, fused=True)
        state = init_train_state(encoder, optimizer,
                                 with_teacher_student_scale=mode == "teacher_student")
        step = (make_contrastive_train_step(encoder, optimizer) if mode == "contrastive"
                else make_teacher_student_train_step(encoder, teacher.encoder, optimizer,
                                                     labeled_loss_share=0.7))
        state, metrics = step(state, _to_torch(batch))
        out[mode] = (state, metrics, jax_state_after, jax_metrics, expected)
    return out


@pytest.mark.parametrize("mode", ["contrastive", "teacher_student"])
def test_train_step_matches_jax(stepped, mode):
    """The losses at rtol 1e-5; the gradients, as the first moments (0.1 g
    after one step), at rtol 1e-3 (fp32 sums through the tower in another
    order) above a floor of 1e-6 of the largest; every param at 5e-5 after one
    step of lr 1e-3, but at 2 * lr where the gradients lie under that floor
    and part by more than 1e-3: a first Adam step is lr g / (|g| + eps), and
    where the exact gradient is 0 (softmax is blind to a shift of all its
    logits: the key biases, the attention pool's k_proj along the tokens'
    mean) g is rounding noise; the
    running statistics are the EMA of the step's one (combined) batch, not
    moved by the optimizer; conv kernels and BatchNorm affines moved."""
    state, metrics, jax_after, jax_metrics, expected = stepped[mode]
    assert state.step == int(jax_after.step) == 1
    assert sorted(metrics) == sorted(jax_metrics)
    for key in metrics:
        np.testing.assert_allclose(float(metrics[key]), float(jax_metrics[key]), rtol=1e-5,
                                   err_msg=key)
    config = state.params["encoder"].config
    carried = train_state_to_jax(state, config)
    moments = jax.device_get(jax_after.opt_state["mu"])
    floor = 1e-6 * max(np.abs(leaf).max() for leaf in jax.tree_util.tree_leaves(moments))
    for path, leaf in jax.tree_util.tree_leaves_with_path(moments):
        keys = [k.key for k in path]
        mu = np.asarray(_at(carried["opt_state"]["mu"], keys))
        np.testing.assert_allclose(mu, leaf, rtol=1e-3, atol=floor, err_msg=str(keys))
    got = carried["params"]
    want = jax.device_get(jax_after.params)
    checked, exempt, total = 0, 0, 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        keys = [k.key for k in path]
        value, leaf = np.array(_at(got, keys)), np.array(leaf)
        mu, port_mu = np.asarray(_at(moments, keys)), np.asarray(_at(carried["opt_state"]["mu"],
                                                                      keys))
        if mu.shape == leaf.shape:  # trainable: a gradient of noise may step either way
            noise = (np.abs(mu) <= floor) & (np.abs(port_mu - mu) > 1e-3 * np.abs(mu))
            exempt, total = exempt + noise.sum(), total + noise.size
            np.testing.assert_allclose(value[noise], leaf[noise], atol=2 * LR, rtol=0)
            value[noise] = leaf[noise]
        tol = 1e-6 if keys[-1].startswith("running_") else 5e-5
        np.testing.assert_allclose(value, leaf, atol=tol, rtol=0, err_msg=str(keys))
        checked += 1
    assert checked > 80
    assert exempt < 0.05 * total, (exempt, total)
    bns = [m for m in state.params["encoder"].model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == len(expected) == 19
    for bn in bns:
        mean, var = expected[id(bn)]
        assert torch.equal(bn.running_mean, mean) and torch.equal(bn.running_var, var)
    # The optimizer's frozen placeholders: no moment for the running statistics.
    moments = state.opt_state["mu"]
    assert all(moments[n].dim() == 0 for n in moments if n.endswith(("running_mean",
                                                                      "running_var")))
    start = port_tiny().encoder.model.state_dict()
    model = state.params["encoder"].model.state_dict()
    for name in ("visual.conv1.weight", "visual.bn1.weight", "visual.bn1.running_mean",
                 "visual.layer2.0.downsample.1.running_var"):
        assert not torch.equal(model[name], start[name]), name


def _at(tree, keys):
    for key in keys:
        tree = tree[key]
    return tree


def test_train_checkpoint_keeps_the_running_statistics(stepped, tmp_path):
    """save_checkpoint / restore_checkpoint: the running statistics are in
    the file and come back bit for bit into a fresh state."""
    state = stepped["contrastive"][0]
    path = str(tmp_path / "last")
    checkpointing.save_checkpoint(path, state)
    saved = checkpointing.load_checkpoint(path)["params"]
    names = [n for n in saved if n.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 19
    fresh = port_tiny().encoder
    optimizer = make_optimizer(LR, freeze_patterns=list(fresh.bn_freeze_patterns),
                               params_example={"encoder": fresh, "logit_scale": torch.zeros(1)},
                               fused=True)
    restored = checkpointing.restore_checkpoint(path, init_train_state(fresh, optimizer))
    named, want = restored.named_parameters(), state.named_parameters()
    for name in want:
        assert torch.equal(named[name], want[name]), name
    assert restored.step == 1
