"""The port's tensor parallelism (fitclip_torch/parallel/{mesh,sharding_rules,
tensor_parallel}.py and the contrastive step on a grid) against the JAX
package's, on the CPU: the cases of tests/test_tensor_parallel.py and
tests/test_fsdp.py:105-126.

One module-scoped job starts four ranks (``tests/torch_grid_worker.py tp``,
gloo over loopback, one thread each) on a (data=2, model=2) grid while this
process runs the JAX side:

- the rules split the big kernels as JAX's ``tensor_parallel_shardings`` does,
  and each model rank holds half of ``mlp_fc``'s hidden dim;
- one contrastive step of the tiny CLIP (global-norm clip 0.5) on the grid:
  the loss within rel 1e-4 of JAX's single-device step on the same parameters
  (tests/test_tensor_parallel.py's bound), and the gathered update within
  1e-2 of JAX's, ‖a − b‖ ≤ 1e-2 ‖b − θ₀‖ (AdamW moves a parameter by about
  lr whatever its gradient's scale, so the update is what can be told apart);
- that step's gradients, as its global-norm clip receives them (after the
  data average) and gathered whole, within ‖a − b‖ ≤ 1e-3 ‖b‖ of ``jax.grad``
  of JAX's contrastive loss, leaf by leaf, and the clip's norm within rel 1e-5
  of ``optax.global_norm`` of those gradients: AdamW's first step is about
  lr · sign(g), so a gradient off by a factor, or a norm that counts a leaf
  on the wrong ranks, shows only here;
- FSDP over the data ranks composes with TP as JAX's ``fsdp_shardings`` on a
  mesh with a model axis: the same split dims as JAX's on a (4, 2) mesh, a
  leaf split on both axes, step 1 on the grid with the TP step's loss and
  clip norm (rel 1e-5), and its update within 1e-2 of the TP step's.

In one process: the head-aligned QKV split (each rank its heads of Q, K and
V; the ranks' row-parallel sums added by hand give the whole attention, where
a contiguous split of the packed width does not), the divisibility errors,
and the refusal of the fused int8 and bf16 paths.
"""

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.clip.model import CLIPConfig as JaxConfig
from fitclip_tpu.ops.losses import nce_loss as jax_nce_loss
from fitclip_tpu.parallel.mesh import create_mesh
from fitclip_tpu.parallel.sharding_rules import fsdp_shardings as jax_fsdp_shardings
from fitclip_tpu.parallel.sharding_rules import (
    tensor_parallel_shardings as jax_tensor_parallel_shardings)
from fitclip_tpu.training import state as jax_state
from fitclip_tpu.training import steps as jax_steps
from fitclip_torch.convert.from_jax import params_from_jax, params_to_jax
from fitclip_torch.models.clip.model import (CLIPConfig, CLIPModel, _einsum_attention,
                                             init_float_params)
from fitclip_torch.parallel.mesh import Grid
from fitclip_torch.parallel.sharding_rules import (fsdp_layout, jax_layout, qkv_part,
                                                   shard_params, tensor_parallel_part,
                                                   tensor_parallel_shardings,
                                                   tensor_parallel_whole)
from fitclip_torch.training import state as S
from fitclip_torch.training.state import jax_param_path

from tests import torch_grid_worker as W
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

WORKER_TIMEOUT_S = 120
UPDATE_SHARE = 1e-2
GRAD_SHARE = 1e-3  # each leaf's gradient: ‖a − b‖ ≤ GRAD_SHARE ‖b‖
NORM_RTOL = 1e-5


def _jax_side():
    out = {}
    port = W.tiny_clip(0)
    tree = params_to_jax(port.model.state_dict(), port.config)
    out["theta0"] = {n: p.detach().numpy().copy() for n, p in port.model.named_parameters()}
    encoder = JaxEncoder(JaxConfig.tiny_test(), num_frames=W.FRAMES)
    optimizer = jax_state.make_optimizer(W.LR, gradient_clip_val=W.CLIP)
    state = jax_state.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), optimizer)
    batch = jax.tree_util.tree_map(jnp.asarray, W.contrastive_batch())
    step = jax.jit(jax_steps.make_contrastive_train_step(encoder, optimizer)).lower(
        state, batch).compile(compiler_options={"xla_backend_optimization_level": 0})
    new_state, metrics = step(state, batch)
    out["loss"] = float(metrics["loss/train"])

    def loss(params):
        video, _ = jax_steps._encode_video_train(encoder, params["encoder"], batch["video"])
        text = encoder.encode_text(params["encoder"], batch["text"])
        return jax_nce_loss(jax_steps._scores(video, text, params["logit_scale"]))

    grad = jax.jit(jax.grad(loss)).lower(state.params).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    grads = grad(state.params)
    out["norm"] = float(optax.global_norm(grads))
    out["grads"] = {f"encoder.{n}": t.numpy() for n, t in params_from_jax(
        jax.tree_util.tree_map(np.asarray, grads["encoder"]), port.config).items()}
    out["grads"]["logit_scale"] = np.asarray(grads["logit_scale"])
    out["params"] = {n: t.numpy() for n, t in params_from_jax(
        jax.tree_util.tree_map(np.asarray, new_state.params["encoder"]), port.config).items()}
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    started = time.monotonic()
    procs, plan = W.start("tp", tmp_path_factory.mktemp("tp"), WORKER_TIMEOUT_S)
    try:
        local = _jax_side()
    finally:
        ranks = W.collect("tp", procs, plan, started)
    return ranks, local


def _jax_dims(spec, axis):
    """The dims of a JAX leaf's spec that carry ``axis``."""
    return [d for d, entry in enumerate(tuple(spec))
            if entry == axis or (isinstance(entry, tuple) and axis in entry)]


def test_rules_split_as_jax_s():
    port = W.tiny_clip(0)
    tree = params_to_jax(port.model.state_dict(), port.config)
    mesh = create_mesh(np.asarray(jax.devices()).reshape(4, 2), axis_names=("data", "model"))
    shardings = jax_tensor_parallel_shardings(tree, mesh)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): s for path, s in
            jax.tree_util.tree_leaves_with_path(shardings)}
    split = tensor_parallel_shardings(dict(port.model.named_parameters()))
    for name, tensor in port.model.named_parameters():
        path = jax_param_path(name)
        dims = _jax_dims(flat[path].spec, "model")
        shape, to_port = jax_layout(name, tensor.shape)
        stacked = ".blocks." in name
        want = None if not dims else to_port[dims[0] - stacked]
        assert split[name] == want, name
    assert split["visual.transformer.blocks.0.mlp_fc.weight"] == 0
    assert split["visual.ln_pre.weight"] is None
    assert split["text.token_embedding"] == 0
    assert split["visual.transformer.blocks.1.attn.out_proj.weight"] == 1
    assert split["visual.transformer.blocks.1.attn.out_proj.bias"] is None


def test_ranks_hold_half_of_each_split_leaf(job):
    ranks, _ = job
    whole = {n: list(p.shape) for n, p in W.tiny_clip(0).model.named_parameters()}
    for rank, (out, _) in enumerate(ranks):
        data, model, d, m, data_ranks, model_ranks = out["grid"]
        assert (data, model, d, m) == (2, 2, rank // 2, rank % 2)
        assert data_ranks == [m, 2 + m] and model_ranks == [2 * d, 2 * d + 1]
        for name, shape in out["shapes"].items():
            dim = out["split"].get(name)
            want = list(whole[name])
            if dim is not None:
                want[dim] //= 2
            assert shape == want, name
        hidden = out["shapes"]["visual.transformer.blocks.0.mlp_fc.weight"][0]
        assert hidden == whole["visual.transformer.blocks.0.mlp_fc.weight"][0] // 2


def test_tp_train_step_matches_single_device(job):
    ranks, local = job
    for out, _ in ranks:
        assert out["loss"] == pytest.approx(local["loss"], rel=1e-4)
        assert np.isfinite(out["loss"])
    arrays = ranks[0][1]
    got = {k[len("tp/"):]: v for k, v in arrays.items() if k.startswith("tp/")}
    theta0, want = local["theta0"], local["params"]
    assert set(theta0) <= set(got)
    diff = np.sqrt(sum(np.sum((got[n] - want[n]) ** 2) for n in theta0))
    update = np.sqrt(sum(np.sum((want[n] - theta0[n]) ** 2) for n in theta0))
    assert update > 0 and diff <= UPDATE_SHARE * update, (diff, update)


def test_tp_first_step_gradients_match_jax(job):
    ranks, local = job
    got = {k[len("grad/"):]: v for k, v in ranks[0][1].items() if k.startswith("grad/")}
    want = local["grads"]
    assert set(got) == set(want)
    for name in want:
        gap, scale = np.linalg.norm(got[name] - want[name]), np.linalg.norm(want[name])
        assert gap <= GRAD_SHARE * scale, (name, gap, scale)


def test_tp_clip_norm_matches_optax(job):
    ranks, local = job
    for out, _ in ranks:
        assert out["norm"] == pytest.approx(local["norm"], rel=NORM_RTOL)
    assert local["norm"] > W.CLIP  # the clip scales this step's gradient


def test_fsdp_tp_step_matches_tp_step(job):
    ranks, local = job
    for out, _ in ranks:
        assert out["fsdp_loss"] == pytest.approx(out["loss"], rel=NORM_RTOL)
        assert out["fsdp_norm"] == pytest.approx(out["norm"], rel=NORM_RTOL)
    arrays, theta0 = ranks[0][1], local["theta0"]
    tp = {k[len("tp/"):]: v for k, v in arrays.items() if k.startswith("tp/")}
    fsdp = {k[len("fsdp/"):]: v for k, v in arrays.items() if k.startswith("fsdp/")}
    assert set(fsdp) == set(tp)
    diff = np.sqrt(sum(np.sum((fsdp[n] - tp[n]) ** 2) for n in theta0))
    update = np.sqrt(sum(np.sum((tp[n] - theta0[n]) ** 2) for n in theta0))
    assert update > 0 and diff <= UPDATE_SHARE * update, (diff, update)


def _fake_local(named, model_size):
    """Tensors of a TP rank's part shapes (the split dim divided)."""
    split = tensor_parallel_shardings(named)
    out = {}
    for name, tensor in named.items():
        shape = list(tensor.shape)
        if split[name] is not None:
            shape[split[name]] //= model_size
        out[name] = torch.empty(shape)
    return out


def test_fsdp_layout_composes_with_tp_as_jax_s():
    port = W.tiny_clip(0)
    optimizer = S.make_optimizer(W.LR, fused=True)
    state = S.init_train_state(port, optimizer)
    named = _fake_local(state.named_parameters(), 2)
    layout = fsdp_layout(named, 4, model_size=2)

    tree = params_to_jax(port.model.state_dict(), port.config)
    jax_state_tree = jax_state.init_train_state(tree, jax_state.make_optimizer(W.LR, fused=True))
    mesh = create_mesh(np.asarray(jax.devices()).reshape(4, 2), axis_names=("data", "model"))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): s for path, s in
            jax.tree_util.tree_leaves_with_path(jax_fsdp_shardings(jax_state_tree, mesh).params)}
    both = []
    for name in named:
        spec = flat[jax_param_path(name)].spec
        data_dims = _jax_dims(spec, "data")
        split = layout[name]
        assert (split.jax_dim if split else None) == (data_dims[0] if data_dims else None), name
        if split and _jax_dims(spec, "model"):
            both.append(name)
    assert any(n.endswith("attn.in_proj.weight") for n in both)


def test_fsdp_composes_with_tensor_parallel(job):
    ranks, _ = job
    for out, _ in ranks:
        assert any(n.endswith("attn.in_proj.weight") for n in out["fsdp_both"])
        assert np.isfinite(out["fsdp_loss"]) and out["fsdp_step"] == 1
        for name in out["fsdp_both"]:  # split on both axes: a quarter of the leaf each
            whole = np.prod([s for s in dict(W.tiny_clip(0).model.named_parameters())[
                name[len("encoder."):]].shape])
            assert np.prod(out["fsdp_part_shapes"][name]) * 4 == whole, name
    assert ranks[0][0]["fsdp_loss"] == pytest.approx(ranks[0][0]["loss"], rel=1e-4)


def test_head_aligned_qkv_split_sums_to_the_whole_attention():
    """Each of two ranks takes its heads of Q, K and V (``qkv_part``); its
    attention over them and its columns of out_proj give a partial sum; the
    two partial sums plus the bias once are the whole block's attention. A
    contiguous split of the packed (3W) width is not."""
    torch.manual_seed(0)
    model = init_float_params(CLIPModel(CLIPConfig.tiny_test()), 0)
    attn = model.visual.transformer.blocks[0].attn
    with torch.no_grad():
        attn.in_proj.bias.normal_()
        attn.out_proj.bias.normal_()
    x = torch.randn(2, 5, 48)
    with torch.no_grad():
        whole = attn(x)
        heads, size = attn.heads, 2

        def partial(w_in, b_in, rank):
            qkv = x @ w_in.T + b_in
            out = _einsum_attention(qkv, heads // size, False)
            return out @ attn.out_proj.weight.chunk(size, 1)[rank].T

        aligned = sum(partial(qkv_part(attn.in_proj.weight, r, size),
                              qkv_part(attn.in_proj.bias, r, size), r) for r in range(size))
        np.testing.assert_allclose((aligned + attn.out_proj.bias).numpy(), whole.numpy(),
                                   rtol=1e-5, atol=1e-6)
        slab = sum(partial(attn.in_proj.weight.chunk(size, 0)[r],
                           attn.in_proj.bias.chunk(size, 0)[r], r) for r in range(size))
        assert not np.allclose((slab + attn.out_proj.bias).numpy(), whole.numpy(), atol=1e-3)
        for name in ("attn.in_proj.weight", "attn.in_proj.bias", "mlp_fc.weight"):
            tensor = model.visual.transformer.blocks[0].get_parameter(name)
            parts = [tensor_parallel_part(name, tensor, 0, r, size) for r in range(size)]
            assert torch.equal(tensor_parallel_whole(name, parts, 0), tensor)


def _grid(model_size):
    return Grid(1, model_size, 0, 0, None, None, (0,), tuple(range(model_size)))


def test_divisibility_errors():
    with pytest.raises(ValueError, match="4 attention heads are not divisible by the model "
                                         "size 3"):
        shard_params(CLIPModel(CLIPConfig.tiny_test()), _grid(3))
    with pytest.raises(ValueError, match="vocabulary of 65 is not divisible by the model size 2"):
        shard_params(CLIPModel(CLIPConfig.tiny_test(vocab_size=65)), _grid(2))


def test_fused_paths_are_refused():
    with pytest.raises(ValueError, match="fused int8 layer K1"):
        shard_params(CLIPModel(CLIPConfig.tiny_test(), quantized=True), _grid(2))
    encoder = types.SimpleNamespace(model=CLIPModel(CLIPConfig.tiny_test()), fused_block=True)
    with pytest.raises(ValueError, match="fused bf16 layer K2"):
        shard_params(encoder, _grid(2))
