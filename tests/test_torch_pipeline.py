"""The port's GPipe pipeline (fitclip_torch/parallel/pipeline.py) against the
JAX package's (fitclip_tpu/parallel/pipeline.py), on the CPU: the cases of
tests/test_pipeline.py.

One module-scoped job starts four ranks (``tests/torch_grid_worker.py
pipeline``, gloo over loopback, one thread each) while this process runs the
JAX side:

- the toy tower (8 tanh layers over 4 stages, 4 microbatches): the forward
  within 1e-6 of JAX's sequential scan; every stage's weight gradients and
  stage 0's input gradient within rtol 1e-5 / atol 1e-6 of the port's
  sequential tower's, and within 1e-5 relative L2 of ``jax.grad`` of JAX's
  (each stage back-propagates its 1/S share of the loss it computes);
- real CLIP blocks (width 32, 8 layers, 4 heads) over 4 stages, each stage
  holding its 2 blocks only: within 2e-5 of JAX's ``Transformer`` on the
  same parameters, and the weight gradients within 1e-5 (relative L2) of the
  port's sequential tower's;
- the divisibility errors say "not divisible", as JAX's do.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.models.clip.model import Transformer as JaxTransformer
from fitclip_torch.convert.from_jax import params_to_jax
from fitclip_torch.parallel.pipeline import pipeline_apply, stage_layers

from tests import torch_grid_worker as W
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

WORKER_TIMEOUT_S = 120


def _toy_sequential(params, x):
    def body(c, lp):
        return jnp.tanh(c @ lp["w"] + lp["b"]), None
    return jax.lax.scan(body, x, params)[0]


def _jax_side():
    out = {}
    params, x, target = W.toy_inputs()
    out["toy_forward"] = np.asarray(_toy_sequential(params, jnp.asarray(x)))

    def loss(p, v):
        return jnp.sum((_toy_sequential(p, v) - target) ** 2)

    out["toy_grads"] = jax.tree_util.tree_map(np.asarray, jax.grad(loss, argnums=(0, 1))(
        params, jnp.asarray(x)))
    # The port's sequential tower on the same layers, and its gradients.
    layers = W.toy_layers(params)
    v = torch.tensor(x, requires_grad=True)
    h = v
    for layer in layers:
        h = layer(h)
    grads = torch.autograd.grad(torch.sum((h - torch.from_numpy(target)) ** 2),
                                [v] + [p for layer in layers for p in (layer.w, layer.b)])
    out["toy_port_grads"] = ({"w": np.stack([g.numpy() for g in grads[1::2]]),
                              "b": np.stack([g.numpy() for g in grads[2::2]])},
                             grads[0].numpy())

    model = W.block_model()
    tree = params_to_jax(model.state_dict(), model.config)
    transformer = JaxTransformer(width=W.BLOCK_WIDTH, layers=W.BLOCK_LAYERS, heads=W.BLOCK_HEADS,
                                 causal=False, quick_gelu=True, dtype=jnp.float32)
    out["blocks_forward"] = np.asarray(transformer.apply(
        {"params": {"blocks": tree["visual"]["transformer"]["blocks"]}},
        jnp.asarray(W.block_input())))

    # The port's sequential tower and its weight gradients.
    h = torch.from_numpy(W.block_input())
    for block in model.visual.transformer.blocks:
        h = block(h)
    blocks = model.visual.transformer.blocks
    grads = torch.autograd.grad(h.square().sum(), list(blocks.parameters()))
    out["blocks_grads"] = {name: g.numpy() for (name, _), g in
                           zip(blocks.named_parameters(), grads)}
    out["blocks_sequential"] = h.detach().numpy()
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    started = time.monotonic()
    procs, plan = W.start("pipeline", tmp_path_factory.mktemp("pipeline"), WORKER_TIMEOUT_S)
    try:
        local = _jax_side()
    finally:
        ranks = W.collect("pipeline", procs, plan, started)
    return ranks, local


def test_pipeline_forward_matches_sequential(job):
    ranks, local = job
    for out, arrays in ranks:  # the output is replicated on every stage
        np.testing.assert_allclose(arrays["toy/forward"], local["toy_forward"],
                                   rtol=1e-6, atol=1e-6)


def _toy_gradients(ranks):
    """(the weight gradients stacked as JAX's tree, stage 0's input gradient)."""
    per = W.PIPE_LAYERS // W.RANKS
    for out, _ in ranks:
        assert out["toy_layers"] == per
    merged = {k: v for _, arrays in ranks for k, v in arrays.items()}
    return ({key: np.stack([merged[f"toy/{key}{i}"] for i in range(W.PIPE_LAYERS)])
             for key in ("w", "b")}, ranks[0][1]["toy/x"])


def test_pipeline_gradients_match_sequential(job):
    """Against the port's sequential tower at tests/test_pipeline.py's bound."""
    (got_params, got_x), (want_params, want_x) = _toy_gradients(job[0]), job[1]["toy_port_grads"]
    np.testing.assert_allclose(got_x, want_x, rtol=1e-5, atol=1e-6)
    for key in ("w", "b"):
        np.testing.assert_allclose(got_params[key], want_params[key], rtol=1e-5, atol=1e-6)


def test_pipeline_gradients_match_jax(job):
    """Against ``jax.grad`` of JAX's sequential scan, each leaf within 1e-5
    relative L2: torch and XLA sum the fp32 products in other orders (an
    element near zero parts by ~1e-6 even for the sequential towers)."""
    (got_params, got_x), (want_params, want_x) = _toy_gradients(job[0]), job[1]["toy_grads"]
    for got, want in ((got_x, want_x), (got_params["w"], want_params["w"]),
                      (got_params["b"], want_params["b"])):
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_pipeline_runs_real_clip_blocks(job):
    """Each stage holds L/S blocks, the output is within 2e-5 of JAX's tower,
    and the weight gradients are the sequential tower's."""
    ranks, local = job
    for out, arrays in ranks:
        assert out["stage_blocks"] == W.BLOCK_LAYERS // W.RANKS
        np.testing.assert_allclose(arrays["blocks/forward"], local["blocks_forward"],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(arrays["blocks/forward"], local["blocks_sequential"],
                                   rtol=2e-5, atol=2e-5)
    got = {k[len("blocks/"):]: v for _, arrays in ranks for k, v in arrays.items()
           if k.startswith("blocks/") and k != "blocks/forward"}
    assert set(got) == set(local["blocks_grads"])
    for name, want in local["blocks_grads"].items():
        assert np.linalg.norm(got[name] - want) <= 1e-5 * max(np.linalg.norm(want), 1e-12), name


def test_pipeline_validates_divisibility():
    with pytest.raises(ValueError, match="not divisible"):
        stage_layers([torch.nn.Identity() for _ in range(6)], 0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply(lambda layer, h: layer(h), [torch.nn.Identity()], torch.zeros(6, 8), 4)
