"""The port's distribution (fitclip_torch/parallel, and the steps, loaders,
trainer, runners and CLI under a process group) against the JAX package's
global-batch programs, on the CPU.

One module-scoped job starts two ranks (``tests/torch_parallel_worker.py``,
gloo over loopback, one thread each, each with its own timeout) that run
every two-rank check and write what they saw; meanwhile this process runs the
JAX side (the conftest's 8-device CPU mesh) and the port on one process. Each
test below reads one part:

- (a) the loaders' blocks through the data modules, against JAX's
  ``DataLoader`` and ``MixedBatchLoader`` with ``process_index`` and
  ``process_count``: disjoint, covering, the same plan;
- (b) ``pad_batch_to_divisible`` bit for bit against JAX's;
- (c) the contrastive step (3 steps, the global-norm clip on): the losses
  against JAX's ``make_contrastive_train_step`` on the global batch sharded
  over the mesh at rel 1e-4 (tests/test_sharded_steps.py:45), and against the
  port's one-process step on the same global batch at rel 1e-5, the
  parameters at rtol 1e-3 / atol 3e-3 (tests/test_fsdp.py:92-99: AdamW divides
  each gradient by its own magnitude, so sums in another order move a
  near-zero gradient's step), the whole update within UPDATE_SHARE and the
  first step's averaged gradients within GRAD_RTOL (L2);
- (d) the teacher-student step the same way (tests/test_sharded_steps.py:67);
- (e) a CLIP ResNet student's step: the loss at rel 1e-5 and the EMA'd
  running statistics of the synced batch statistics at 2e-4 (the ResNet
  tests' bound) against JAX's global-batch step; two steps against the
  port's one-process steps as in (c), which holds the synced statistics'
  backward;
- (f) the FSDP layout against JAX's ``fsdp_shardings`` on a 2-device mesh,
  and each rank's half of every split parameter and moment;
- (g) the FSDP step against the replicated two-rank step (losses rel 1e-5,
  parameters at rtol 1e-3 / atol 3e-3 and the update within UPDATE_SHARE);
- (h) ``command=evaluate`` and ``predict`` of an int8 tiny CLIP, calibrated
  on one batch of 8, over 11 videos (the last batch of 3 pads a row):
  metrics equal to the one-process CLI's, the same scales on both ranks,
  embeddings at the int8 bound (atol / rtol 2e-3, tests/test_torch_fast_eval.py)
  against JAX's ``run_predict`` with those scales;
- (i) ``command=train`` writes ``metrics.jsonl`` and ``last`` once;
- (j) a two-rank resume through the CLI is bit for bit the straight run,
  and ``++trainer.fsdp=true`` through the CLI holds (g)'s bounds;
- (k) a ``++distributed`` whose init fails (the coordinator's port taken)
  raises before anything is built,
  and a global batch the ranks do not divide raises JAX's error text.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitclip_tpu.cli import runners as jax_runners
from fitclip_tpu.cli.main import DEFAULT_CONFIG_DIR
from fitclip_tpu.cli.main import instantiate_data_module as jax_instantiate_data_module
from fitclip_tpu.config_engine import compose as jax_compose
from fitclip_tpu.data.data_module_group import MixedBatchLoader as JaxMixedBatchLoader
from fitclip_tpu.data.loader import DataLoader as JaxDataLoader
from fitclip_tpu.models.clip import load as jax_load
from fitclip_tpu.models.clip.encoder import ClipVideoTextEncoder as JaxEncoder
from fitclip_tpu.models.clip.model import CLIPConfig as JaxConfig
from fitclip_tpu.models.clip.resnet_clip import ResNetClipVideoTextEncoder as JaxResNetEncoder
from fitclip_tpu.models.clip.tokenizer import write_tiny_test_vocab
from fitclip_tpu.ops.losses import nce_loss as jax_nce_loss
from fitclip_tpu.ops.quant import load_act_scales as jax_load_act_scales
from fitclip_tpu.parallel import create_mesh, replicated, shard_batch
from fitclip_tpu.parallel.mesh import pad_batch_to_divisible as jax_pad
from fitclip_tpu.parallel.multihost import process_local_rows as jax_process_local_rows
from fitclip_tpu.parallel.sharding_rules import fsdp_shardings
from fitclip_tpu.training import state as jax_state
from fitclip_tpu.training import steps as jax_steps
from fitclip_torch.cli import main as cli
from fitclip_torch.config_engine import compose
from fitclip_torch.convert.from_jax import params_to_jax
from fitclip_torch.data import video_reader
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, init_float_params
from fitclip_torch.parallel import multihost
from fitclip_torch.parallel.mesh import pad_batch_to_divisible
from fitclip_torch.parallel.sharding_rules import fsdp_layout
from fitclip_torch.training import state as S
from fitclip_torch.training.checkpointing import load_checkpoint
from fitclip_torch.training.state import jax_param_path

from tests import torch_parallel_worker as W
from tests.test_torch_cli import INT8_CONFIG, _msrvtt_tree
from tests.test_torch_cli import WORDS as EVAL_WORDS
from tests.test_torch_convert_state_dict import _save, openai_state_dict
from tests.test_torch_resnet import _jax_config, _run, _tree
from tests.test_torch_resnet import port_tiny as port_tiny_resnet
from tests.test_torch_train_cli import CONTRASTIVE, _port_encoder, write_trees
from tests.test_torch_train_cli import WORDS as TRAIN_WORDS

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 120
RANKS = 2
INT8_BOUND = 2e-3
FSDP_RTOL, FSDP_ATOL = 1e-3, 3e-3
# The update's and the gradient's relative L2 bounds against the one-process
# step. Sums in another order leave them near 1e-6 (the ResNet's update, whose
# BatchNorm statistics are summed over the ranks, 5e-4; a ResNet attention
# pool's gradient 1.3e-4). Dropping the synced BatchNorm's backward all-reduce
# or the gradient average moves the update by 6e-2 or more. Dropping the
# gather's backward sum scales the encoder's gradient by 1/N, which AdamW's
# update hardly sees (7e-4 at most) and the gradient gate does (an error of 1/2).
UPDATE_SHARE, GRAD_RTOL = 1e-2, 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plan(root: Path):
    """The trees, the vocabulary, the int8 checkpoint and the CLI argv lists."""
    env = write_trees(root / "trees")
    env["MSRVTT_PATH"] = _msrvtt_tree(root / "msrvtt11", 11)
    (root / "vocab").mkdir()
    merges, vocab = write_tiny_test_vocab(str(root / "vocab"),
                                          list(dict.fromkeys(EVAL_WORDS + TRAIN_WORDS)))
    checkpoint = _save(root / "clip.pt", openai_state_dict(INT8_CONFIG, seed=11))
    work = root / "work"
    work.mkdir()
    eval_common = ["encoder=clip_vit_b_16", "++encoder.dtype=int8", "++encoder.device=cpu",
                   "++encoder.fused_attention=true", "++encoder.fused_block=true",
                   f"+encoder.checkpoint_path={checkpoint}", f"+encoder.bpe_path={merges}",
                   f"++quant.scales_path={work / 'scales.npz'}", "data=msrvtt",
                   "data.eval_batch_size=8", "+data.num_threads=2",
                   "++quant.calibration_batches=1"]

    def train(name, *extra):
        d = work / name
        return [*CONTRASTIVE, *_port_encoder((merges, vocab)), "data.batch_size=4",
                "+data.num_threads=1", "trainer.max_epochs=2", "optimizer.lr=1e-3",
                "trainer.log_every_n_steps=1", "trainer.val_check_interval=1.0",
                f"+log_dir={d}/logs", f"trainer.callbacks.checkpoint.dirpath={d}/ckpt",
                "trainer.callbacks.checkpoint.every_n_epochs=0", *extra]

    return {"address": f"127.0.0.1:{_free_port()}", "out": str(root / "out"), "env": env,
            "merges": merges, "vocab": vocab, "checkpoint": checkpoint, "work": str(work),
            "evaluate": ["command=evaluate", *eval_common],
            "predict": ["command=predict", *eval_common,
                        f"+output_path={work / 'predictions.pt'}"],
            "train": [train("straight"), train("resumed", "+trainer.max_steps=1"),
                      train("resumed", "+trainer.max_steps=4",
                            f"+checkpoint_path={work / 'resumed' / 'ckpt' / 'last'}"),
                      train("fsdp", "++trainer.fsdp=true")],
            "eval_common": eval_common}


def _start_ranks(plan, plan_path):
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=str(REPO), GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONDONTWRITEBYTECODE="1")
    return [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", str(rank),
                              str(plan_path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for rank in range(RANKS)]


def _compiled(fn, *args):
    """fn jitted for args' shapes and shardings, compiled at XLA's backend
    optimization level 0 (compiling is this tiny reference's whole cost)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _numpy_losses(metrics_list):
    return [{k: float(v) for k, v in m.items()} for m in metrics_list]


def _jax_side(plan):
    """Everything this process computes: JAX's global-batch steps, the port on
    one process, JAX's FSDP shardings, the one-process CLI and JAX's predict."""
    out = {}
    cfg = CLIPConfig.tiny_test()
    seeded = [params_to_jax(init_float_params(CLIPModel(cfg), s).state_dict(), cfg)
              for s in (0, 1)]
    mesh = create_mesh()
    student = JaxEncoder(JaxConfig.tiny_test(), num_frames=W.FRAMES)

    # (c) the contrastive step, sharded over the 8-device mesh; the port on one process.
    optimizer = jax_state.make_optimizer(W.LR, fused=True, gradient_clip_val=W.CLIP)
    state = jax.device_put(jax_state.init_train_state(seeded[0], optimizer), replicated(mesh))
    batches = [shard_batch(batch, mesh) for batch in W.contrastive_batches()]
    step = _compiled(jax_steps.make_contrastive_train_step(student, optimizer), state,
                     batches[0])
    losses = []
    for batch in batches:
        state, metrics = step(state, batch)
        losses.append(metrics)
    out["jax_contrastive"] = _numpy_losses(losses)

    # (d) the teacher-student step the same way.
    optimizer = jax_state.make_optimizer(W.LR, fused=True)
    state = jax.device_put(jax_state.init_train_state(seeded[0], optimizer,
                                                      with_teacher_student_scale=True),
                           replicated(mesh))
    teacher = jax.device_put(jax.tree_util.tree_map(jnp.asarray, seeded[1]), replicated(mesh))
    batches = [shard_batch(batch, mesh) for batch in W.teacher_student_batches()]
    step = _compiled(jax_steps.make_teacher_student_train_step(student, student, optimizer,
                                                               labeled_loss_share=0.7),
                     state, teacher, batches[0])
    losses = []
    for batch in batches:
        state, metrics = step(state, teacher, batch)
        losses.append(metrics)
    out["jax_teacher_student"] = _numpy_losses(losses)

    # (e) the tiny ResNet's global-batch step in JAX: its forward, which gives
    # the step's loss and the running statistics' EMA (the backward moves neither).
    video, ids = W.resnet_inputs()
    port = port_tiny_resnet()
    encoder = JaxResNetEncoder(_jax_config(port.encoder.config), num_frames=W.FRAMES)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(port.encoder))
    logit_scale = jax_state.init_train_state(params, jax_state.make_optimizer(
        W.RN_LR)).params["logit_scale"]

    def forward(params, logit_scale, video, ids):
        video_emb, updates = encoder.encode_video_train(params, video)
        scores = jnp.exp(logit_scale[0]) * jnp.matmul(
            video_emb, encoder.encode_text(params, ids).T, precision=jax.lax.Precision.HIGHEST)
        return jax_nce_loss(scores), encoder.apply_bn_updates(params, updates)

    out["jax_resnet"] = _run(forward, params, logit_scale, video, ids)

    # (f) JAX's FSDP shardings of the whole TrainState on a 2-device mesh.
    jax_train_state = jax_state.init_train_state(seeded[0], jax_state.make_optimizer(
        W.LR, fused=True))
    shardings = fsdp_shardings(jax_train_state, create_mesh(jax.devices()[:2]))
    out["jax_fsdp"] = {
        "/".join(str(getattr(k, "key", k)) for k in path):
            next((i for i, axis in enumerate(tuple(s.spec)) if axis == "data"), None)
        for path, s in jax.tree_util.tree_leaves_with_path(shardings.params)}

    # (h) the one-process CLI, then JAX's predict with the scales it wrote.
    work = Path(plan["work"]) / "one"
    work.mkdir()
    common = [a.replace(str(Path(plan["work"]) / "scales.npz"), str(work / "scales.npz"))
              for a in plan["eval_common"]]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli.main(["command=evaluate", *common])
    text = printed.getvalue()
    out["one_evaluate"] = json.loads(text[text.index("{"): text.rindex("}") + 1])
    cli.main(["command=predict", *common, f"+output_path={work / 'predictions.pt'}"])
    out["one_predictions"] = torch.load(str(work / "predictions.pt"), weights_only=False)
    loaded = jax_load.load_clip_encoder(checkpoint_path=plan["checkpoint"], dtype="int8",
                                        bpe_path=plan["merges"], fused_attention=True,
                                        fused_block=True)
    params = jax_load_act_scales(str(work / "scales.npz"), jax.device_get(loaded.params))
    data_cfg = jax_compose(DEFAULT_CONFIG_DIR, "trainer", [
        "command=predict", "encoder=clip_vit_b_16", "data=msrvtt", "data.eval_batch_size=8",
        "+data.num_threads=2"])["data"]
    jax_loaded = type(loaded)(encoder=loaded.encoder, params=params)
    out["jax_predictions"] = jax_runners.run_predict(
        jax_loaded, jax_instantiate_data_module(data_cfg, jax_loaded), output_path=None)
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(the plan, each rank's JSON and arrays, this process's results)."""
    root = tmp_path_factory.mktemp("parallel")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(video_reader, "_native_reader", lambda: None)
        plan = _plan(root)
        Path(plan["out"]).mkdir()
        plan_path = root / "plan.json"
        plan_path.write_text(json.dumps(plan))
        for key, value in plan["env"].items():
            mp.setenv(key, value)
        start = time.monotonic()
        procs = _start_ranks(plan, plan_path)
        try:
            local = _jax_side(plan)
            outs = [p.communicate(timeout=max(1.0, WORKER_TIMEOUT_S - (time.monotonic() - start)))
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{stdout}\n{stderr[-6000:]}"
    ranks = []
    for rank in range(RANKS):
        with np.load(Path(plan["out"]) / f"rank{rank}.npz") as arrays:
            ranks.append((json.loads((Path(plan["out"]) / f"rank{rank}.json").read_text()),
                          dict(arrays)))
    return plan, ranks, local


def _assert_losses(got, want, rtol):
    assert len(got) == len(want) == W.STEPS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, err_msg=key)


def _initial_params(kind: str):
    """The parameters the ``kind`` run ("clip", "teacher_student", "resnet") starts from."""
    if kind == "resnet":
        state = W.resnet_state()[2]
    else:
        state = S.init_train_state(W.tiny_clip(0), S.make_optimizer(W.LR, fused=True),
                                   with_teacher_student_scale=kind == "teacher_student")
    return {n: p.detach().numpy().copy() for n, p in state.named_parameters().items()}


def _prefixed(arrays, prefix):
    return {k[len(prefix) + 1:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def _without_key_bias(name: str, x: np.ndarray) -> np.ndarray:
    """``x`` in float64, the key bias zeroed: its gradient is zero in exact
    arithmetic (a softmax is unchanged when one number is added to all of a
    query's scores), so what autograd computes for it is rounding noise, which
    AdamW turns into steps of about ±lr. The gates on gradients and updates
    leave it out."""
    x = x.astype(np.float64)
    if name.endswith("in_proj.bias"):  # packed (q, k, v)
        x = x.copy()
        x[x.shape[0] // 3: 2 * x.shape[0] // 3] = 0
    return np.zeros_like(x) if name.endswith("k_proj.bias") else x


def _assert_params(got_arrays, prefix, want_arrays, want_prefix, kind):
    """Every parameter under ``prefix`` at the FSDP bound of ``want_prefix``'s,
    and the update from the ``kind`` run's start within UPDATE_SHARE of
    ``want_prefix``'s (the L2 norm over all parameters). AdamW moves each
    parameter by about lr a step, well inside the FSDP bound, so the update
    gate is the one a wrong update fails."""
    got, want = _prefixed(got_arrays, prefix), _prefixed(want_arrays, want_prefix)
    init = _initial_params(kind)
    assert sorted(got) == sorted(want) == sorted(init) and len(got) > 20
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=FSDP_RTOL, atol=FSDP_ATOL,
                                   err_msg=name)
    gap = np.sqrt(sum(np.sum((_without_key_bias(n, got[n]) - _without_key_bias(n, want[n]))
                             ** 2) for n in want))
    moved = np.sqrt(sum(np.sum((_without_key_bias(n, want[n]) - _without_key_bias(n, init[n]))
                               ** 2) for n in want))
    assert moved > 0 and gap <= UPDATE_SHARE * moved, (gap, moved)


def _assert_gradients(got_arrays, prefix, want_arrays, want_prefix):
    """The first step's gradients as AdamW receives them (averaged over the
    ranks under ``prefix``), each within GRAD_RTOL of ``want_prefix``'s in L2:
    the check on the gather's and the synced BatchNorm's factor of the rank
    count (parallel/collectives.py), which AdamW's update is blind to."""
    got, want = _prefixed(got_arrays, prefix), _prefixed(want_arrays, want_prefix)
    assert sorted(got) == sorted(want) and len(got) > 20
    for name, value in want.items():
        g, w = _without_key_bias(name, got[name]), _without_key_bias(name, value)
        assert np.linalg.norm(g - w) <= GRAD_RTOL * np.linalg.norm(w), name


def test_two_ranks_joined_one_group(job):
    _, ranks, _ = job
    assert [r[0]["rank"] for r in ranks] == [0, 1]
    assert all(r[0]["world"] == RANKS for r in ranks)
    assert [r[0]["main"] for r in ranks] == [True, False]


def test_loader_blocks_match_jax(job):
    """(a) Each rank's train loader (WebVid through its data module) and
    mixed-batch plan equal JAX's loaders given that rank; the blocks are
    disjoint and cover each global batch."""
    _, ranks, _ = job
    for rank, (out, _) in enumerate(ranks):
        info = out["loader"]
        assert info["process"] == [rank, RANKS]
        jax_loader = JaxDataLoader(list(range(info["length"])), batch_size=info["batch_size"],
                                   shuffle=True, drop_last=True, seed=info["seed"],
                                   process_index=rank, process_count=RANKS)
        for epoch, plan in enumerate(info["plans"]):
            jax_loader.set_epoch(epoch)
            assert plan == list(jax_loader._batches_of_indices())
        mixed = out["mixed"]
        assert mixed["process"] == [rank, RANKS]
        sources = {name: JaxDataLoader(list(range(info["length"])), batch_size=1)
                   for name in ("labeled", "unlabeled")}
        jax_mixed = JaxMixedBatchLoader(sources, {"labeled": 2, "unlabeled": 4},
                                        seed=mixed["seed"], process_index=rank,
                                        process_count=RANKS)
        for epoch, plan in enumerate(mixed["plans"]):
            jax_mixed.set_epoch(epoch)
            assert plan == jax_mixed._index_plan()
    for epoch in (0, 1):
        for b0, b1 in zip(ranks[0][0]["loader"]["plans"][epoch],
                          ranks[1][0]["loader"]["plans"][epoch]):
            assert len(b0) == len(b1) == 2 and not set(b0) & set(b1)
        covered = {i for r in ranks for b in r[0]["loader"]["plans"][epoch] for i in b}
        assert covered == set(range(ranks[0][0]["loader"]["length"]))
        for spec0, spec1 in zip(ranks[0][0]["mixed"]["plans"][epoch],
                                ranks[1][0]["mixed"]["plans"][epoch]):
            assert [len(spec0[k]) for k in ("labeled", "unlabeled")] == [1, 2]
            assert [len(spec1[k]) for k in ("labeled", "unlabeled")] == [1, 2]


@pytest.mark.parametrize("num_shards", [1, 2, 3, 8])
def test_pad_batch_matches_jax_bit_for_bit(num_shards):
    """(b) The padded tree (values and dtypes) and the valid count."""
    rng = np.random.default_rng(num_shards)
    batch = {"video": rng.integers(0, 256, (5, 2, 4, 4, 3), dtype=np.uint8),
             "text": rng.integers(1, 60, (5, 16)).astype(np.int32),
             "label": np.arange(5), "nested": {"x": rng.normal(size=(5, 3)).astype(np.float32)}}
    got, got_valid = pad_batch_to_divisible(batch, num_shards)
    want, want_valid = jax_pad(batch, num_shards)
    assert got_valid == want_valid == 5
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
        assert g.shape[0] % num_shards == 0


def test_contrastive_step_matches_jax_global_batch(job):
    """(c) Two ranks against JAX's sharded global-batch step (losses rel 1e-4)
    and the port's one-process step (losses rel 1e-5, parameters at the FSDP
    bound); both ranks hold the same parameters."""
    _, ranks, local = job
    out, arrays = ranks[0]
    _assert_losses(out["replicated_losses"], local["jax_contrastive"], rtol=1e-4)
    _assert_losses(out["replicated_losses"], out["one_contrastive_losses"], rtol=1e-5)
    _assert_params(arrays, "replicated", arrays, "one_contrastive", "clip")
    _assert_gradients(arrays, "grad_replicated", arrays, "grad_one_contrastive")
    other = ranks[1][1]
    assert all(np.array_equal(arrays[k], other[k]) for k in arrays if k.startswith("replicated/"))
    assert all(np.array_equal(arrays[k], other[k]) for k in arrays
               if k.startswith("teacher_student/"))


def test_teacher_student_step_matches_jax_global_batch(job):
    """(d) The same for the FitCLIP step (float teacher, labeled share 0.7)."""
    _, ranks, local = job
    out, arrays = ranks[0]
    _assert_losses(out["teacher_student_losses"], local["jax_teacher_student"], rtol=1e-4)
    one, one_arrays = ranks[1]
    _assert_losses(out["teacher_student_losses"], one["one_teacher_student_losses"], rtol=1e-5)
    _assert_params(arrays, "teacher_student", one_arrays, "one_teacher_student",
                   "teacher_student")
    _assert_gradients(arrays, "grad_teacher_student", one_arrays, "grad_one_teacher_student")


def test_resnet_student_syncs_batch_norm_over_ranks(job):
    """(e) A tiny CLIP ResNet's first step, 2 clips a rank: the loss against
    JAX's step on the 4 clips at rel 1e-5, and every running statistic (the
    EMA of the synced batch statistics) at 2e-4, equal on both ranks. JAX's
    side is its step's forward, which computes both. The backward through the
    synced statistics: two steps against the port's one-process steps on the
    same 4 clips, the losses at rel 1e-5 (the second reads the first's
    update) and the parameters after each as in (c)."""
    _, ranks, local = job
    jax_loss, jax_params = local["jax_resnet"]
    out, arrays = ranks[0]
    assert len(out["resnet_losses"]) == len(out["one_resnet_losses"]) == 2
    np.testing.assert_allclose(out["resnet_losses"][0]["loss/train"], float(jax_loss), rtol=1e-5)
    for got, want in zip(out["resnet_losses"], out["one_resnet_losses"]):
        np.testing.assert_allclose(got["loss/train"], want["loss/train"], rtol=1e-5)
    for prefix in ("resnet", "resnet2"):
        _assert_params(arrays, prefix, arrays, "one_" + prefix, "resnet")
    _assert_gradients(arrays, "grad_resnet", arrays, "grad_one_resnet")
    from fitclip_torch.convert.from_jax import resnet_clip_params_to_jax

    encoder = port_tiny_resnet().encoder
    prefix = "resnet/encoder."
    state = {k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items()
             if k.startswith(prefix)}
    got = resnet_clip_params_to_jax(state, encoder.config)
    want = jax.device_get(jax_params)
    checked = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        keys = [k.key for k in path]
        if keys[-1].startswith("running_"):
            value = got
            for key in keys:
                value = value[key]
            np.testing.assert_allclose(value, np.asarray(leaf), atol=2e-4, rtol=0,
                                       err_msg=str(keys))
            checked += 1
    assert checked == 2 * 19
    stats = [k for k in arrays if k.startswith(prefix) and "running_" in k]
    assert all(np.array_equal(arrays[k], ranks[1][1][k]) for k in stats)
    moved = [k for k in stats if not np.array_equal(
        arrays[k], encoder.model.state_dict()[k[len(prefix):]].numpy())]
    assert len(moved) == len(stats)


def test_fsdp_layout_matches_jax_fsdp_shardings(job):
    """(f) For 2 ranks, the leaves the port splits and their dims (read on
    JAX's layout) are fsdp_shardings' on a 2-device mesh; each rank holds half
    of every split parameter and of both its moments; logit_scale and the
    small leaves replicate."""
    _, ranks, local = job
    encoder = W.tiny_clip(0)
    state = S.init_train_state(encoder, S.make_optimizer(W.LR, fused=True))
    summary = {(split.jax_path if split else jax_param_path(name)):
               (split.jax_dim if split else None)
               for name, split in fsdp_layout(state.named_parameters(), RANKS).items()}
    assert summary == local["jax_fsdp"]
    assert sum(dim is not None for dim in summary.values()) >= 8
    assert summary["logit_scale"] is None
    for out, _ in ranks:
        parts = out["fsdp_parts"]
        assert {(p["jax_path"], p["jax_dim"]) for p in parts.values()} == {
            (path, dim) for path, dim in summary.items() if dim is not None}
        for name, p in parts.items():
            assert 2 * p["part"] == 2 * p["mu"] == 2 * p["nu"] == p["whole"], name
        assert "logit_scale" in out["fsdp_replicated"]
        split = sum(p["whole"] for p in parts.values()) * 4
        full = out["replicated_bytes"]
        assert out["fsdp_bytes"] == out["fsdp_bytes_after"] == {
            "params": full["params"] - split // 2, "moments": full["moments"] - split}


def test_fsdp_step_matches_the_replicated_step(job):
    """(g) Three FSDP steps (the clip's global norm summed over the ranks'
    parts) against the replicated two-rank steps."""
    _, ranks, _ = job
    out, arrays = ranks[0]
    _assert_losses(out["fsdp_losses"], out["replicated_losses"], rtol=1e-5)
    _assert_params(arrays, "fsdp", arrays, "replicated", "clip")


def test_evaluate_and_predict_are_data_parallel(job):
    """(h) Both ranks' metrics equal the one-process CLI's; only rank 0
    prints; both ranks calibrated to the same scales, the one-process run's;
    the predictions (11 rows, pad rows dropped) match the one-process CLI's
    and JAX's run_predict at the int8 bound."""
    plan, ranks, local = job
    assert ranks[0][0]["evaluate"] == ranks[1][0]["evaluate"] == local["one_evaluate"]
    printed = ranks[0][0]["printed"]
    assert json.loads(printed[printed.index("{"): printed.index("}") + 1]) == \
        local["one_evaluate"]
    assert "{" not in ranks[1][0]["printed"]
    out = Path(plan["out"])
    with np.load(out / "scales_rank0.npz") as s0, np.load(out / "scales_rank1.npz") as s1, \
            np.load(Path(plan["work"]) / "scales.npz") as written, \
            np.load(Path(plan["work"]) / "one" / "scales.npz") as one:
        assert sorted(s0.files) == sorted(s1.files) == sorted(one.files)
        for site in s0.files:
            assert np.array_equal(s0[site], s1[site]) and np.array_equal(s0[site], written[site])
            np.testing.assert_array_equal(s0[site], one[site], err_msg=site)
    got = torch.load(str(Path(plan["work"]) / "predictions.pt"), weights_only=False)
    one, ref = local["one_predictions"], local["jax_predictions"]
    assert got["video_ids"] == one["video_ids"] == list(ref["video_ids"])
    for key in ("encoded_videos", "encoded_texts"):
        assert got[key].shape == (11, 32)
        np.testing.assert_allclose(got[key].numpy(), one[key].numpy(), atol=INT8_BOUND,
                                   rtol=INT8_BOUND)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=INT8_BOUND,
                                   rtol=INT8_BOUND)


def _logged(workdir: Path):
    return [json.loads(line) for line in (workdir / "logs" / "metrics.jsonl").read_text()
            .splitlines()]


def test_train_logs_and_checkpoints_from_the_main_process_only(job):
    """(i) 4 steps (2 epochs of 2 global batches of 4) and two validations:
    one metrics.jsonl line each, not one per rank, and one ``last``."""
    plan, _, _ = job
    straight = Path(plan["work"]) / "straight"
    logged = _logged(straight)
    assert [e["step"] for e in logged] == [1, 2, 2, 3, 4, 4]
    assert "r1" in logged[2] and "loss/train" in logged[0]
    assert load_checkpoint(str(straight / "ckpt" / "last"))["step"] == 4
    assert not list((straight / "ckpt").glob("*.partial"))


def test_resume_and_fsdp_through_the_cli(job):
    """(j) 1 step, then ``+checkpoint_path=<last> +trainer.max_steps=4``,
    equals the straight 4 steps bit for bit; ``++trainer.fsdp=true`` logs the
    sharding on each rank and lands within the FSDP bound of the straight run."""
    plan, ranks, _ = job
    work = Path(plan["work"])
    straight = load_checkpoint(str(work / "straight" / "ckpt" / "last"))
    resumed = load_checkpoint(str(work / "resumed" / "ckpt" / "last"))
    assert resumed["step"] == straight["step"] == 4 and resumed["opt_state"]["count"] == 4
    for name, value in straight["params"].items():
        assert torch.equal(resumed["params"][name], value), name
        for key in ("mu", "nu"):
            assert torch.equal(resumed["opt_state"][key][name],
                               straight["opt_state"][key][name]), (key, name)
    sharded = load_checkpoint(str(work / "fsdp" / "ckpt" / "last"))
    assert sharded["step"] == 4
    for name, value in straight["params"].items():
        assert sharded["params"][name].shape == value.shape
        np.testing.assert_allclose(sharded["params"][name].numpy(), value.numpy(),
                                   rtol=FSDP_RTOL, atol=FSDP_ATOL, err_msg=name)
        assert sharded["opt_state"]["mu"][name].shape == straight["opt_state"]["mu"][name].shape
    for out, _ in ranks:
        assert "FSDP: TrainState sharded over data=2" in out["train_log"]


def test_a_failed_init_stops_the_run(monkeypatch):
    """(k) The coordinator (process 0), whose address is taken by another
    listener, raises from run() before any encoder or data module is built,
    and leaves no group behind."""
    built = []
    monkeypatch.setattr(cli, "instantiate_encoder_slot", lambda node: built.append(node))
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        cfg = compose(DEFAULT_CONFIG_DIR, "trainer", [
            "command=evaluate", "encoder=clip_vit_b_16", "data=msrvtt", "++encoder.device=cpu",
            f"++distributed.coordinator_address=127.0.0.1:{taken.getsockname()[1]}",
            "++distributed.num_processes=2", "++distributed.process_id=0"])
        with pytest.raises(RuntimeError, match="address already in use"):
            cli.run(cfg)
    assert not built and not torch.distributed.is_initialized()
    assert multihost.process_count() == 1


def test_a_global_batch_the_ranks_do_not_divide_raises_jax_text(job):
    """(k) The train loader's refusal and process_local_rows' are JAX's words."""
    _, ranks, _ = job
    with pytest.raises(ValueError) as jax_error:
        next(iter(JaxDataLoader(list(range(6)), batch_size=3, process_index=0,
                                process_count=2)._batches_of_indices()))
    assert all(out["odd_batch_error"] == str(jax_error.value) for out, _ in ranks)
    with pytest.raises(ValueError) as want:
        jax_process_local_rows(3, 0, 2)
    with pytest.raises(ValueError) as got:
        multihost.process_local_rows(3, 0, 2)
    assert str(got.value) == str(want.value)
