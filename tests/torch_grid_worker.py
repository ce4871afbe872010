"""One rank of a four-rank job of tests/test_torch_tensor_parallel.py or
tests/test_torch_pipeline.py (gloo over loopback, on the CPU):
``python -m tests.torch_grid_worker JOB RANK PLAN.json`` with JOB ``tp`` or
``pipeline``.

The rank joins a process group of four, runs the job's checks and writes what
it saw to ``{job}{rank}.json`` and ``{job}{rank}.npz`` in the plan's ``out``
directory; the test process holds those against the JAX package. The seeded
inputs are built by the functions below, which the test processes import
too. This module imports the port, numpy and the standard library, never JAX.
"""

import json
import os
import sys

import numpy as np

RANKS = 4
FRAMES = 2
GLOBAL_ROWS = 8
LR = 1e-3
CLIP = 0.5  # the TP step's global-norm clip
PIPE_LAYERS, PIPE_DIM, PIPE_BATCH, MICROBATCHES = 8, 16, 8, 4
BLOCK_WIDTH, BLOCK_HEADS, BLOCK_LAYERS = 32, 4, 8


def contrastive_batch():
    """One global batch of the tiny CLIP: GLOBAL_ROWS clips and token rows."""
    rng = np.random.default_rng(0)
    return {"video": rng.integers(0, 256, size=(GLOBAL_ROWS, FRAMES, 32, 32, 3), dtype=np.uint8),
            "text": rng.integers(1, 64, size=(GLOBAL_ROWS, 16)).astype(np.int32)}


def tiny_clip(seed: int = 0):
    from fitclip_torch.models.clip.load import load_tiny_test_encoder

    return load_tiny_test_encoder(num_frames=FRAMES, seed=seed, device="cpu").encoder


def toy_params(seed: int, layers: int, dim: int):
    """tests/test_pipeline.py:_toy_params."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(layers, dim, dim)).astype(np.float32) / np.sqrt(dim),
            "b": rng.normal(size=(layers, dim)).astype(np.float32) * 0.1}


def toy_inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    params = toy_params(seed, PIPE_LAYERS, PIPE_DIM)
    x = rng.normal(size=(PIPE_BATCH, PIPE_DIM)).astype(np.float32)
    target = rng.normal(size=(PIPE_BATCH, PIPE_DIM)).astype(np.float32)
    return params, x, target


def block_model():
    """A CLIP whose vision tower has BLOCK_LAYERS blocks of width BLOCK_WIDTH
    and BLOCK_HEADS heads (tests/test_pipeline.py's real blocks), seeded."""
    from fitclip_torch.models.clip.model import (CLIPConfig, CLIPModel, TextConfig,
                                                 VisionConfig, init_float_params)

    config = CLIPConfig(embed_dim=16,
                        vision=VisionConfig(image_size=32, patch_size=16, width=BLOCK_WIDTH,
                                            layers=BLOCK_LAYERS, heads=BLOCK_HEADS),
                        text=TextConfig(context_length=8, vocab_size=16, width=16, layers=1,
                                        heads=2))
    return init_float_params(CLIPModel(config), 3)


def block_input():
    return np.random.default_rng(2).normal(size=(8, 5, BLOCK_WIDTH)).astype(np.float32)


def toy_layers(params):
    """The toy tower's layers as modules, h -> tanh(h @ w + b)."""
    import torch
    from torch import nn

    class Toy(nn.Module):
        def __init__(self, w, b):
            super().__init__()
            self.w = nn.Parameter(torch.tensor(w, dtype=torch.float32))  # as JAX takes it
            self.b = nn.Parameter(torch.tensor(b, dtype=torch.float32))

        def forward(self, h):
            return torch.tanh(h @ self.w + self.b)

    return [Toy(params["w"][i], params["b"][i]) for i in range(len(params["w"]))]


def recording_clip(optimizer, names):
    """Wrap ``optimizer``'s global-norm clip so that it keeps what the first
    step hands it: {"grads": {name: the fp32 gradient, after the data
    average}, "norm": the clip's global norm}. ``names``: the trainable state
    parameters in the state's order (as ``AdamW.apply`` lists them)."""
    import torch

    seen, clip = {}, optimizer._clip

    def recording(grads, norm=None):
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if not seen:
            seen.update(grads={n: g.detach().clone() for n, g in zip(names, grads)},
                        norm=float(norm))
        return clip(grads, norm)

    optimizer._clip = recording
    return seen


def _trainable(state, optimizer):
    return [n for n in state.named_parameters() if optimizer.trainable(n)]


def tp_job(rank: int, out: dict, arrays: dict) -> None:
    import torch

    from fitclip_torch.parallel.mesh import create_grid
    from fitclip_torch.parallel.sharding_rules import (gathered_params, shard_params,
                                                       shard_train_state)
    from fitclip_torch.training import state as S
    from fitclip_torch.training import steps as T

    grid = create_grid(2, 2)
    out["grid"] = [grid.data, grid.model, grid.data_index, grid.model_index,
                   list(grid.data_ranks), list(grid.model_ranks)]
    batch = contrastive_batch()
    rows = slice(grid.data_index * GLOBAL_ROWS // 2, (grid.data_index + 1) * GLOBAL_ROWS // 2)
    local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}

    encoder = tiny_clip(0)
    layout = shard_params(encoder, grid)
    out["split"] = {n: d for n, d in layout.items() if d is not None}
    out["shapes"] = {n: list(p.shape) for n, p in encoder.model.named_parameters()}
    optimizer = S.make_optimizer(LR, gradient_clip_val=CLIP)
    state = S.init_train_state(encoder, optimizer)
    seen = recording_clip(optimizer, _trainable(state, optimizer))
    state, metrics = T.make_contrastive_train_step(encoder, optimizer)(state, local)
    out["loss"], out["norm"] = float(metrics["loss/train"]), seen["norm"]
    whole = gathered_params(encoder.model)
    grads = gathered_params(encoder.model, {n[len("encoder."):]: g for n, g in
                                            seen["grads"].items() if n.startswith("encoder.")})
    if rank == 0:
        arrays.update({f"tp/{n}": t.numpy() for n, t in whole.items()})
        arrays["tp/logit_scale"] = state.params["logit_scale"].detach().numpy()
        arrays.update({f"grad/encoder.{n}": g.numpy() for n, g in grads.items()})
        arrays["grad/logit_scale"] = seen["grads"]["logit_scale"].numpy()

    # FSDP over the data group on top: the Megatron + ZeRO 2-D layout, the
    # same step as above.
    encoder = tiny_clip(0)
    shard_params(encoder, grid)
    optimizer = S.make_optimizer(LR, gradient_clip_val=CLIP)
    state = shard_train_state(S.init_train_state(encoder, optimizer), optimizer, grid=grid)
    seen = recording_clip(optimizer, _trainable(state, optimizer))
    out["fsdp_both"] = sorted(n for n in state.fsdp.layout if n in state.fsdp.tp)
    out["fsdp_layout"] = {n: s.dim for n, s in state.fsdp.layout.items()}
    out["fsdp_part_shapes"] = {n: list(t.shape) for n, t in state.fsdp.parts.items()}
    state, metrics = T.make_contrastive_train_step(encoder, optimizer)(state, local)
    out["fsdp_loss"], out["fsdp_step"] = float(metrics["loss/train"]), int(state.step)
    out["fsdp_norm"] = seen["norm"]
    state.fsdp.unshard(state)
    whole = gathered_params(encoder.model)
    if rank == 0:
        arrays.update({f"fsdp/{n}": t.numpy() for n, t in whole.items()})
        arrays["fsdp/logit_scale"] = state.params["logit_scale"].detach().numpy()


def pipeline_job(rank: int, out: dict, arrays: dict) -> None:
    import torch

    from fitclip_torch.parallel.pipeline import pipeline_apply, stage_layers

    # The toy tower: tanh(h @ w + b) per layer, its forward and its gradients.
    params, x_np, target_np = toy_inputs()
    local = stage_layers(toy_layers(params), rank, RANKS)
    per = PIPE_LAYERS // RANKS
    x = torch.tensor(x_np, requires_grad=True)
    got = pipeline_apply(lambda layer, h: layer(h), local, x, MICROBATCHES)
    arrays["toy/forward"] = got.detach().numpy()
    # Every stage computes the loss: each back-propagates its 1/S share.
    loss = torch.sum((got - torch.from_numpy(target_np)) ** 2) / RANKS
    wanted = ([x] if rank == 0 else []) + [p for layer in local for p in (layer.w, layer.b)]
    grads = torch.autograd.grad(loss, wanted)
    if rank == 0:
        arrays["toy/x"], grads = grads[0].numpy(), grads[1:]
    for j in range(per):
        arrays[f"toy/w{rank * per + j}"] = grads[2 * j].numpy()
        arrays[f"toy/b{rank * per + j}"] = grads[2 * j + 1].numpy()
    out["toy_layers"] = len(local)

    # Real CLIP blocks: only this stage's weights stay.
    model = block_model()
    blocks = stage_layers(model.visual.transformer.blocks, rank, RANKS)
    del model
    out["stage_blocks"] = len(blocks)
    h = torch.from_numpy(block_input())
    got = pipeline_apply(lambda block, v: block(v), blocks, h, MICROBATCHES)
    arrays["blocks/forward"] = got.detach().numpy()
    loss = got.square().sum() / RANKS
    grads = torch.autograd.grad(loss, list(blocks.parameters()))
    for (name, _), g in zip(blocks.named_parameters(), grads):
        layer, rest = name.split(".", 1)
        arrays[f"blocks/{rank * len(blocks) + int(layer)}.{rest}"] = g.numpy()


def main(job: str, rank: int, plan_path: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(plan_path) as file:
        plan = json.load(file)
    dist.init_process_group("gloo", init_method=f"tcp://{plan['address']}", world_size=RANKS,
                            rank=rank)
    out, arrays = {"rank": rank}, {}
    {"tp": tp_job, "pipeline": pipeline_job}[job](rank, out, arrays)
    dist.barrier()
    dist.destroy_process_group()
    np.savez(os.path.join(plan["out"], f"{job}{rank}.npz"), **arrays)
    with open(os.path.join(plan["out"], f"{job}{rank}.json"), "w") as file:
        json.dump(out, file)


def start(job: str, root, timeout_s: float):
    """Start the four ranks of ``job``; returns (the processes, the plan)."""
    import socket
    import subprocess
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    plan = {"address": f"127.0.0.1:{port}", "out": str(root / "out"), "timeout_s": timeout_s}
    Path(plan["out"]).mkdir(parents=True, exist_ok=True)
    (root / "plan.json").write_text(json.dumps(plan))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=str(repo), GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONDONTWRITEBYTECODE="1")
    return [subprocess.Popen([sys.executable, "-m", "tests.torch_grid_worker", job, str(rank),
                              str(root / "plan.json")], cwd=repo, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(RANKS)], plan


def collect(job: str, procs, plan, started: float):
    """Wait for the ranks (within the plan's timeout from ``started``) and
    return [(json, arrays)] per rank; raise with a failed rank's output."""
    import time
    from pathlib import Path

    try:
        outs = [p.communicate(timeout=max(1.0, plan["timeout_s"] - (time.monotonic() - started)))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (stdout, stderr) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"rank failed:\n{stdout}\n{stderr[-6000:]}")
    ranks = []
    for rank in range(RANKS):
        with np.load(Path(plan["out"]) / f"{job}{rank}.npz") as arrays:
            ranks.append((json.loads((Path(plan["out"]) / f"{job}{rank}.json").read_text()),
                          dict(arrays)))
    return ranks


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
