"""One rank of tests/test_torch_parallel.py's two-rank job (gloo over loopback,
on the CPU): ``python -m tests.torch_parallel_worker RANK PLAN.json``.

The rank joins the process group through ``maybe_initialize_distributed``,
runs every check of the job and writes what it saw to ``rank{R}.json`` and
``rank{R}.npz`` in the plan's ``out`` directory; the test process holds those
against the JAX package and the port on one process. The seeded inputs are
built by the functions below, which the test process imports too. This module
imports the port, numpy and the standard library, never JAX.
"""

import contextlib
import io
import json
import logging
import os
import sys

import numpy as np

LR = 1e-4
CLIP = 0.5  # the global-norm clip of the contrastive steps (replicated and FSDP)
FRAMES = 2
STEPS = 3
GLOBAL_ROWS = 8
RN_LR = 1e-3


def contrastive_batches():
    """STEPS global batches of GLOBAL_ROWS clips and token rows of the tiny CLIP."""
    rng = np.random.default_rng(1)
    return [{"video": rng.integers(0, 256, size=(GLOBAL_ROWS, FRAMES, 32, 32, 3),
                                   dtype=np.uint8),
             "text": rng.integers(1, 60, size=(GLOBAL_ROWS, 16)).astype(np.int32)}
            for _ in range(STEPS)]


def teacher_student_batches():
    """STEPS global {labeled, unlabeled} batches, GLOBAL_ROWS rows in each sub-batch."""
    rng = np.random.default_rng(2)

    def sub():
        return {key: (rng.integers(0, 256, size=(GLOBAL_ROWS, FRAMES, 32, 32, 3),
                                   dtype=np.uint8) if key.startswith("video")
                      else rng.integers(1, 60, size=(GLOBAL_ROWS, 16)).astype(np.int32))
                for key in ("video_student", "text_student", "video_teacher", "text_teacher")}

    return [{"labeled": sub(), "unlabeled": sub()} for _ in range(STEPS)]


def resnet_inputs(seed: int = 2, clips: int = 4):
    """tests/test_torch_resnet.py:_inputs: the tiny ResNet's clips and ids."""
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, (clips, FRAMES, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(1, 63, (clips, 16)).astype(np.int32)
    ids[np.arange(clips), rng.integers(4, 16, clips)] = 63  # the EOT: the row's largest id
    return video, ids


def seeded_batch_norms(encoder, seed: int = 7):
    """tests/test_torch_resnet.py:_seeded_batch_norms: BatchNorm affines and
    running statistics drawn from a seed, in place."""
    import torch

    from fitclip_torch.models.clip.resnet import BatchNorm

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


def tiny_clip(seed: int):
    from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
    from fitclip_torch.models.clip.model import CLIPConfig, init_float_params

    encoder = ClipVideoTextEncoder(CLIPConfig.tiny_test(), num_frames=FRAMES,
                                   fused_attention=True)
    init_float_params(encoder.model, seed)
    return encoder


def tensors(tree):
    import torch

    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return torch.from_numpy(tree).long() if tree.dtype == np.int32 else torch.from_numpy(tree)


def block(tree, rank: int, world: int):
    """This rank's contiguous rows of every leaf."""
    if isinstance(tree, dict):
        return {k: block(v, rank, world) for k, v in tree.items()}
    per = tree.shape[0] // world
    return tree[rank * per:(rank + 1) * per]


def run_steps(make_step, state, batches, rank: int, world: int):
    """The step over each batch's rank block: (losses, state)."""
    losses = []
    for batch in batches:
        state, metrics = make_step(state, tensors(block(batch, rank, world)))
        losses.append({k: float(v) for k, v in metrics.items()})
    return losses, state


def contrastive_steps(rank: int, world: int):
    """STEPS contrastive steps of the tiny CLIP (seed 0), clipped: (losses, state)."""
    from fitclip_torch.training import state as S
    from fitclip_torch.training import steps as T

    encoder = tiny_clip(0)
    optimizer = S.make_optimizer(LR, fused=True, gradient_clip_val=CLIP)
    return run_steps(T.make_contrastive_train_step(encoder, optimizer),
                     S.init_train_state(encoder, optimizer), contrastive_batches(), rank, world)


def teacher_student_steps(rank: int, world: int):
    """STEPS FitCLIP steps of the tiny CLIP (seed 0) under its seed-1 twin: (losses, state)."""
    from fitclip_torch.training import state as S
    from fitclip_torch.training import steps as T

    student, teacher = tiny_clip(0), tiny_clip(1)
    optimizer = S.make_optimizer(LR, fused=True)
    return run_steps(T.make_teacher_student_train_step(student, teacher, optimizer,
                                                       labeled_loss_share=0.7),
                     S.init_train_state(student, optimizer, with_teacher_student_scale=True),
                     teacher_student_batches(), rank, world)


def resnet_state():
    """The tiny CLIP ResNet (seed 0, BatchNorms seeded 7), its optimizer
    (BatchNorm affines frozen) and its train state: (encoder, optimizer, state)."""
    import torch

    from fitclip_torch.models.clip.load import load_tiny_rn_test_encoder
    from fitclip_torch.training import state as S

    encoder = load_tiny_rn_test_encoder(num_frames=FRAMES, seed=0, device="cpu").encoder
    seeded_batch_norms(encoder, seed=7)
    optimizer = S.make_optimizer(RN_LR, freeze_patterns=list(encoder.bn_freeze_patterns),
                                 params_example={"encoder": encoder,
                                                 "logit_scale": torch.zeros(1)},
                                 fused=True)
    return encoder, optimizer, S.init_train_state(encoder, optimizer)


def resnet_steps(rank: int, world: int, arrays: dict, prefix: str):
    """Two contrastive steps of the tiny CLIP ResNet over the rank's block of
    4 clips each (``resnet_inputs`` seeds 2 and 3): the losses; the parameters
    after each step go to ``arrays`` under ``prefix`` and ``prefix2``."""
    from fitclip_torch.training import steps as T

    encoder, optimizer, state = resnet_state()
    step = T.make_contrastive_train_step(encoder, optimizer)
    losses = []
    for name, seed in ((prefix, 2), (prefix + "2", 3)):
        video, ids = resnet_inputs(seed)
        more, state = run_steps(step, state, [{"video": video, "text": ids}], rank, world)
        losses += more
        _params(name, state, arrays)
    return losses


@contextlib.contextmanager
def first_gradients(arrays: dict, prefix: str):
    """The gradients of the first optimizer step inside, as the step hands them
    to AdamW (averaged over the ranks), go to ``arrays`` under ``prefix``."""
    from fitclip_torch.training import steps as T

    apply = T.apply_updates_with_clamp

    def capturing(state, grads, optimizer, **kwargs):
        if not any(key.startswith(prefix + "/") for key in arrays):
            arrays.update((f"{prefix}/{name}", g.detach().numpy().copy())
                          for name, g in grads.items())
        return apply(state, grads, optimizer, **kwargs)

    T.apply_updates_with_clamp = capturing
    try:
        yield
    finally:
        T.apply_updates_with_clamp = apply


def _params(prefix, state, arrays):
    for name, value in state.named_parameters().items():
        arrays[f"{prefix}/{name}"] = value.detach().numpy().copy()


def steps_checks(rank: int, world: int, out: dict, arrays: dict) -> None:
    """(c), (d), (e), (f), (g): the steps under the group."""
    from fitclip_torch.parallel.multihost import local_only
    from fitclip_torch.parallel.sharding_rules import shard_train_state
    from fitclip_torch.training import state as S
    from fitclip_torch.training import steps as T

    for mode in ("replicated", "fsdp"):
        encoder = tiny_clip(0)
        optimizer = S.make_optimizer(LR, fused=True, gradient_clip_val=CLIP)
        state = S.init_train_state(encoder, optimizer)
        if mode == "fsdp":
            whole = {n: p.numel() for n, p in state.named_parameters().items()}
            state = shard_train_state(state, optimizer)
            out["fsdp_parts"] = {
                name: {"part": state.fsdp.parts[name].numel(), "whole": whole[name],
                       "mu": state.opt_state["mu"][name].numel(),
                       "nu": state.opt_state["nu"][name].numel(),
                       "jax_path": split.jax_path, "jax_dim": split.jax_dim, "dim": split.dim}
                for name, split in state.fsdp.layout.items()}
            out["fsdp_bytes"] = state.fsdp.held_bytes(state)
            out["fsdp_replicated"] = sorted(n for n in whole if n not in state.fsdp.layout)
        else:
            out["replicated_bytes"] = {
                "params": sum(p.numel() * p.element_size()
                              for p in state.named_parameters().values()),
                "moments": sum(m.numel() * m.element_size() for key in ("mu", "nu")
                               for m in state.opt_state[key].values())}
        with (first_gradients(arrays, "grad_replicated") if mode == "replicated"
              else contextlib.nullcontext()):
            losses, state = run_steps(T.make_contrastive_train_step(encoder, optimizer), state,
                                      contrastive_batches(), rank, world)
        if mode == "fsdp":
            out["fsdp_bytes_after"] = state.fsdp.held_bytes(state)
            state = state.fsdp.unshard(state)
        out[f"{mode}_losses"] = losses
        _params(mode, state, arrays)

    with first_gradients(arrays, "grad_teacher_student"):
        out["teacher_student_losses"], state = teacher_student_steps(rank, world)
    _params("teacher_student", state, arrays)

    with first_gradients(arrays, "grad_resnet"):
        out["resnet_losses"] = resnet_steps(rank, world, arrays, "resnet")

    # The one-process references on the global batch, without a collective:
    # rank 0 the contrastive and the ResNet steps, rank 1 the teacher-student step.
    with local_only():
        if rank == 0:
            with first_gradients(arrays, "grad_one_contrastive"):
                out["one_contrastive_losses"], state = contrastive_steps(0, 1)
            _params("one_contrastive", state, arrays)
            with first_gradients(arrays, "grad_one_resnet"):
                out["one_resnet_losses"] = resnet_steps(0, 1, arrays, "one_resnet")
        else:
            with first_gradients(arrays, "grad_one_teacher_student"):
                out["one_teacher_student_losses"], state = teacher_student_steps(0, 1)
            _params("one_teacher_student", state, arrays)


def loader_checks(plan: dict, rank: int, out: dict) -> None:
    """(a), (k): the loaders' blocks through the data modules, the refusal."""
    from fitclip_torch.data.data_module_group import MixedBatchDataModule
    from fitclip_torch.data.datasets.webvid import WebVidDataModule
    from fitclip_torch.data.loader import DataLoader
    from fitclip_torch.models.clip.load import load_tiny_test_encoder

    encoder = load_tiny_test_encoder(num_frames=4, seed=0, bpe_path=plan["merges"],
                                     vocab_path=plan["vocab"], device="cpu")

    def webvid():
        return WebVidDataModule(train_video_info_file_path=os.environ["WEBVID_TRAIN_CSV"],
                                train_videos_folder=os.environ["WEBVID_TRAIN_VIDEOS"],
                                encoder=encoder, batch_size=4, num_threads=1)

    loader = webvid().train_dataloader()
    out["loader"] = {"process": [loader.process_index, loader.process_count],
                     "seed": loader.seed, "batch_size": loader.batch_size,
                     "length": len(loader.dataset), "plans": []}
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        out["loader"]["plans"].append(list(loader._batches_of_indices()))
    mixed = MixedBatchDataModule({"labeled": webvid(), "unlabeled": webvid()},
                                 train_sequence_sizes={"labeled": 2, "unlabeled": 4})
    mixed_loader = mixed.train_dataloader()
    out["mixed"] = {"process": [mixed_loader.process_index, mixed_loader.process_count],
                    "seed": mixed_loader.seed, "plans": []}
    for epoch in (0, 1):
        mixed_loader.set_epoch(epoch)
        out["mixed"]["plans"].append(mixed_loader._index_plan())
    odd = DataLoader(list(range(6)), batch_size=3, process_index=rank, process_count=2)
    try:
        next(iter(odd._batches_of_indices()))
    except ValueError as error:
        out["odd_batch_error"] = str(error)


def cli_checks(plan: dict, rank: int, out: dict) -> None:
    """(h), (i), (j): evaluate, predict and train through the CLI under the group."""
    from fitclip_torch.cli import main as cli
    from fitclip_torch.cli import runners
    from fitclip_torch.ops.quant import save_act_scales

    calibrate, run_eval = runners._calibrate_on_batches, runners.run_eval
    scales = os.path.join(plan["out"], f"scales_rank{rank}.npz")

    def calibrating(encoder, observations, quant_cfg):
        calibrate(encoder, observations, quant_cfg)
        save_act_scales(scales, encoder.model)  # the scales this rank holds

    evaluated = []

    def evaluating(*args, **kwargs):
        evaluated.append(run_eval(*args, **kwargs))
        return evaluated[-1]

    runners._calibrate_on_batches, runners.run_eval = calibrating, evaluating
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            cli.main(plan["evaluate"])
            cli.main(plan["predict"])
    finally:
        runners._calibrate_on_batches, runners.run_eval = calibrate, run_eval
    out["evaluate"] = evaluated[0]
    out["printed"] = printed.getvalue()

    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logging.getLogger("fitclip_torch.training.train_runner").addHandler(handler)
    for argv in plan["train"]:
        cli.main(argv)
    out["train_log"] = [r for r in records if "FSDP" in r or "fsdp" in r]


def main(rank: int, plan_path: str) -> None:
    import torch

    torch.set_num_threads(1)
    with open(plan_path) as file:
        plan = json.load(file)
    os.environ.update(plan["env"])
    from fitclip_torch.data import video_reader
    from fitclip_torch.parallel import multihost

    video_reader._native_reader = lambda: None  # OpenCV, as the JAX side decodes
    multihost.maybe_initialize_distributed({
        "distributed": {"coordinator_address": plan["address"], "num_processes": 2,
                        "process_id": rank},
        "encoder": {"device": "cpu"}})
    out, arrays = {"rank": rank, "world": multihost.process_count(),
                   "main": multihost.is_main_process()}, {}
    loader_checks(plan, rank, out)
    steps_checks(rank, 2, out, arrays)
    cli_checks(plan, rank, out)
    multihost.barrier()
    multihost.shutdown_distributed()
    np.savez(os.path.join(plan["out"], f"rank{rank}.npz"), **arrays)
    with open(os.path.join(plan["out"], f"rank{rank}.json"), "w") as file:
        json.dump(out, file)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])
