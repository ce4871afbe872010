"""FitCLIP teacher-student training on the card: the step of
``make_teacher_student_train_step`` (student trainable, teacher frozen), as
``run_train`` builds it, on batches made on the device.

Set-up makes a pool of ``pool_steps`` batches from the seed (each step
``labeled`` + ``unlabeled`` clips with a caption each), the student's and
the teacher's weights, builds the two encoders through the port's state-dict
route, the optimizer and the TrainState. It keeps a copy of that state as
built, drives the state through ``checked_steps`` steps through the same
call the window makes, which warms every shape, then puts the copy back in
place (parameters and buffers copied into the same tensors, the optimizer's
state and the step count restored). The window starts from the seed's state
on the pool's first batch; its first ``checked_steps`` steps are the
compared ones. It runs whole steps, cycling the pool, the device
synchronised at both ends; its rate is the student clips of its steps over
its time. A ``--trace 1`` run profiles ``traced_steps`` more after it.

The comparison that decides ``correct``, once the window has closed and the
program is freed, against the float32 reference over the window's first
steps on the same weights and batches:
- ``labeled_loss_gap``, ``unlabeled_loss_gap``: the widest relative gap of
  each loss over the checked steps;
- ``grad_gap``: the first gradient as the optimizer got it (its first moment
  after step 1 over 1 - beta1), by the worst leaf: the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf;
- ``change_gap``: the same of each leaf's change over the checked steps.
Elements whose reference first gradient is under a thousandth of the median
leaf's root-mean-square gradient move by rounding alone and are left out of
both norms (``gaps``).

Faults for the tests (``fault``): "frozen" returns the state unchanged (the
parameters put back after each step); "half" trains on the first half of
each sub-batch's rows.
"""

import time
from typing import Dict, Optional

import torch

from port_bench import traffic
from port_bench.harness import Check, Reading
from port_bench.reference import train as reference
from port_bench.reference.common import full_float32
from port_bench.tracing import profiled, span

# The keys of a traffic mix and of a cell file that this kind reads ("about"
# describes the mix); the manifest's test refuses any other.
TRAFFIC_KEYS = {"kind", "about", "labeled", "unlabeled", "caption_tokens", "pool_steps",
                "checked_steps", "traced_steps"}
CELL_KEYS = {"student", "teacher", "method", "optimizer", "control_bits", "limits"}


def pool(cell, seed: int, device: torch.device):
    """(steps, rows, frames, size, size, 3) uint8 clips and (steps, rows, context) ids."""
    mix = cell.traffic
    frames, size, context = cell.family.shapes(cell.config)
    rows = mix["labeled"] + mix["unlabeled"]
    video = traffic.clips(mix["pool_steps"] * rows, frames, size,
                          traffic.generator(seed, "video", device), device)
    ids = traffic.captions(mix["pool_steps"] * rows, context, mix["caption_tokens"],
                           cell.config["tokens"], traffic.generator(seed, "captions", device),
                           device)
    return (video.view(mix["pool_steps"], rows, *video.shape[1:]),
            ids.view(mix["pool_steps"], rows, context))


def batch(cell, video, ids, index: int) -> dict:
    """The step's batch: the student and the teacher see the same clips and
    captions (one tokenizer, one preprocessing)."""
    i, n = index % video.shape[0], cell.traffic["labeled"]

    def sub(a, b):
        v, t = video[i, a:b], ids[i, a:b]
        return {"video_student": v, "text_student": t, "video_teacher": v, "text_teacher": t}

    return {"labeled": sub(0, n), "unlabeled": sub(n, video.shape[1])}


def unit_calls(cell) -> list:
    mix, family, cfg = cell.traffic, cell.family, cell.config
    rows = mix["labeled"] + mix["unlabeled"]
    return family.train_calls(cfg, rows, mix["unlabeled"])


def _faulty(step, fault: str, state_of):
    def frozen(state, b):
        saved = {n: p.detach().clone() for n, p in state_of(state).items()}
        state, metrics = step(state, b)
        with torch.no_grad():
            for n, p in state_of(state).items():
                p.copy_(saved[n])
        return state, metrics

    def half(state, b):
        cut = {k: {n: t[: max(1, t.shape[0] // 2)] for n, t in sub.items()}
               for k, sub in b.items()}
        return step(state, cut)

    return {"frozen": frozen, "half": half}[fault]


def run(cell, seed: int, seconds: float, trace: bool, started: float, device: str,
        fault: Optional[str] = None) -> Reading:
    from fitclip_torch.training.state import init_train_state, make_optimizer
    from fitclip_torch.training.steps import make_teacher_student_train_step
    from fitclip_torch.utils.precision import training_convolutions

    dev = torch.device(device)
    family, cfg, mix, spec = cell.family, cell.config, cell.traffic, cell.spec
    method, opt = spec["method"], spec["optimizer"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    stages = {"imports": time.perf_counter() - started}
    video, ids = pool(cell, seed, dev)
    student_weights = family.make_weights(cfg, seed, "weights", dev)
    student = family.load_program(cfg, student_weights, dev, **spec["student"])
    del student_weights
    teacher = family.load_program(cfg, family.make_weights(cfg, seed, "teacher weights", dev),
                                  dev, **spec["teacher"])
    optimizer = make_optimizer(learning_rate=opt["lr"], weight_decay=opt["weight_decay"],
                               betas=tuple(opt["betas"]), eps=opt["eps"],
                               fit_temperature=method["fit_temperature"], fused=opt["fused"])
    state = init_train_state(student, optimizer, init_temperature=method["init_temperature"],
                             min_temperature=method["min_temperature"],
                             with_teacher_student_scale=True)
    step = make_teacher_student_train_step(
        student, teacher, optimizer, labeled_loss_share=method["labeled_dataset_loss_share"])
    sync()
    stages["load"] = time.perf_counter() - started

    def trainable(s) -> Dict[str, torch.Tensor]:
        return {n: p for n, p in s.named_parameters().items() if optimizer.trainable(n)}

    if fault:
        step = _faulty(step, fault, trainable)
    rows, checked_steps = mix["labeled"] + mix["unlabeled"], mix["checked_steps"]
    reading = Reading(items_per_unit=rows, unit_calls=unit_calls(cell))
    host_s, checked, kept = [], [], {}
    b1 = optimizer.betas[0]

    def one_step(s, index):
        start = time.perf_counter()
        with span("step"):
            s, metrics = step(s, batch(cell, video, ids, index))
        host_s.append(time.perf_counter() - start)
        return s, metrics

    with training_convolutions():
        built = _saved(state)
        kept["before"] = {n: built[0][n] for n in trainable(state)}
        for index in range(checked_steps):
            state, _ = one_step(state, index)
        sync()
        _restore(state, built)
        del built
        sync()
        reading.setup_s = time.perf_counter() - started
        reading.notes["setup_s_by_stage_end"] = dict(stages, warm_steps=reading.setup_s)
        reading.notes["warm_step_host_s"] = list(host_s)
        index, steps = 0, 0
        start = time.perf_counter()
        while True:
            state, metrics = one_step(state, index)
            index, steps = index + 1, steps + 1
            # The window's first steps are the compared ones: device copies
            # here, read once the window has closed.
            if steps <= checked_steps:
                checked.append({k: metrics[k].detach().clone()
                                for k in ("loss/train_labeled", "loss/train_unlabeled")})
            if steps == 1:
                kept["mu"] = {n: state.opt_state["mu"][n].detach().clone()
                              for n in kept["before"]}
            if steps == checked_steps:
                kept["after"] = {n: p.detach().clone() for n, p in trainable(state).items()}
            if steps >= checked_steps and time.perf_counter() - start >= seconds:
                break
        sync()
        reading.window_s = time.perf_counter() - start
        window_host_s = list(host_s[-steps:])
        if trace:  # after the window, which the profiler's after-effects would slow
            with profiled() as traced:
                with span("window"):
                    for _ in range(mix["traced_steps"]):
                        state, _ = one_step(state, index)
                        index += 1
                    sync()
            reading.trace, reading.traced_units = traced[0], mix["traced_steps"]
    reading.units = steps
    reading.span_s = {"step": window_host_s}
    reading.notes["step_host_s"] = [round(v, 4) for v in window_host_s]
    reading.attempted = rows * index
    if dev.type == "cuda":
        reading.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    program = {"losses": [{k: float(v) for k, v in m.items()} for m in checked],
               "grads": {n: (m.float() / (1 - b1)).cpu() for n, m in kept["mu"].items()},
               "changes": {n: (p - kept["before"][n]).cpu() for n, p in kept["after"].items()}}
    del state, step, student, teacher, optimizer, video, ids, kept
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reading.checks = compare(cell, program, follow(cell, seed, dev), reading.notes)
    return reading


def _live(state) -> Dict[str, torch.Tensor]:
    """Every tensor of the state that a step changes in place: the parameters,
    and the buffers of its modules."""
    out = dict(state.named_parameters())
    for key, value in state.params.items():
        if isinstance(value, torch.nn.Module):
            out.update({f"{key}/buffer/{n}": b for n, b in value.named_buffers()})
    return out


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


def _saved(state) -> tuple:
    """A copy of the state: its tensors, the optimizer's state, the step count."""
    return _clone(_live(state)), _clone(state.opt_state), state.step


def _restore(state, saved: tuple) -> None:
    """Put ``_saved``'s copy back: into the same tensors, so that whatever
    holds them (the modules, the step) sees the restored values."""
    tensors, opt_state, step = saved
    with torch.no_grad():
        for name, tensor in _live(state).items():
            tensor.copy_(tensors[name])
    state.opt_state, state.step = _clone(opt_state), step


def follow(cell, seed: int, device: torch.device, bits: Optional[dict] = None) -> dict:
    """The reference over the checked steps: each step's losses, the first
    step's gradients and each leaf's change, by the program's leaf names."""
    family, cfg, mix, spec = cell.family, cell.config, cell.traffic, cell.spec
    method, opt = spec["method"], spec["optimizer"]
    video, ids = pool(cell, seed, device)
    student = family.reference_trainable(family.make_weights(cfg, seed, "weights", device))
    student.update(reference.initial_scales(method["init_temperature"], device))
    teacher = family.make_weights(cfg, seed, "teacher weights", device)
    for p in student.values():
        p.requires_grad_(True)
    names = list(student)
    adamw = reference.AdamW(student, opt["lr"], opt["weight_decay"], tuple(opt["betas"]),
                            opt["eps"], -torch.log(torch.tensor(method["min_temperature"])).item())
    before = {n: p.detach().clone() for n, p in student.items()}
    out = {"losses": []}
    with full_float32():
        for index in range(mix["checked_steps"]):
            b = batch(cell, video, ids, index)
            sub = {k: {"video": v["video_student"], "text": v["text_student"]}
                   for k, v in b.items()}
            total, labeled, unlabeled = reference.losses(
                student, teacher, sub, cfg, method["labeled_dataset_loss_share"],
                family.reference_video, family.reference_text, bits)
            grads = dict(zip(names, torch.autograd.grad(total, [student[n] for n in names])))
            out["losses"].append({"loss/train_labeled": float(labeled.detach()),
                                  "loss/train_unlabeled": float(unlabeled.detach())})
            if index == 0:
                out["grads"] = {n: g.detach() for n, g in grads.items()}
            adamw.step(student, grads)
            del total, labeled, unlabeled, grads
    out["changes"] = {n: student[n].detach() - before[n] for n in names}
    rename = family.program_leaf_name
    return {"losses": out["losses"],
            "grads": {rename(n): v for n, v in out["grads"].items()},
            "changes": {rename(n): v for n, v in out["changes"].items()}}


def _median(values):
    ordered = sorted(values)
    return ordered[(len(ordered) - 1) // 2]


def gaps(program: dict, ref: dict, worst: Optional[dict] = None) -> Dict[str, float]:
    """The three numbers compared. The gradients and changes are compared by
    leaf norms over the elements whose reference first gradient reaches a
    thousandth of the median leaf's root-mean-square gradient: the rest (a
    key's bias under softmax: a third of each in_proj.bias) move under Adam
    by rounding alone. A leaf the program lacks reads as a gap of 1.
    ``worst`` receives each number's three worst leaves with their readings."""
    out = {name: max(abs(p[key] - r[key]) / abs(r[key])
                     for p, r in zip(program["losses"], ref["losses"]))
           for key, name in (("loss/train_labeled", "labeled_loss_gap"),
                             ("loss/train_unlabeled", "unlabeled_loss_gap"))}
    rms = {n: float(torch.linalg.vector_norm(g)) / g.numel() ** 0.5
           for n, g in ref["grads"].items()}
    floor = 1e-3 * _median(rms.values())
    kept = {n: g.abs() >= floor for n, g in ref["grads"].items()}
    kept = {n: m for n, m in kept.items() if bool(m.any())}
    for key, name in (("grads", "grad_gap"), ("changes", "change_gap")):
        norms = {}
        for side, tensors in (("program", program[key]), ("reference", ref[key])):
            norms[side] = {n: float(torch.linalg.vector_norm(tensors[n].to(m.device)[m]))
                           for n, m in kept.items() if n in tensors}
        median = _median(norms["reference"].values())
        leaf = {n: abs(norms["program"].get(n, 0.0) - r) / max(r, median)
                for n, r in norms["reference"].items()}
        leaf.update({n: 1.0 for n in kept if n not in norms["program"]})
        out[name] = max(leaf.values())
        if worst is not None:
            worst[name] = [[n, leaf[n], norms["program"].get(n), norms["reference"][n], median]
                           for n in sorted(leaf, key=leaf.get, reverse=True)[:3]]
    if worst is not None:
        worst["losses"] = {"program": program["losses"], "reference": ref["losses"]}
    return out


def compare(cell, program: dict, ref: dict, notes: dict) -> Dict[str, Check]:
    limits = cell.spec["limits"]
    notes["worst_leaves"] = {}
    return {name: Check(value, limits[name])
            for name, value in gaps(program, ref, notes["worst_leaves"]).items()}


def control(cell, seed: int, device: str, worst: Optional[dict] = None) -> Dict[str, float]:
    """The control's readings: the reference at the precisions one step below
    the cell's (``control_bits``) against the float32 reference."""
    dev = torch.device(device)
    return gaps(follow(cell, seed, dev, cell.spec["control_bits"]), follow(cell, seed, dev),
                worst)
