"""The program's own spans read beside a cell: each eval tower's and each
train phase's host and device time, and what the spans cost when on.

    python -m port_bench.spans --workload <name> --seeds 11,12,13 [--units 6]

One JSON line a seed. A seed's run builds the cell as its kind's set-up does
(weights, corpus or pool, encoders, calibration, one warm unit), with the
program's spans on during set-up, then:

1. ``units`` units with the spans off and ``units`` with them on, in turns
   (off-on, then on-off), each timed on the host clock: the spans' cost, and
   from the spans-on units each span's host ms a unit;
2. the kind's traced units (``traced_passes`` or ``traced_steps``) under
   ``torch.profiler`` with the spans on: each device interval is charged to
   the innermost program span open at its launch (its launch call found by
   correlation id, on whatever thread it ran: the autograd engine's thread
   launches the backward's kernels while the step's thread waits inside
   ``backward``), and each idle gap to the innermost program span open when
   it began.

The readings carry the names of the per-layer metrics they would feed
(``video_issue_ms.eval``, ``student_device_ms.train``, ...). Without a card
the device readings are None. A program without spans
(``fitclip_torch.utils.profiling.tracing`` missing) gives the spans-off
units alone.

This reads no cell's ``correct``: ``port_bench.run`` decides that.
"""

import argparse
import contextlib
import dataclasses
import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from port_bench import tracing
from port_bench.tracing import Trace, short_name, span

try:
    from fitclip_torch.utils.profiling import SPAN_PREFIX, StageTimer
    from fitclip_torch.utils.profiling import tracing as program_tracing
except ImportError:  # a program without spans
    SPAN_PREFIX, StageTimer, program_tracing = "fitclip/", None, None

# The metrics each kind's readings feed: name -> the program span it reads.
EVAL_ISSUE = {"video_issue_ms.eval": "encode_video", "text_issue_ms.eval": "encode_text"}
EVAL_DEVICE = {"video_device_ms.eval": "encode_video", "text_device_ms.eval": "encode_text"}
TRAIN_DEVICE = {"student_device_ms.train": "student_forward",
                "teacher_device_ms.train": "teacher_forward",
                "backward_device_ms.train": "backward", "optimizer_device_ms.train": "optimizer"}
# The train phases whose device time should cover a step's busy time.
TRAIN_PHASES = ("student_forward", "teacher_forward", "loss", "backward", "grad_average",
                "optimizer")


@dataclasses.dataclass
class ProgramTrace:
    trace: Trace                               # device intervals, the harness's spans
    spans: List[Tuple[str, float, float]]      # the program's host spans, prefix dropped
    launches: List[Optional[float]]            # host launch time of each of trace.device


def _is_runtime(name: str) -> bool:
    """A CUDA API call (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync,
    ...), which shares its correlation id with the device activity it
    started."""
    return name.startswith("cu")


def read(prof) -> ProgramTrace:
    """The profile's window, device intervals and harness spans as
    ``tracing.read`` gives them, the program's spans beside them, and each
    device interval's launch time. The device-side ranges of both kinds of
    span are annotations, not work, and are dropped."""
    events = list(prof.events())
    runtime, ops = {}, {}
    for event in events:
        if not tracing._is_device(event):
            table = runtime if _is_runtime(event.name) else ops
            table.setdefault(event.id, event.time_range.start * 1e-6)
    window: Optional[Tuple[float, float]] = None
    device, launches, harness_spans, spans = [], [], [], []
    for event in events:
        start, end = event.time_range.start * 1e-6, event.time_range.end * 1e-6
        on_device = tracing._is_device(event)
        if event.name.startswith((tracing.SPAN_PREFIX, SPAN_PREFIX)):
            if on_device:
                continue
            if event.name.startswith(SPAN_PREFIX):
                spans.append((event.name[len(SPAN_PREFIX):], start, end))
                continue
            harness_spans.append((event.name, start, end))
            if event.name == tracing.WINDOW:
                window = (start, end)
        elif on_device:
            device.append((short_name(event.name), start, end))
            launch = runtime.get(event.id)
            if launch is None:  # no runtime call found: the op that launched it
                launch = ops.get(getattr(event, "linked_correlation_id", 0))
            launches.append(launch)
    if window is None:
        raise RuntimeError("the profile holds no window span: nothing was traced")
    kept = [(n, max(a, window[0]), min(b, window[1]), t)
            for (n, a, b), t in zip(device, launches) if b > window[0] and a < window[1]]
    return ProgramTrace(Trace(window, [k[:3] for k in kept], harness_spans), spans,
                        [k[3] for k in kept])


def innermost(spans: List[Tuple[str, float, float]], t: float) -> str:
    """The shortest span open at ``t`` ("none" outside every span)."""
    inside = [(b - a, name) for name, a, b in spans if a <= t < b]
    return min(inside)[1] if inside else "none"


def device_s_by_span(program: ProgramTrace) -> Dict[str, float]:
    """Device seconds of the intervals launched inside each program span
    (the innermost at the launch; "unlinked" where no launch was found)."""
    totals: Dict[str, float] = defaultdict(float)
    for (_, start, end), launch in zip(program.trace.device, program.launches):
        key = "unlinked" if launch is None else innermost(program.spans, launch)
        totals[key] += end - start
    return dict(totals)


def idle_s_by_span(program: ProgramTrace) -> Dict[str, float]:
    """Idle seconds of the device by the innermost program span the host was
    in when each gap began."""
    trace = program.trace
    edges = [trace.window[0]]
    for a, b in trace.busy_intervals():
        edges += [a, b]
    edges.append(trace.window[1])
    totals: Dict[str, float] = defaultdict(float)
    for start, end in zip(edges[0::2], edges[1::2]):
        if end > start:
            totals[innermost(program.spans, start)] += end - start
    return dict(totals)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _per_unit_ms(totals: Dict[str, float], units: int) -> Dict[str, float]:
    return {name: 1e3 * s / units for name, s in sorted(totals.items())}


def _on(timer):
    return program_tracing(timer) if program_tracing else contextlib.nullcontext()


def _new_timer():
    return StageTimer() if StageTimer else None


def _alternated(unit: Callable[[], dict], units: int, timer) -> Tuple[List[dict], List[dict]]:
    """``units`` units with the spans off and as many on, in turns (off-on,
    on-off, ...); without spans in the program, the off units alone."""
    off, on = [], []
    for i in range(units):
        order = ("off", "on") if i % 2 == 0 else ("on", "off")
        for side in order:
            if side == "off":
                off.append(unit())
            elif program_tracing:
                with program_tracing(timer):
                    on.append(unit())
    return off, on


def _profiled_units(unit: Callable[[], dict], units: int, dev: torch.device, timer):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        with _on(timer), span("window"):
            for _ in range(units):
                unit()
            _sync(dev)
    return read(prof)


def _spans_record(program: ProgramTrace, units: int, on_units: int, on_timer,
                  traced_timer, off: List[dict], on: List[dict]) -> dict:
    """What both kinds report of the spans: host ms by span from the
    spans-on units, device ms and idle ms by span from the profiled ones,
    the counters a unit, and the units' host times with the spans off and on."""
    by_span = device_s_by_span(program)
    has_device = bool(program.trace.device)
    record = {
        "units": {"off": len(off), "on": len(on), "profiled": units},
        "off": {k: [u[k] for u in off] for k in off[0]} if off else {},
        "on": {k: [u[k] for u in on] for k in on[0]} if on else {},
        "busy_ms": 1e3 * program.trace.busy_s() / units if has_device else None,
        "window_ms": 1e3 * program.trace.window_s / units,
        "device_ms_by_program_span": _per_unit_ms(by_span, units) if has_device else None,
        "idle_ms_by_program_span": _per_unit_ms(idle_s_by_span(program), units)
        if has_device else None,
        "idle_ms_by_harness_span": {n: 1e3 * s / units for n, s in program.trace.idle_gaps()}
        if has_device else None,
        "device_ops_ms": {n: 1e3 * s / units for n, s in program.trace.device_ops()}
        if has_device else None,
        "unlinked_device_ms": 1e3 * by_span.get("unlinked", 0.0) / units if has_device else None,
    }
    if on_timer is not None:
        record["host_ms_by_program_span"] = _per_unit_ms(on_timer.totals, on_units)
        record["profiled_host_ms_by_program_span"] = _per_unit_ms(traced_timer.totals, units)
        counters = defaultdict(int)
        for timer in (on_timer, traced_timer):
            for name, n in timer.counters.items():
                counters[name] += n
        record["counters_a_unit"] = {n: c / (on_units + units) for n, c in counters.items()}
    return record


def _device_ms(record: dict, name: str) -> Optional[float]:
    """Device ms a unit launched inside the span ``name``; None without a
    device trace or without spans in the program."""
    table = record.get("device_ms_by_program_span")
    return None if table is None or program_tracing is None else table.get(name, 0.0)


def measure_eval(cell, seed: int, dev: torch.device, units: int) -> dict:
    from fitclip_torch.evaluation.retrieval import RetrievalEvaluator
    from fitclip_torch.training.steps import make_eval_step

    from port_bench.kinds import eval as kind

    family, mix, spec = cell.family, cell.traffic, cell.spec
    setup_timer, start = _new_timer(), time.perf_counter()
    with _on(setup_timer):
        video, ids = kind.corpus(cell, seed, dev)
        weights = family.make_weights(cell.config, seed, "weights", dev)
        encoder = family.load_program(cell.config, weights, dev, spec["precision"])
        del weights
        bounds = kind.batch_bounds(cell)
        loaded = time.perf_counter()
        if spec["precision"] == "int8":
            family.calibrate(encoder, [(video[a:b], ids[a:b])
                                       for a, b in bounds[:mix["calibration_batches"]]])
        _sync(dev)
        calibrate_s = time.perf_counter() - loaded
        step = make_eval_step(encoder)

        def one_pass() -> dict:
            evaluator, begin = RetrievalEvaluator(), time.perf_counter()
            with span("issue"):
                for a, b in bounds:
                    evaluator.update(*step({"video": video[a:b], "text": ids[a:b]}))
            issued = time.perf_counter()
            with span("wait"):
                _sync(dev)
            waited = time.perf_counter()
            with span("score"):
                evaluator.compute()
            done = time.perf_counter()
            return {"issue_ms": 1e3 * (issued - begin), "score_ms": 1e3 * (done - waited),
                    "pass_s": done - begin}

        one_pass()
        _sync(dev)
    record = {"setup_s": time.perf_counter() - start, "calibrate_s": calibrate_s}
    if setup_timer is not None:
        record["setup_spans_s"] = dict(setup_timer.totals)
        record["setup_counters"] = dict(setup_timer.counters)
    on_timer, traced_timer = _new_timer(), _new_timer()
    off, on = _alternated(one_pass, units, on_timer)
    traced = mix["traced_passes"]
    program = _profiled_units(one_pass, traced, dev, traced_timer)
    record.update(_spans_record(program, traced, len(on), on_timer, traced_timer, off, on))
    host = record.get("host_ms_by_program_span", {})
    metrics = {name: host.get(s) for name, s in EVAL_ISSUE.items()}
    metrics.update({name: _device_ms(record, s) for name, s in EVAL_DEVICE.items()})
    if host:
        record["issue_share_of_host_issue"] = (
            (host.get("encode_video", 0.0) + host.get("encode_text", 0.0))
            / statistics.median(record["off"]["issue_ms"]))
    if metrics["video_device_ms.eval"] is not None:
        score = _device_ms(record, "retrieval.compute")
        record["tower_share_of_busy_less_score"] = (
            (metrics["video_device_ms.eval"] + metrics["text_device_ms.eval"])
            / (record["busy_ms"] - score))
    record["metrics"] = metrics
    return record


def measure_train(cell, seed: int, dev: torch.device, units: int) -> dict:
    from fitclip_torch.training.state import init_train_state, make_optimizer
    from fitclip_torch.training.steps import make_teacher_student_train_step
    from fitclip_torch.utils.precision import training_convolutions

    from port_bench.kinds import train as kind

    family, cfg, mix, spec = cell.family, cell.config, cell.traffic, cell.spec
    method, opt = spec["method"], spec["optimizer"]
    setup_timer, start = _new_timer(), time.perf_counter()
    position = {"index": 0}
    with training_convolutions():
        with _on(setup_timer):
            video, ids = kind.pool(cell, seed, dev)
            student = family.load_program(cfg, family.make_weights(cfg, seed, "weights", dev),
                                          dev, **spec["student"])
            teacher = family.load_program(cfg, family.make_weights(cfg, seed, "teacher weights",
                                                                   dev), dev, **spec["teacher"])
            optimizer = make_optimizer(learning_rate=opt["lr"],
                                       weight_decay=opt["weight_decay"],
                                       betas=tuple(opt["betas"]), eps=opt["eps"],
                                       fit_temperature=method["fit_temperature"],
                                       fused=opt["fused"])
            state = init_train_state(student, optimizer,
                                     init_temperature=method["init_temperature"],
                                     min_temperature=method["min_temperature"],
                                     with_teacher_student_scale=True)
            step = make_teacher_student_train_step(
                student, teacher, optimizer,
                labeled_loss_share=method["labeled_dataset_loss_share"])
            holder = {"state": state}

            def one_step() -> dict:
                begin = time.perf_counter()
                holder["state"], _ = step(holder["state"],
                                          kind.batch(cell, video, ids, position["index"]))
                position["index"] += 1
                return {"host_ms": 1e3 * (time.perf_counter() - begin)}

            def chunk() -> dict:
                """Three steps, the device synchronised at both ends."""
                _sync(dev)
                begin = time.perf_counter()
                host = [one_step()["host_ms"] for _ in range(3)]
                _sync(dev)
                return {"host_ms": sum(host) / 3,
                        "step_ms": 1e3 * (time.perf_counter() - begin) / 3}

            for _ in range(mix["checked_steps"]):
                one_step()
            _sync(dev)
        record = {"setup_s": time.perf_counter() - start}
        if setup_timer is not None:
            record["setup_spans_s"] = dict(setup_timer.totals)
            record["setup_counters"] = dict(setup_timer.counters)
        on_timer, traced_timer = _new_timer(), _new_timer()
        off, on = _alternated(chunk, units, on_timer)
        traced = mix["traced_steps"]
        program = _profiled_units(one_step, traced, dev, traced_timer)
    # the spans-on chunks hold three steps each
    record.update(_spans_record(program, traced, 3 * len(on), on_timer, traced_timer, off, on))
    metrics = {name: _device_ms(record, s) for name, s in TRAIN_DEVICE.items()}
    if metrics["backward_device_ms.train"] is not None:
        record["phase_share_of_busy"] = (sum(_device_ms(record, p) for p in TRAIN_PHASES)
                                         / record["busy_ms"])
    record["metrics"] = metrics
    return record


def measure(cell, seed: int, device: str = "cuda", units: int = 6) -> dict:
    dev = torch.device(device)
    kinds = {"eval": measure_eval, "train": measure_train}
    record = {"workload": cell.name, "seed": seed,
              "spans_in_program": program_tracing is not None}
    record.update(kinds[cell.traffic["kind"]](cell, seed, dev, units))
    return record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--units", type=int, default=6,
                        help="units with the spans off, and as many with them on")
    args = parser.parse_args(argv)

    from port_bench import harness

    if not torch.cuda.is_available():
        print("port_bench.spans: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    device = {"kind": torch.cuda.get_device_name(0), "power": harness.power_limit()}
    for seed in (int(s) for s in args.seeds.split(",")):
        record = dict(measure(cell, seed, "cuda", args.units), device=device)
        print(json.dumps(record), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
