"""``port_bench/spans.py``: the program's spans read from a profile. On
hand-built profiles, a device interval is charged to the innermost program
span open at its launch, also when another thread launched it; the program's
device-side annotation ranges are not work; and the tiny CPU runs of the
cells read the spans' host times, with no device reading without a card."""

from types import SimpleNamespace

import pytest

from port_bench import spans
from port_bench.tests import tiny

CPU, CUDA = "DeviceType.CPU", "DeviceType.CUDA"


def _event(name, start_us, end_us, device=CPU, id=0, linked=0, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start_us, end=end_us),
                           device_type=device, id=id, linked_correlation_id=linked,
                           thread=thread)


def _profile(events):
    return SimpleNamespace(events=lambda: list(events))


def _step_events():
    """A step's spans on thread 1; the backward's kernel launched from thread
    2 (the autograd engine's) while thread 1 waits inside ``backward``; one
    kernel launched by an op with no runtime event in the profile."""
    return [
        _event("bench/window", 0, 1000),
        _event("fitclip/train_step", 10, 900),
        _event("fitclip/student_forward", 20, 200),
        _event("cudaLaunchKernel", 30, 35, id=501),
        _event("gemm_kernel", 100, 180, CUDA, id=501),
        _event("fitclip/backward", 300, 600),
        _event("cudaLaunchKernel", 310, 312, id=502, thread=2),
        _event("void (anonymous namespace)::rows_mma_kernel<1>(int)", 400, 560, CUDA, id=502),
        _event("fitclip/optimizer", 650, 800),
        _event("aten::_foreach_add_", 660, 700, id=77),
        _event("multi_tensor_apply_kernel", 700, 780, CUDA, id=999, linked=77),
        _event("cudaLaunchKernel", 850, 851, id=503),
        _event("tail_kernel", 880, 950, CUDA, id=503),
    ]


def test_a_kernel_is_charged_to_the_innermost_span_open_at_its_launch():
    program = spans.read(_profile(_step_events()))
    assert [n for n, _, _ in program.trace.device] == [
        "gemm_kernel", "rows_mma_kernel", "multi_tensor_apply_kernel", "tail_kernel"]
    by_span = spans.device_s_by_span(program)
    assert by_span == pytest.approx({"student_forward": 80e-6, "backward": 160e-6,
                                     "optimizer": 80e-6, "train_step": 70e-6})
    assert spans.innermost(program.spans, 5e-6) == "none"


def test_idle_gaps_are_charged_to_the_program_span_open_when_they_begin():
    program = spans.read(_profile(_step_events()))
    idle = spans.idle_s_by_span(program)
    # gaps: [0,100) none, [180,400) student_forward (at 180), [560,700) backward,
    # [780,880) optimizer, [950,1000) none
    assert idle == pytest.approx({"none": 150e-6, "student_forward": 220e-6,
                                  "backward": 140e-6, "optimizer": 100e-6})


def test_program_annotation_ranges_on_the_device_are_not_work():
    plain = spans.read(_profile(_step_events()))
    annotated = spans.read(_profile(_step_events() + [
        _event("fitclip/train_step", 5, 990, CUDA, id=0),
        _event("fitclip/backward", 300, 700, CUDA, id=0),
        _event("bench/window", 0, 1000, CUDA, id=0)]))
    for program in (plain, annotated):
        assert program.trace.busy_s() == pytest.approx(390e-6)
    assert annotated.trace.idle_gaps() == plain.trace.idle_gaps()
    assert annotated.trace.device_ops() == plain.trace.device_ops()
    assert spans.device_s_by_span(annotated) == spans.device_s_by_span(plain)


def test_a_profile_without_a_window_is_refused():
    with pytest.raises(RuntimeError, match="no window"):
        spans.read(_profile([_event("fitclip/train_step", 0, 10)]))


@pytest.mark.parametrize("name", ["clip_b16.msrvtt_zs_int8", "fit_base.msrvtt_zs_int8"])
def test_tiny_eval_runs_read_the_towers_host_time_and_no_device_time(name):
    record = spans.measure(tiny.cell(name), 2 ** 33 + 5, "cpu", units=1)
    metrics = record["metrics"]
    assert metrics["video_issue_ms.eval"] > 0 and metrics["text_issue_ms.eval"] > 0
    assert metrics["video_device_ms.eval"] is None and metrics["text_device_ms.eval"] is None
    assert record["units"] == {"off": 1, "on": 1, "profiled": 2}
    assert record["counters_a_unit"].get("operand_folds", 0) == 0
    assert set(record["host_ms_by_program_span"]) == {"encode_video", "encode_text",
                                                      "retrieval.update", "retrieval.compute"}


def test_tiny_train_run_reads_each_phase_and_no_device_time():
    record = spans.measure(tiny.cell("clip_b16.webvid_ts_bf16"), 2 ** 33 + 5, "cpu", units=1)
    assert set(record["host_ms_by_program_span"]) == {"train_step", *spans.TRAIN_PHASES}
    assert all(value is None for value in record["metrics"].values())
    assert record["counters_a_unit"].get("operand_folds", 0) == 0


def test_a_program_without_spans_gives_the_spans_off_units_alone(monkeypatch):
    """Run against a program that has no ``tracing``: no spans-on unit, no
    span reading, and the tool does not raise."""
    monkeypatch.setattr(spans, "program_tracing", None)
    monkeypatch.setattr(spans, "StageTimer", None)
    record = spans.measure(tiny.cell("clip_b16.msrvtt_zs_int8"), 2 ** 33 + 5, "cpu", units=1)
    assert record["spans_in_program"] is False
    assert record["units"] == {"off": 1, "on": 0, "profiled": 2} and record["on"] == {}
    assert all(value is None for value in record["metrics"].values())
    assert "host_ms_by_program_span" not in record
