"""The program's spans and counters (``fitclip_torch/utils/profiling.py``):
off by default at the cost of one check, on under ``tracing``, nested as the
step's phases are, visible in a ``torch.profiler`` profile under
``fitclip/``; and the ``operand_folds`` counter at the blocks' fold caches."""

import numpy as np
import pytest
import torch

from fitclip_torch.evaluation.retrieval import RetrievalEvaluator
from fitclip_torch.models.clip.encoder import ClipVideoTextEncoder
from fitclip_torch.models.clip.model import CLIPConfig, CLIPModel, init_float_params
from fitclip_torch.models.frozen_in_time.video_transformer import SpaceTimeBlock
from fitclip_torch.training import state as S
from fitclip_torch.training import steps as T
from fitclip_torch.utils import profiling
from fitclip_torch.utils.profiling import StageTimer, count, span, tracing
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

FRAMES = 2


def _clips(rng, n):
    return torch.from_numpy(rng.integers(0, 256, size=(n, FRAMES, 32, 32, 3), dtype=np.uint8))


def _ids(rng, n):
    return torch.from_numpy(rng.integers(1, 60, size=(n, 16)))


def _encoder(seed, **kwargs):
    encoder = ClipVideoTextEncoder(CLIPConfig.tiny_test(), num_frames=FRAMES,
                                   fused_attention=True, **kwargs)
    encoder.model.load_state_dict(init_float_params(CLIPModel(CLIPConfig.tiny_test()),
                                                    seed).state_dict(), strict=False)
    return encoder


def _profiled_spans(fn):
    """{name: [(start, end)]} of the ``fitclip/`` events of a CPU profile of fn()."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for event in prof.events():
        if event.name.startswith(profiling.SPAN_PREFIX):
            out.setdefault(event.name[len(profiling.SPAN_PREFIX):], []).append(
                (event.time_range.start, event.time_range.end))
    return out


def _inside(inner, outer):
    return all(any(a <= s and e <= b for a, b in outer) for s, e in inner)


def test_off_span_is_the_shared_no_op_and_records_nothing():
    assert span("encode_video") is span("train_step") is profiling._OFF
    with tracing() as timer:
        pass
    with span("encode_video") as entered:
        count("operand_folds")
    assert entered is None
    assert not timer.totals and not timer.counters
    spans = _profiled_spans(lambda: span("encode_video").__enter__())
    assert spans == {}


def test_on_spans_nest_close_on_an_exception_and_add_to_the_timer():
    timer = StageTimer()
    with tracing(timer) as active:
        assert active is timer
        with span("train_step"):
            with span("backward"):
                count("operand_folds", 2)
            with pytest.raises(ValueError):
                with span("optimizer"):
                    raise ValueError("raised inside a span")
            count("operand_folds")
        with tracing() as inner:  # a nested block records into its own timer
            with span("loss"):
                pass
        with span("backward"):
            pass
    assert profiling._ACTIVE is None and span("loss") is profiling._OFF
    assert dict(timer.counts) == {"train_step": 1, "backward": 2, "optimizer": 1}
    assert dict(timer.counters) == {"operand_folds": 3}
    assert dict(inner.counts) == {"loss": 1}
    assert timer.totals["train_step"] >= timer.totals["optimizer"] > 0
    assert timer.report().endswith("operand_folds: 3")


def test_on_spans_nest_in_a_profile():
    def run():
        with tracing():
            with span("train_step"):
                with span("backward"):
                    torch.ones(4).sum()

    spans = _profiled_spans(run)
    assert set(spans) == {"train_step", "backward"}
    assert _inside(spans["backward"], spans["train_step"])


def test_eval_step_and_retrieval_show_their_spans():
    encoder = _encoder(4)
    step = T.make_eval_step(encoder)
    rng = np.random.default_rng(5)
    batches = [{"video": _clips(rng, 3), "text": _ids(rng, 3)} for _ in range(2)]

    def run():
        with tracing() as timer:
            evaluator = RetrievalEvaluator()
            for batch in batches:
                evaluator.update(*step(batch))
            evaluator.compute()
        assert dict(timer.counts) == {"encode_video": 2, "encode_text": 2,
                                      "retrieval.update": 2, "retrieval.compute": 1}

    spans = _profiled_spans(run)
    assert set(spans) == {"encode_video", "encode_text", "retrieval.update",
                          "retrieval.compute"}
    assert [len(spans[n]) for n in ("encode_video", "encode_text")] == [2, 2]
    video, text = spans["encode_video"][0], spans["encode_text"][0]
    assert video[1] <= text[0]  # the towers one after the other, not nested


def test_teacher_student_step_shows_each_phase_inside_the_step():
    student, teacher = _encoder(0), _encoder(1)
    optimizer = S.make_optimizer(1e-4, fused=True)
    state = S.init_train_state(student, optimizer, with_teacher_student_scale=True)
    step = T.make_teacher_student_train_step(student, teacher, optimizer)
    rng = np.random.default_rng(2)

    def sub():
        return {"video_student": _clips(rng, 2), "text_student": _ids(rng, 2),
                "video_teacher": _clips(rng, 2), "text_teacher": _ids(rng, 2)}

    batch = {"labeled": sub(), "unlabeled": sub()}
    state, _ = step(state, batch)  # spans off: nothing recorded
    phases = ("student_forward", "teacher_forward", "loss", "backward", "grad_average",
              "optimizer")

    def run():
        with tracing():
            step(state, batch)

    spans = _profiled_spans(run)
    assert set(spans) == {"train_step", *phases}
    assert all(len(spans[n]) == 1 for n in spans)
    assert all(_inside(spans[n], spans["train_step"]) for n in phases)
    starts = [spans[n][0][0] for n in phases]
    assert starts == sorted(starts)


def test_contrastive_step_shows_its_phases():
    encoder = _encoder(3)
    optimizer = S.make_optimizer(1e-4, fused=True)
    state = S.init_train_state(encoder, optimizer)
    step = T.make_contrastive_train_step(encoder, optimizer)
    rng = np.random.default_rng(7)
    batch = {"video": _clips(rng, 3), "text": _ids(rng, 3)}
    with tracing() as timer:
        step(state, batch)
    assert set(timer.counts) == {"train_step", "student_forward", "loss", "backward",
                                 "grad_average", "optimizer"}


def test_operand_folds_count_one_refold_a_clip_block_after_an_act_scale_changes():
    encoder = _encoder(6, quantized=True, fused_block=True)
    rng = np.random.default_rng(9)
    video, ids = _clips(rng, 2), _ids(rng, 2)
    encoder.calibrate(video, ids)
    blocks = [*encoder.model.visual.transformer.blocks, *encoder.model.text.transformer.blocks]
    with torch.no_grad():
        encoder.encode_video(video), encoder.encode_text(ids)  # the first folds
        with tracing() as timer:
            for _ in range(2):
                encoder.encode_video(video), encoder.encode_text(ids)
            assert timer.counters["operand_folds"] == 0
            for block in blocks:
                block.mlp_fc.act_scale.mul_(2.0)
            for _ in range(2):
                encoder.encode_video(video), encoder.encode_text(ids)
    assert timer.counters["operand_folds"] == len(blocks) == 4


def test_operand_folds_count_one_refold_a_fit_block_after_an_act_scale_changes():
    block = SpaceTimeBlock(64, 1, torch.float32, fused_attention=True, quantized=True)
    block.int8_operands()
    with tracing() as timer:
        block.int8_operands()
        assert timer.counters["operand_folds"] == 0
        block.attn.qkv.act_scale.fill_(3.0)
        block.int8_operands(), block.int8_operands()
    assert timer.counters["operand_folds"] == 1


def test_kernel_builds_counts_a_build_and_not_a_load(tmp_path, monkeypatch):
    """The library's build, with nvcc stood in for by a writer of its -o file:
    the first call compiles and counts, the second finds the library built;
    ``kernel_library`` spans the first load alone."""
    import subprocess

    from fitclip_torch import _build

    source = tmp_path / "one.cu"
    source.write_text("// a kernel\n")

    def nvcc(cmd):
        with open(cmd[cmd.index("-o") + 1], "w") as out:
            out.write("built")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "sources", lambda: [source])
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run", nvcc)
    with tracing() as timer:
        first, second = _build.build(), _build.build()
    assert first == second and first.read_text() == "built"
    assert dict(timer.counters) == {"kernel_builds": 1}

    monkeypatch.setattr(_build, "_load", lambda: "library")
    _build.library.cache_clear()
    try:
        with tracing() as timer:
            assert _build.library() == _build.library() == "library"
    finally:
        _build.library.cache_clear()
    assert dict(timer.counts) == {"kernel_library": 1}
