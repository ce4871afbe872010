"""The operation and byte counts against hand counts at ViT-B/16 and FiT base
shapes, an eval batch of 32 clips x 4 frames and 32 captions."""

import pytest

from port_bench import harness, peaks
from port_bench.families import clip, fit

CLIP = harness.load_json(harness.PACKAGE / "configs" / "clip_vit_b16.json")
FIT = harness.load_json(harness.PACKAGE / "configs" / "fit_base.json")


def total(calls, family, what="ops"):
    return sum(getattr(c, what) for c in calls if c.family == family)


def test_clip_int8_gemm_operations():
    calls = clip.eval_calls(CLIP, "int8", 32, 32)
    vision_rows = 32 * 4 * 197          # 25,216
    text_rows = 32 * 77                 # 2,464
    per_vision_row = 768 * 2304 + 768 * 768 + 768 * 3072 + 3072 * 768   # 7,077,888
    per_text_row = 512 * 1536 + 512 * 512 + 512 * 2048 + 2048 * 512     # 3,145,728
    expected = 2 * 12 * (vision_rows * per_vision_row + text_rows * per_text_row)
    assert total(calls, "int8_gemm") == expected == 2 * 12 * (178_476_023_808 + 7_751_073_792)
    assert sum(c.family == "int8_gemm" for c in calls) == 4 * 24


def test_clip_in_projection_bytes_and_least_time():
    in_proj = clip.eval_calls(CLIP, "int8", 32, 32)[1]
    assert in_proj.family == "int8_gemm"
    # int8 rows and weight in, bf16 out, fp32 bias and scale.
    expected = 25_216 * 768 + 768 * 2304 + 25_216 * 2304 * 2 + 2 * 2304 * 4
    assert in_proj.nbytes == expected
    assert in_proj.least_seconds() == max(2 * 25_216 * 768 * 2304 / 1979e12, expected / 3.35e12)


def test_clip_attention_operations():
    calls = clip.eval_calls(CLIP, "int8", 32, 32)
    vision = 4 * 128 * 12 * 64 * 197 * 197
    text = 4 * 32 * 8 * 64 * (77 * 78 / 2)   # causal: the lower triangle
    assert total(calls, "attention") == pytest.approx(12 * (vision + text), rel=1e-12)
    # bf16 qkv in, int8 out
    assert total(calls, "attention", "nbytes") == 12 * (25_216 * (2304 * 2 + 768)
                                                        + 2_464 * (1536 * 2 + 512))


def test_fit_operations():
    calls = fit.eval_calls(FIT, "int8", 32, 32)
    rows = 32 * 785
    per_row = 2 * (768 * 2304 + 768 * 768) + 768 * 3072 + 3072 * 768    # 9,437,184
    assert total(calls, "int8_gemm") == 2 * 12 * rows * per_row
    time = 196 * 4 * 5 + 785            # each location over [CLS | 4 frames], and the CLS row
    space = 4 * 196 * 197 + 785         # each frame's patches over [CLS | 196], and the CLS row
    assert total(calls, "fit_attention") == 4 * 32 * 12 * 64 * (time + space) * 12
    text_rows = 32 * 77
    assert total(calls, "text_gemm") == 2 * 6 * text_rows * (4 * 768 * 768 + 2 * 768 * 3072)


def test_clip_train_step_counts_forward_backward_and_teacher():
    calls = clip.train_calls(CLIP, 64, 32)
    forward = clip.forward_calls(CLIP, 64, 64, "gemm", "attention")
    dense_forward = total(forward, "gemm") + total(forward, "projection")
    assert total(calls, "gemm_bwd") == 2 * dense_forward
    teacher = clip.forward_calls(CLIP, 32, 32, "bf16_gemm", "attention_block")
    assert total(calls, "bf16_gemm") == total(teacher, "bf16_gemm")
    vision = 10 * 256 * 12 * 64 * 197 * 197
    text = 10 * 64 * 8 * 64 * (77 * 78 / 2)
    assert total(calls, "attention_bwd") == pytest.approx(12 * (vision + text), rel=1e-12)


def test_least_time_is_the_larger_bound():
    assert peaks.least_seconds(1979e12, 0, "int8") == 1.0
    assert peaks.least_seconds(0, 3.35e12, "bfloat16") == 1.0
    for call in clip.eval_calls(CLIP, "int8", 32, 32):
        assert call.least_seconds() == max(call.ops / peaks.OPS_PER_S[call.precision],
                                           call.nbytes / peaks.HBM_BYTES_PER_S)
