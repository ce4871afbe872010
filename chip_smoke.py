#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fitclip_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --train-steps [DIR]   # phase 6 (d) alone, for DIR's package

Drives seven paths at full width, with weights initialized from a seed: int8
CLIP ViT-B/16 zero-shot encoding, CLIP training (contrastive and FitCLIP
teacher-student, through ``run_train``), Frozen-in-Time base zero-shot
encoding (int8 and bf16), the S3D-G family (MIL-NCE bf16 and int8, VideoCLIP
bf16), CLIP ViT-B/16 bf16 on the float layer kernels (K2), SLIP ViT-B/16 in
four configurations, and the port's benchmarks (``python -m
fitclip_torch.bench``: the ablation arms S1-S3 and the encode bench). It fails
(non-zero exit) if any phase fails:

1. device: needs CUDA; prints the card and its power limit;
2. build: compiles fitclip_torch/csrc/*.cu for sm_90a (fitclip_torch/_build.py);
3. kernels: each Hopper kernel against its plain PyTorch version on the card,
   at the main paths' shapes (ViT-B/16 vision: 32 frames x 197 tokens x 768;
   text: 8 x 77 x 512; the attention backward at the training shapes, 128
   frames x 197 x 2304 and 32 x 77 x 1536 causal, in bf16 and fp32, timed in
   bf16 at both; FiT base:
   K4's int8 attention cores on the joint 32 x 785 x 2304 qkv, K5 on 128 frame
   groups of 196 rows, K6 on 32 x 784 x 2304; the S3D-G stem, K7, on 32 clips x
   16 frames of 224^2; the float layer's kernels, K2, at 32 x 197 x 768 with its
   GEMMs at M = 6304 and (N, K) = (2304, 768), (768, 768), (3072, 768),
   (768, 3072), its attention also at 8 x 77 causal; K8 at 32 x 197 x 768;
   the repaired shapes: fp32 attention at L = 577 (forward and backward on
   their global variants, V and g read through L2) and every attention mode
   and the backward at head_dim 32 (ViT-S/16, 32 x 197 x 384, 6 heads); bf16
   attention past 208 keys on the mma sweep (8 x 257 and 4 x 577, 16 heads,
   full and causal with seq_valid, every shipped mode, and the backward there
   and at 1 x 900 on its global body); the bench kernels at the benches'
   production shapes: S1's LN, attention and fc-epilogue modes on 512 frames
   x 197 x 768, S2's modes, amax pass and s8 attention on 512 x 197 x 2304,
   slice-requant on 32 x 785 x 2304).
   int8 outputs may differ by one step on at most 0.1% of
   the elements; float outputs stay within atol/rtol 2e-2 of the plain version
   run in fp32, the stem's within one bf16 ulp on all but 0.1%; two launches of
   each shipped attention mode, of the attention backward, of each FiT kernel
   and of the stem give the same bits. Each timed kernel gets
   its plain time, its bound (bytes over 3.35 TB/s or operations over the
   peak of their type) and, where one PyTorch call computes the same function
   (scaled_dot_product_attention; torch._int_mm for the int8 GEMMs' product
   only; torch.addmm for the bf16 bias GEMM; F.layer_norm for ln_cast), that
   call's time;
4. the CLIP slice: load, fold the pixel normalization, calibrate on 8 clips and
   32 token rows, encode 8 clips and 8 token rows. The launch counters, zeroed
   just before and read just after, must show calibration through the qkv-mode
   attention kernel and K1's kernels on 12 layers of each tower. Gates: the
   kernel path against the plain path on the card, and int8 against the bf16
   float model, both towers, min-row cosine > 0.999; finite text x video scores;
5. timings (CUDA events, after warm-up): the CLIP slice's clips/s at 32 clips,
   and profiler tables of the int8 and bf16 (module path) encodes. This
   profile and those of phases 7 and 9 require the tensor-core attention
   bodies (attention_mma_kernel, space_mma_kernel) by kernel name, and no
   CUDA-core attention body (attention_kernel_f32, space_kernel_f32): every
   bf16 attention runs on the tensor cores;
6. training: bf16 compute, fp32 master weights, fused attention, fused AdamW,
   synthetic uint8 video and token ids from a seed, through ``run_train``:
   (a) contrastive, 32 clips x 4 frames, config/trainer.yaml's optimizer and
       temperature, 5 steps: 24 launches each of the attention forward and
       backward kernels per step; the losses within relative 2e-2 of the same
       steps with the plain attention (forward and backward); the gradient
       reaches in_proj through the attention;
   (b) teacher-student, 8 labeled + 8 unlabeled clips, labeled share 0.9999,
       the calibrated int8 encoder of phase 4 as the frozen teacher on K1's
       kernels, 3 steps with finite losses and counted launches;
   (c) resume: 3 steps, checkpoint, restore, 2 more equal (a)'s 5 straight
       steps bit for bit (params and AdamW moments);
   (d) timings: contrastive and teacher-student step ms (the median of 5
       chains of 3 steps after warm-up, with min and max), clips/s, peak
       memory, and a profile of one step of each by group: the attention
       backward (K3b), the forward attention, the port's GEMM and LN kernels,
       cuBLAS, the optimizer; the contrastive and teacher-student profiles
       require K3b's tensor-core kernels (rows_mma_kernel, columns_mma_kernel)
       by name and no CUDA-core backward body. ``--train-steps DIR`` runs this
       part alone for the package under DIR (the parent's, say), on batches of
       its own;
7. Frozen-in-Time base (Bain et al., ICCV 2021: 12 SpaceTimeBlocks of width
   768, 4 frames of 196 patches, DistilBERT, projection 256): load int8 and
   bf16 from seed 0 with device="cuda", calibrate the int8 encoder on 8 clips,
   encode 32 clips x 4 frames and 256 WordPiece-shaped rows x 77. Launch
   counts per path: calibration and text launch nothing, the int8 encode runs
   12 launches per block of K4's kernels, the bf16 encode K5 and K6 once per
   block. Gates, min-row cosine over the video embeddings: (i) each kernel
   path against the same model through the plain versions on the card, (ii)
   int8 against bf16, both > 0.999; finite text embeddings. Timings: int8 and
   bf16 clips/s, text rows/s, peak memory, and torch.profiler breakdowns of
   the int8 and bf16 encodes by kernel with the device's busy share;
8. the S3D-G family, from seed 0 with device="cuda": MIL-NCE (Miech et al.,
   CVPR 2020: S3D-G on 16 frames of 224^2, 512-d, word-embedding text tower)
   bf16 and int8 (calibrated on 8 clips), 32 clips and 256 rows x 20 ids;
   VideoCLIP (Xu et al., EMNLP 2021: BertConfig(), 6 video and 12 text layers)
   bf16, 8 videos x 32 frames and 256 rows x 64 ids. Launch counts per path: one
   stem launch per encode and per calibration, 15 int8 GEMMs in the int8
   encode, none for text. Gates, min-row cosine over the video embeddings: (i)
   each kernel path against the plain versions on the card > 0.999, (ii)
   MIL-NCE int8 against bf16 > 0.99; finite text embeddings; mean row norms.
   Timings: clips/s, videos/s, text rows/s, peak memory, and a profiler table
   of the bf16 MIL-NCE encode by kernel with the device's busy share;
9. the float layer and SLIP (run after phase 5, on phase 4's inputs):
   (a) CLIP ViT-B/16 bf16 loaded with fused_block=True: K2's seven launches
       per layer on 12 layers of each tower and nothing else; gates, min-row
       cosine > 0.999: (i) K2 against fused_bf16_layer_plain on the card,
       (ii) K2 against the bf16 module path (bench.py's gate 3); clips/s at 32
       clips;
   (b) SLIP ViT-B/16 (Mu et al., ECCV 2022) from seed 0: int8 calibrated on 8
       clips and 32 rows, then four paths on 8 clips and 8 rows: int8
       fused_block (K1, exact GELU in the vision tower), bf16 fused_block
       (K2), the bf16 module path (K3f) and the int8 module path with fused
       attention (K8 once per layer, the static denses on int8_gemm_bias).
       Launch counts per path; gates > 0.999: (i) each path against its plain
       versions on the card, (ii) int8 against bf16, both towers
       (scripts/bench_families.py's gate), (iii) K8's path against K1's;
       clips/s at 32 clips, text rows/s at 256 x 77, peak memory per path;
10. the bench path (fitclip_torch/bench), after phase 8: (a) every arm of S1
    (scripts/bench_block_layer.py), S2 (bench_attn_int8.py) and S3
    (bench_fit_block.py) against its plain twin on the card at 32 frames (S3:
    8 clips of the seeded, calibrated FiT base block 0): S1's arms and S2's
    cores under the float rule (`i8qkav`'s int8 weights under the int8 rule: an
    output may move by one weight step on at most 0.1% of its elements), S3's
    whole int8 blocks at most 0.5% of outputs past the float rule and each
    row's update (output - input) at cosine > 0.999, with a planted wrong arm
    (`nocls` held as `full`) that this rule must reject, and S1s (two CUDA
    streams) bit for bit against `full`; (b) with the launch counts zeroed,
    every arm of the three benches, once, at its script's production shape
    through the benches' own ``run`` (ms, cos_vs_full or min cosine against
    the fp32 oracle, TFLOP/s; SDPA beside S2's `bf16`; the cases that only
    rename an arm print ``same_function_as``), then one encode reading each
    for int8 and bf16 at 128 clips with bench.py's gates; every bench kernel
    must show launches there.

TF32 is off for matmuls and cuDNN throughout, so fp32 references are fp32.
The last two lines are the kernels' JSON record (the attention rows also
name their __global__ body under "kernel") and the card line from nvidia-smi
before the final {"ok": true, "device": {...}} line.
"""

import contextlib
import copy
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
VISION = dict(batch=32, seq=197, width=768, heads=12)
TEXT = dict(batch=8, seq=77, width=512, heads=8)
# The attention backward at the training step's shapes: 32 clips x 4 frames.
TRAIN_VISION = dict(VISION, batch=128)
TRAIN_TEXT = dict(TEXT, batch=32)
# Frozen-in-Time base (Bain et al., ICCV 2021, base_patch16_224): 32 clips x 4
# frames of 196 patches + the CLS row, width 768, 12 heads.
FIT = dict(clips=32, frames=4, patches=196, width=768, heads=12)
FIT_LAYERS = 12
FIT_INT8_LAUNCHES_PER_LAYER = {"ln_quant": 3, "int8_gemm_bias": 2, "int8_gemm_residual": 3,
                               "int8_gemm_gelu": 1, "fit_cls_attention_int8": 2,
                               "fit_time_attention_int8": 1, "fit_space_attention_int8": 1}
FIT_BF16_LAUNCHES_PER_LAYER = {"fused_attention_qkv_gkv": 1, "fused_time_attention": 1}
# S3D-G: MIL-NCE (Miech et al., CVPR 2020: S3D-G over 16 frames of 224^2, 512-d; text:
# 300-d word embeddings over 66,250 words, fc 2048, 20 tokens) and VideoCLIP (Xu et al.,
# EMNLP 2021: BertConfig(), 6 video and 12 text layers, 32-frame clips).
MIL_NCE = dict(clips=32, frames=16, size=224, calib=8, text_rows=256, tokens=20, vocab=66250)
VIDEOCLIP = dict(videos=8, frames=32, text_rows=256, tokens=64)
S3DG_INT8_SITES = 15  # 7 blocks from mixed_4b x (merged, b3) + fc
S3DG_GATE_INT8 = 0.99  # int8 against bf16, tests/test_s3dg_fast.py:127
INT8_MAX_FLIPPED = 1e-3  # share of int8 elements allowed one step off
FLOAT_TOL = 2e-2
GATE_COSINE = 0.999
# Share of a whole int8 FiT block's outputs allowed past the float rule: an
# int8 activation that rounds the other way before the MLP moves many outputs
# by a few fc2 steps (0.14% seen on the H100 at 8 clips).
LAYER_MAX_OVER = 5e-3
LOSS_RTOL = 2e-2  # kernel path vs plain attention, per training step
LAYERS = 12  # of each ViT-B/16 tower
INT8_LAUNCHES_PER_LAYER = {"ln_quant": 2, "int8_gemm_bias": 1, "int8_gemm_residual": 2,
                           "int8_gemm_gelu": 1, "attention_int8": 1}
K2_LAUNCHES_PER_LAYER = {"ln_cast": 2, "bf16_gemm_bias": 1, "bf16_gemm_residual": 2,
                         "bf16_gemm_gelu": 1, "attention_block": 1}


def require(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(f"chip_smoke: {message}")


def nvidia_smi() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The least time the card could take (H100 SXM datasheet peaks):
# the bytes a function must move over the memory rate, or its operations over
# the peak rate of their type, whichever is larger.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def bound(bytes_moved: float, ops, kind: str = None):
    """(bound_ms, "bytes" or "operations"). ops is a count of one kind, or
    {kind: count} for work of several types (K8's int8 GEMM and bf16 attention)."""
    ops = ops if isinstance(ops, dict) else {kind: ops}
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def timing(kernel_ms, plain_ms, library_ms, bound_pair):
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_pair[0], "bound_by": bound_pair[1]}


def sdpa_ms(torch, q, k, v, scale, backward=False, causal=False):
    """One F.scaled_dot_product_attention call on (N, H, S, D) operands
    (the yardstick of an attention kernel; the port never calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not backward:
        return cuda_ms(lambda: sdpa(q, k, v, scale=scale, is_causal=causal))
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = sdpa(q, k, v, scale=scale, is_causal=causal)
    grad = torch.ones_like(out)
    return cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), grad, retain_graph=True))


def heads_first(qkv, heads):
    """(B, L, 3*H*D) -> q, k, v as contiguous (B, H, L, D)."""
    b, seq, triple = qkv.shape
    return [t.reshape(b, seq, heads, -1).transpose(1, 2).contiguous()
            for t in qkv.split(triple // 3, dim=-1)]


@contextlib.contextmanager
def swapped(module, **replacements):
    """Module attributes replaced for the duration (a plain version for a kernel)."""
    saved = {name: getattr(module, name) for name in replacements}
    for name, value in replacements.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def min_cosine(a, b) -> float:
    import torch

    a, b = a.float(), b.float()
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


class KernelChecks:
    """Kernel-vs-plain comparisons, with the largest error seen per kernel."""

    def __init__(self):
        self.max_abs_err = {}

    def _record(self, name, err):
        self.max_abs_err[name] = max(self.max_abs_err.get(name, 0.0), err)

    def int8(self, name, what, kernel_out, plain_out):
        import torch

        torch.cuda.synchronize()
        diff = (kernel_out.int() - plain_out.int()).abs()
        err, flipped = int(diff.max()), float((diff != 0).float().mean())
        print(f"  {name} {what}: max |diff| {err} LSB, {flipped:.2e} of elements differ")
        require(err <= 1 and flipped <= INT8_MAX_FLIPPED,
                f"{name} {what}: int8 output off by {err} LSB on {flipped:.2e} of elements")
        self._record(name, float(err))

    def bf16_ulp(self, name, what, kernel_out, plain_fp32):
        """A bf16 output within one bf16 ulp of the plain fp32 result on all but
        INT8_MAX_FLIPPED of its elements."""
        import torch

        torch.cuda.synchronize()
        k = kernel_out.float()
        diff = (k - plain_fp32).abs()
        ulp = torch.exp2(torch.floor(torch.log2(plain_fp32.abs().clamp_min(1e-38))) - 7)
        over, err = float((diff > ulp).float().mean()), float(diff.max())
        print(f"  {name} {what}: max |diff| {err:.3e}, {over:.2e} of elements beyond one bf16 "
              f"ulp of the plain version in fp32")
        require(bool(torch.isfinite(k).all()), f"{name} {what}: non-finite output")
        require(over <= INT8_MAX_FLIPPED, f"{name} {what}: {over:.2e} of elements beyond one ulp")
        self._record(name, err)

    def s8(self, name, what, kernel_out, plain_fp32, step):
        """The float rule, with S2's int8 attention weights under the int8 rule:
        a weight rint(w * 127) may round the other way (its softmax sums in
        another order), moving an output by up to ``step`` (v_amax / 127), on
        at most INT8_MAX_FLIPPED of the elements."""
        import torch

        torch.cuda.synchronize()
        k = kernel_out.float()
        diff = (k - plain_fp32).abs()
        err = float(diff.max())
        over = float((diff > FLOAT_TOL + FLOAT_TOL * plain_fp32.abs()).float().mean())
        print(f"  {name} {what}: max |diff| {err:.3e}, {over:.2e} of elements beyond the float "
              f"rule (one weight step {step:.3e})")
        require(bool(torch.isfinite(k).all()), f"{name} {what}: non-finite output")
        require(over <= INT8_MAX_FLIPPED and err <= FLOAT_TOL + step,
                f"{name} {what}: max |diff| {err}, {over:.2e} of elements beyond the float rule")
        self._record(name, err)

    def layer(self, name, what, kernel_out, plain_fp32, x):
        """A whole int8 FiT block on input x against its plain twin. Its
        kernels meet the int8 and float rules one by one (above), but an int8
        activation that rounds the other way carries whole steps through the
        later GEMMs: at most LAYER_MAX_OVER of the outputs may be past the
        float rule, and each row's update (output - x, what the block adds to
        the residual stream, which x would dominate) keeps a cosine above
        GATE_COSINE."""
        import torch

        torch.cuda.synchronize()
        k = kernel_out.float()
        diff = (k - plain_fp32).abs()
        err = float(diff.max())
        over = float((diff > FLOAT_TOL + FLOAT_TOL * plain_fp32.abs()).float().mean())
        cos = min_cosine((k - x.float()).flatten(0, -2), (plain_fp32 - x.float()).flatten(0, -2))
        print(f"  {name} {what}: min row cosine of the update {cos:.6f}; max |diff| {err:.3e}, "
              f"{over:.2e} of elements beyond the float rule")
        require(bool(torch.isfinite(k).all()), f"{name} {what}: non-finite output")
        require(cos > GATE_COSINE and over <= LAYER_MAX_OVER,
                f"{name} {what}: min row cosine of the update {cos}, {over:.2e} of elements "
                f"beyond the float rule")
        self._record(name, err)

    def float(self, name, what, kernel_out, plain_fp32):
        import torch

        torch.cuda.synchronize()
        k = kernel_out.float()
        err = float((k - plain_fp32).abs().max())
        print(f"  {name} {what}: max |diff| {err:.3e} against the plain version in fp32")
        require(bool(torch.isfinite(k).all()), f"{name} {what}: non-finite output")
        require(torch.allclose(k, plain_fp32, atol=FLOAT_TOL, rtol=FLOAT_TOL),
                f"{name} {what}: max |diff| {err} beyond atol/rtol {FLOAT_TOL}")
        self._record(name, err)


def kernel_phase(torch, checks: KernelChecks):
    """Phase 3: each kernel against its plain version; returns {name: timing(...)}."""
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import block as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def normal(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    times = {}
    for tag, s in (("vision", VISION), ("text", TEXT)):
        m, w = s["batch"] * s["seq"], s["width"]
        timed = tag == "vision"

        # ln_quant: the bf16 layer input and the fp32 mid-layer residual.
        gamma, beta = 1 + normal(w, std=0.1), normal(w, std=0.1)
        for what, x in (("bf16 input", normal(m, w, dtype=torch.bfloat16)),
                        ("fp32 residual", normal(m, w, std=3.0))):
            inv = 127.0 / 4.0
            checks.int8("ln_quant", f"{tag} {what}", K.ln_quant(x, gamma, beta, inv),
                        K.ln_quant_plain(x, gamma, beta, inv))
            if timed and what == "bf16 input":
                times["ln_quant"] = timing(
                    cuda_ms(lambda: K.ln_quant(x, gamma, beta, inv)),
                    cuda_ms(lambda: K.ln_quant_plain(x, gamma, beta, inv)), None,
                    bound(m * w * 2 + m * w + 2 * w * 4, 9 * m * w, "fp32"))

        # int8 GEMM, its three epilogues at the layer's four shapes.
        a_w, a_4w = int8(m, w), int8(m, 4 * w)
        wq, wo, wf, wp = int8(3 * w, w), int8(w, w), int8(4 * w, w), int8(w, 4 * w)
        scale = lambda n, k: (torch.rand(n, generator=gen, device=dev) + 0.5) / (73.0 * 73.0 * k ** 0.5)
        sq, bq = scale(3 * w, w), normal(3 * w, std=0.1)
        out = K.int8_gemm_bias(a_w, wq, sq, bq, torch.bfloat16)
        checks.float("int8_gemm_bias", f"{tag} qkv", out,
                      K.int8_gemm_bias_plain(a_w, wq, sq, bq, torch.float32))
        if timed:  # library: torch._int_mm, the product only, no epilogue
            times["int8_gemm_bias"] = timing(
                cuda_ms(lambda: K.int8_gemm_bias(a_w, wq, sq, bq, torch.bfloat16)),
                cuda_ms(lambda: K.int8_gemm_bias_plain(a_w, wq, sq, bq, torch.bfloat16)),
                cuda_ms(lambda: torch._int_mm(a_w, wq.t())),
                bound(m * w + 3 * w * w + 3 * w * 8 + m * 3 * w * 2, 2 * m * 3 * w * w, "int8"))

        so, bo, x_in = scale(w, w), normal(w, std=0.1), normal(m, w, dtype=torch.bfloat16)
        out = K.int8_gemm_residual(a_w, wo, so, bo, x_in, torch.float32)
        checks.float("int8_gemm_residual", f"{tag} out-proj (bf16 -> fp32)", out,
                     K.int8_gemm_residual_plain(a_w, wo, so, bo, x_in, torch.float32))
        sp, bp, x32 = scale(w, 4 * w), normal(w, std=0.1), normal(m, w)
        out = K.int8_gemm_residual(a_4w, wp, sp, bp, x32, torch.bfloat16)
        checks.float("int8_gemm_residual", f"{tag} proj (fp32 -> bf16)", out,
                     K.int8_gemm_residual_plain(a_4w, wp, sp, bp, x32, torch.float32))
        if timed:
            times["int8_gemm_residual"] = timing(
                cuda_ms(lambda: K.int8_gemm_residual(a_4w, wp, sp, bp, x32, torch.bfloat16)),
                cuda_ms(lambda: K.int8_gemm_residual_plain(a_4w, wp, sp, bp, x32,
                                                           torch.bfloat16)),
                cuda_ms(lambda: torch._int_mm(a_4w, wp.t())),
                bound(m * 4 * w + 4 * w * w + w * 8 + m * w * 4 + m * w * 2,
                      2 * m * w * 4 * w, "int8"))

        inv_p = 127.0 / 6.0
        fs2, fb2 = scale(4 * w, w) * 20.0, normal(4 * w, std=2.0)  # t ~ 20 N(0, 1)
        for quick in (True, False):
            kv = (-1.702 * K.LOG2E / inv_p) if quick else (0.7071067811865475 / inv_p)
            checks.int8("int8_gemm_gelu", f"{tag} fc ({'quick' if quick else 'exact'} GELU)",
                        K.int8_gemm_gelu(a_w, wf, fs2, fb2, kv, quick),
                        K.int8_gemm_gelu_plain(a_w, wf, fs2, fb2, kv, quick))
            if timed and quick:
                times["int8_gemm_gelu"] = timing(
                    cuda_ms(lambda: K.int8_gemm_gelu(a_w, wf, fs2, fb2, kv, True)),
                    cuda_ms(lambda: K.int8_gemm_gelu_plain(a_w, wf, fs2, fb2, kv, True)),
                    cuda_ms(lambda: torch._int_mm(a_w, wf.t())),
                    bound(m * w + 4 * w * w + 4 * w * 8 + m * 4 * w, 2 * m * 4 * w * w, "int8"))

        # Attention, both modes. Vision is not causal (and once with seq_valid < L);
        # text is causal.
        b, seq, heads = s["batch"], s["seq"], s["heads"]
        causal = tag == "text"
        qkv = normal(b, seq, 3 * w, std=1.5, dtype=torch.bfloat16)
        scale_q = (w // heads) ** -0.5
        out_mul = 127.0 / 2.5
        valids = (None, 150) if tag == "vision" else (None,)
        for valid in valids:
            what = f"{tag} {'causal' if causal else 'full'}" + (f", seq_valid {valid}" if valid else "")
            checks.int8("attention_int8", what,
                        A.attention_int8(qkv, heads, scale_q, causal, out_mul, valid),
                        A.attention_int8_plain(qkv, heads, scale_q, causal, out_mul, valid))
        checks.float("fused_attention_qkv", f"{tag} {'causal' if causal else 'full'}",
                     A.fused_attention_qkv(qkv, heads, scale_q, causal),
                     A.attention_core_plain(qkv.float(), heads, scale_q, causal))
        for name, fn in (("attention_int8", lambda: A.attention_int8(qkv, heads, scale_q, causal,
                                                                     out_mul, valids[-1])),
                         ("fused_attention_qkv", lambda: A.fused_attention_qkv(qkv, heads, scale_q,
                                                                               causal)),
                         ("attention_block", lambda: A.attention_block(qkv, heads, scale_q,
                                                                       causal))):
            require(torch.equal(fn(), fn()), f"{name} {tag}: two launches differ")
        print(f"  attention_int8, fused_attention_qkv, attention_block {tag}: two launches "
              f"bit-identical")
        if timed:
            ops = 4 * b * heads * seq * seq * (w // heads)
            times["attention_int8"] = timing(
                cuda_ms(lambda: A.attention_int8(qkv, heads, scale_q, causal, out_mul)),
                cuda_ms(lambda: A.attention_int8_plain(qkv, heads, scale_q, causal, out_mul)),
                None, bound(b * seq * 3 * w * 2 + b * seq * w, ops, "bf16"))
            times["fused_attention_qkv"] = timing(
                cuda_ms(lambda: A.fused_attention_qkv(qkv, heads, scale_q, causal)),
                cuda_ms(lambda: A.attention_core_plain(qkv, heads, scale_q, causal)),
                sdpa_ms(torch, *heads_first(qkv, heads), scale_q),
                bound(b * seq * 3 * w * 2 + b * seq * w * 2, ops, "bf16"))

    # The attention backward (K3b) at the training shapes, bf16 and fp32.
    name = "fused_attention_qkv_backward"
    for tag, s in (("vision", TRAIN_VISION), ("text", TRAIN_TEXT)):
        b, seq, w, heads = s["batch"], s["seq"], s["width"], s["heads"]
        causal = tag == "text"
        scale_q = (w // heads) ** -0.5
        qkv32, grad32 = normal(b, seq, 3 * w, std=1.5), normal(b, seq, w)
        for dtype in (torch.bfloat16, torch.float32):
            qkv, grad = qkv32.to(dtype), grad32.to(dtype)
            what = f"{tag} {b} x {seq} x {3 * w} {str(dtype)[6:]}{' causal' if causal else ''}"
            out = A.fused_attention_qkv_backward(qkv, grad, heads, scale_q, causal)
            checks.float(name, what, out, A.attention_backward_plain(
                qkv.float(), grad.float(), heads, scale_q, causal))
            again = A.fused_attention_qkv_backward(qkv, grad, heads, scale_q, causal)
            require(torch.equal(out, again), f"{name} {what}: two launches differ")
            print(f"  {name} {what}: two launches bit-identical")
            if dtype == torch.bfloat16:
                # Under causal only the pairs at or below the diagonal are computed.
                pairs = seq * (seq + 1) // 2 if causal else seq * seq
                timed = timing(
                    cuda_ms(lambda: A.fused_attention_qkv_backward(qkv, grad, heads, scale_q,
                                                                   causal)),
                    cuda_ms(lambda: A.attention_backward_plain(qkv, grad, heads, scale_q,
                                                               causal)),
                    sdpa_ms(torch, *heads_first(qkv, heads), scale_q, backward=True,
                            causal=causal),
                    bound(b * seq * 3 * w * 2 * 2 + b * seq * w * 2,
                          10 * b * heads * pairs * (w // heads), "bf16"))
                print(f"  {name} {what}: {timed['ms']:.4f} ms, plain {timed['plain_ms']:.4f} "
                      f"ms, bound {timed['bound_ms']:.4f} ms ({timed['bound_by']}), SDPA "
                      f"backward {timed['library_ms']:.4f} ms")
                if tag == "vision":
                    times[name] = timed
                else:  # the text tower's shape rides in the kernel's record
                    times[name]["text"] = dict(timed, shape=f"{b} x {seq} x {3 * w} causal")
            del out, again
    return times


def float_layer_kernel_phase(torch, checks: KernelChecks):
    """Phase 3, the float layer (K2) and K8 at ViT-B/16 shapes: ln_cast on the
    32 x 197 x 768 rows, the bf16 GEMM's three epilogues at M = 6304 and (N, K) =
    (2304, 768), (768, 768), (3072, 768), (768, 3072), the block-mode attention
    at 32 x 197 (and with seq_valid) and 8 x 77 causal, K8 at 32 x 197. Each is
    held against its plain version in fp32 on the same inputs. Returns
    {name: timing(...)}."""
    import torch.nn.functional as F

    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import block as K

    gen = torch.Generator(device="cuda").manual_seed(10)
    dev = "cuda"

    def normal(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    times = {}
    b, seq, w, heads = (VISION[k] for k in ("batch", "seq", "width", "heads"))
    m, d = b * seq, w // heads

    # ln_cast: the bf16 layer input and the fp32 mid-layer residual, eps 1e-6.
    gamma, beta = 1 + normal(w, std=0.1), normal(w, std=0.1)
    x_bf16 = normal(m, w, dtype=torch.bfloat16)
    for what, x in (("bf16 input", x_bf16), ("fp32 residual", normal(m, w, std=3.0))):
        checks.float("ln_cast", f"vision {what}", K.ln_cast(x, gamma, beta, torch.bfloat16, 1e-6),
                     K.layer_norm_plain(x, gamma, beta, 1e-6))
    g16, b16 = gamma.bfloat16(), beta.bfloat16()
    times["ln_cast"] = timing(
        cuda_ms(lambda: K.ln_cast(x_bf16, gamma, beta, torch.bfloat16, 1e-6)),
        cuda_ms(lambda: K.ln_cast_plain(x_bf16, gamma, beta, torch.bfloat16, 1e-6)),
        cuda_ms(lambda: F.layer_norm(x_bf16, (w,), g16, b16, 1e-6)),
        bound(m * w * 2 * 2 + 2 * w * 4, 9 * m * w, "fp32"))

    # The bf16 GEMM: weights ~ N(0, 1/K), as LeCun-normal weights are.
    def weight(n, k):
        return normal(n, k, std=k ** -0.5, dtype=torch.bfloat16)

    wq, wo, wf, wp = weight(3 * w, w), weight(w, w), weight(4 * w, w), weight(w, 4 * w)
    qb, ob, fb, pb = (normal(n, std=0.1) for n in (3 * w, w, 4 * w, w))
    a_w, a_4w = normal(m, w, dtype=torch.bfloat16), normal(m, 4 * w, dtype=torch.bfloat16)
    checks.float("bf16_gemm_bias", "vision qkv (6304 x 2304 x 768)", K.bf16_gemm_bias(a_w, wq, qb),
                 K._dense_plain(a_w, wq, qb))
    qb16 = qb.bfloat16()
    times["bf16_gemm_bias"] = timing(
        cuda_ms(lambda: K.bf16_gemm_bias(a_w, wq, qb)),
        cuda_ms(lambda: K.bf16_gemm_bias_plain(a_w, wq, qb)),
        cuda_ms(lambda: torch.addmm(qb16, a_w, wq.t())),
        bound(m * w * 2 + 3 * w * w * 2 + 3 * w * 4 + m * 3 * w * 2, 2 * m * 3 * w * w, "bf16"))
    out = K.bf16_gemm_residual(a_w, wo, ob, x_bf16, torch.float32)
    checks.float("bf16_gemm_residual", "vision out-proj (bf16 -> fp32)", out,
                 K.bf16_gemm_residual_plain(a_w, wo, ob, x_bf16, torch.float32))
    x32 = normal(m, w)
    checks.float("bf16_gemm_residual", "vision proj (fp32 -> bf16, K = 3072)",
                 K.bf16_gemm_residual(a_4w, wp, pb, x32, torch.bfloat16),
                 K.bf16_gemm_residual_plain(a_4w, wp, pb, x32, torch.float32))
    times["bf16_gemm_residual"] = timing(
        cuda_ms(lambda: K.bf16_gemm_residual(a_4w, wp, pb, x32, torch.bfloat16)),
        cuda_ms(lambda: K.bf16_gemm_residual_plain(a_4w, wp, pb, x32, torch.bfloat16)), None,
        bound(m * 4 * w * 2 + 4 * w * w * 2 + w * 4 + m * w * 4 + m * w * 2, 2 * m * w * 4 * w,
              "bf16"))
    for quick in (True, False):
        h = K._dense_plain(a_w, wf, fb)
        ref = h * torch.sigmoid(1.702 * h) if quick else K.exact_gelu_plain(h)
        checks.float("bf16_gemm_gelu", f"vision fc ({'quick' if quick else 'exact'} GELU)",
                      K.bf16_gemm_gelu(a_w, wf, fb, quick), ref)
        del h, ref
    times["bf16_gemm_gelu"] = timing(
        cuda_ms(lambda: K.bf16_gemm_gelu(a_w, wf, fb, False)),
        cuda_ms(lambda: K.bf16_gemm_gelu_plain(a_w, wf, fb, False)), None,
        bound(m * w * 2 + 4 * w * w * 2 + 4 * w * 4 + m * 4 * w * 2, 2 * m * 4 * w * w, "bf16"))
    del a_4w, x32

    # The block-mode attention: vision full (and with seq_valid), text causal.
    scale_q = d ** -0.5
    qkv = normal(b, seq, 3 * w, std=1.5, dtype=torch.bfloat16)
    for what, s, valid in (("vision full", VISION, None), ("vision full, seq_valid 150", VISION, 150),
                           ("text causal", TEXT, None)):
        causal = s is TEXT
        x = qkv if s is VISION else normal(s["batch"], s["seq"], 3 * s["width"], std=1.5,
                                           dtype=torch.bfloat16)
        checks.float("attention_block", what,
                     A.attention_block(x, s["heads"], scale_q, causal, valid),
                     A.attention_core_plain(x.float(), s["heads"], scale_q, causal, 1.0, valid))
    times["attention_block"] = timing(
        cuda_ms(lambda: A.attention_block(qkv, heads, scale_q, False)),
        cuda_ms(lambda: A.attention_block_plain(qkv, heads, scale_q, False)),
        sdpa_ms(torch, *heads_first(qkv, heads), scale_q),
        bound(b * seq * 3 * w * 2 + b * seq * w * 2, 4 * b * heads * seq * seq * d, "bf16"))

    # K8: the int8 QKV projection and the attention, 32 x 197 x 768.
    x_q = torch.randint(-127, 128, (b, seq, w), generator=gen, device=dev, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (3 * w, w), generator=gen, device=dev, dtype=torch.int8)
    k8_scale = (torch.rand(3 * w, generator=gen, device=dev) + 0.5) * 1.5 / (73.0 * 73.0 * w ** 0.5)
    k8_bias = normal(3 * w, std=0.1)
    qkv_k8 = K.int8_gemm_bias_plain(x_q.view(m, w), w_q, k8_scale, k8_bias, torch.bfloat16)
    checks.float("fused_int8_qkv_attention", "vision 32 x 197 x 768",
                 A.fused_int8_qkv_attention(x_q, w_q, k8_scale, k8_bias, heads, scale_q),
                 A.attention_core_plain(qkv_k8.float().view(b, seq, 3 * w), heads, scale_q, False))
    times["fused_int8_qkv_attention"] = timing(
        cuda_ms(lambda: A.fused_int8_qkv_attention(x_q, w_q, k8_scale, k8_bias, heads, scale_q)),
        cuda_ms(lambda: A.fused_int8_qkv_attention_plain(x_q, w_q, k8_scale, k8_bias, heads,
                                                         scale_q)), None,
        bound(m * w + 3 * w * w + 3 * w * 8 + m * w * 2,
              {"int8": 2 * m * 3 * w * w, "bf16": 4 * b * heads * seq * seq * d}))
    return times


def fit_kernel_phase(torch, checks: KernelChecks):
    """Phase 3, Frozen-in-Time: csrc/fit_attention.cu against its plain
    versions at FiT base shapes: K4's three int8-mode cores on the joint
    (32, 785, 2304) qkv, K5 on 128 frame groups of 196 rows, K6 on (32, 784,
    2304); each launched twice for bit-identity. Returns {name: timing(...)}."""
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops.quant import quantize_rint

    gen = torch.Generator(device="cuda").manual_seed(4)
    b, f, p, w, heads = (FIT[k] for k in ("clips", "frames", "patches", "width", "heads"))
    d, n = w // heads, 1 + f * p
    scale, out_mul = d ** -0.5, 127.0 / 2.5

    def normal(*shape):
        return (1.5 * torch.randn(*shape, generator=gen, device="cuda")).to(torch.bfloat16)

    def twice(name, what, fn):
        out = fn()
        require(torch.equal(out, fn()), f"{name} {what}: two launches differ")
        print(f"  {name} {what}: two launches bit-identical")
        return out

    times = {}
    qkv = normal(b, n, 3 * w)
    rows_in = b * n * 3 * w * 2
    what = f"{b} x {n} x {3 * w} bf16"
    out = twice("fit_cls_attention_int8", what, lambda: A.fit_cls_attention_int8(qkv, heads,
                                                                                   out_mul))
    checks.int8("fit_cls_attention_int8", what, out[:, :1],
                quantize_rint(A.cls_attention_plain(qkv, heads, scale, out_mul)))
    times["fit_cls_attention_int8"] = timing(
        cuda_ms(lambda: A.fit_cls_attention_int8(qkv, heads, out_mul, out)),
        cuda_ms(lambda: A.cls_attention_plain(qkv, heads, scale, out_mul)), None,
        bound(b * (w + n * 2 * w) * 2 + b * w, 4 * b * heads * n * d, "bf16"))
    for mode, keys in (("time", f + 1), ("space", p + 1)):
        name = f"fit_{mode}_attention_int8"
        wrapper = getattr(A, name)
        out = twice(name, what, lambda: wrapper(qkv, heads, f, out_mul))
        checks.int8(name, what, out[:, 1:],
                    quantize_rint(A.fit_rows_attention_int8_plain(qkv, heads, f, mode, out_mul)))
        times[name] = timing(
            cuda_ms(lambda: wrapper(qkv, heads, f, out_mul, out)),
            cuda_ms(lambda: A.fit_rows_attention_int8_plain(qkv, heads, f, mode, out_mul)),
            None, bound(rows_in + b * (n - 1) * w, 4 * b * f * p * heads * keys * d, "bf16"))
    del qkv, out

    # K5: 128 frame groups of 196 rows and a global row each.
    groups = normal(b * f, p, 3 * w)
    gkv = normal(b * f, 3 * w)
    what = f"{b * f} x {p} x {3 * w} + gkv bf16"
    out = twice("fused_attention_qkv_gkv", what,
                lambda: A.fused_attention_qkv_gkv(groups, gkv, heads, scale))
    checks.float("fused_attention_qkv_gkv", what, out,
                 A.attention_gkv_plain(groups.float(), gkv.float(), heads, scale))
    q, k, v = heads_first(groups, heads)
    g_k, g_v = (t.reshape(b * f, heads, 1, d) for t in gkv.split(w, dim=-1)[1:])
    times["fused_attention_qkv_gkv"] = timing(
        cuda_ms(lambda: A.fused_attention_qkv_gkv(groups, gkv, heads, scale)),
        cuda_ms(lambda: A.attention_gkv_plain(groups, gkv, heads, scale)),
        sdpa_ms(torch, q, torch.cat([g_k, k], 2), torch.cat([g_v, v], 2), scale),
        bound(b * f * (p + 1) * 3 * w * 2 + b * f * p * w * 2,
              4 * b * f * heads * p * (p + 1) * d, "bf16"))
    del groups, out, q, k, v

    # K6: 32 clips of 4 x 196 rows and their CLS rows.
    rows = normal(b, f * p, 3 * w)
    gkv = normal(b, 3 * w)
    what = f"{b} x {f * p} x {3 * w} + gkv bf16"
    out = twice("fused_time_attention", what,
                lambda: A.fused_time_attention(rows, gkv, heads, f, scale))
    checks.float("fused_time_attention", what, out,
                 A.time_attention_plain(rows.float(), gkv.float(), heads, f, scale))
    # The same function as SDPA: per (clip, location), F queries over [CLS | F frames].
    q, k, v = (t.reshape(b, f, p, heads, d).permute(0, 2, 3, 1, 4).reshape(b * p, heads, f, d)
               for t in rows.split(w, dim=-1))
    g_k, g_v = (t.reshape(b, 1, heads, 1, d).expand(b, p, heads, 1, d).reshape(b * p, heads, 1, d)
                for t in gkv.split(w, dim=-1)[1:])
    times["fused_time_attention"] = timing(
        cuda_ms(lambda: A.fused_time_attention(rows, gkv, heads, f, scale)),
        cuda_ms(lambda: A.time_attention_plain(rows, gkv, heads, f, scale)),
        sdpa_ms(torch, q.contiguous(), torch.cat([g_k, k], 2).contiguous(),
                torch.cat([g_v, v], 2).contiguous(), scale),
        bound(b * (f * p + 1) * 3 * w * 2 + b * f * p * w * 2,
              4 * b * p * heads * f * (f + 1) * d, "bf16"))
    return times


def s3dg_kernel_phase(torch, checks: KernelChecks):
    """Phase 3, S3D-G: the stem kernel (K7) against its plain version at the MIL-NCE
    shape, 32 clips x 16 frames of 224^2 bf16, launched twice for bit-identity.
    Returns {name: timing(...)}; no single PyTorch call computes conv + ReLU + pool,
    so the library time is null (cuDNN's bf16 conv3d alone is printed beside it)."""
    import torch.nn.functional as F

    from fitclip_torch.ops import s3dg_stem as S

    gen = torch.Generator(device="cuda").manual_seed(7)
    b, t, size = MIL_NCE["clips"], MIL_NCE["frames"], MIL_NCE["size"]
    x = torch.rand(b, t, size, size, 3, generator=gen, device="cuda").to(torch.bfloat16)
    kernel = (0.05 * torch.randn(2, 4, 4, 24, 64, generator=gen, device="cuda")).to(torch.bfloat16)
    bias = (0.1 * torch.randn(64, generator=gen, device="cuda")).to(torch.bfloat16)
    what = f"{b} x {t} x {size}^2 bf16"
    out = S.s3dg_stem(x, kernel, bias)
    require(torch.equal(out, S.s3dg_stem(x, kernel, bias)), f"s3dg_stem {what}: two launches differ")
    print(f"  s3dg_stem {what}: two launches bit-identical")
    checks.bf16_ulp("s3dg_stem", what, out, S.s3dg_stem_plain(x.float(), kernel, bias))
    del out
    positions = b * (t // 2) * (size // 2) ** 2
    times = {"s3dg_stem": timing(
        cuda_ms(lambda: S.s3dg_stem(x, kernel, bias)),
        cuda_ms(lambda: S.s3dg_stem_plain(x, kernel, bias), iters=5), None,
        bound(x.numel() * 2 + positions // 4 * 64 * 2 + 768 * 64 * 2 + 64 * 4,
              2 * positions * 768 * 64, "bf16"))}
    s = S.space_to_depth(x).contiguous().permute(0, 4, 1, 2, 3)
    weight = kernel.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    conv_ms = cuda_ms(lambda: F.conv3d(s, weight, padding=(1, 2, 2)), iters=10)
    print(f"  s3dg_stem: for information, cuDNN's bf16 conv3d alone (no bias, ReLU or pool, "
          f"unpooled output) {conv_ms:.4f} ms")
    return times


def fault_kernel_phase(torch, checks: KernelChecks):
    """Phase 3, the repaired shapes: the fp32 attention at L = 577 (ViT-L/14@336;
    the forward reads V through L2, the backward V and g; the function's
    gradient runs through both kernels), bf16 past 208 keys (the forward's and
    the backward rows kernel's sweep) and past 848 (the backward's global
    body), and every attention mode and the backward at head_dim 32 (SLIP
    ViT-S/16: 32 x 197 x 384, 6 heads)."""
    from fitclip_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(11)
    bwd_gen = torch.Generator(device="cuda").manual_seed(13)
    b, seq, heads, d = 2, 577, 16, 64
    qkv = (1.5 * torch.randn(b, seq, 3 * heads * d, generator=gen, device="cuda"))
    scale, out_mul = d ** -0.5, 127.0 / 2.5
    what = f"fp32 {b} x {seq} x {3 * heads * d} (V through L2)"
    checks.float("fused_attention_qkv", what, A.fused_attention_qkv(qkv, heads, scale),
                 A.attention_core_plain(qkv, heads, scale, False))
    checks.int8("attention_int8", what, A.attention_int8(qkv, heads, scale, False, out_mul),
                A.attention_int8_plain(qkv, heads, scale, False, out_mul))
    leaf = qkv.clone().requires_grad_()
    grad = torch.randn(b, seq, heads * d, generator=gen, device="cuda")
    before = A.fused_attention_qkv_backward.launches
    with torch.enable_grad():
        A.fused_attention_qkv(leaf, heads, scale).backward(grad)
    launched = A.fused_attention_qkv_backward.launches - before
    require(launched == 1, f"fp32 L = 577 backward: {launched} kernel launches, not 1")
    checks.float("fused_attention_qkv_backward", f"{what}: through the function", leaf.grad,
                 A.attention_backward_plain(qkv, grad, heads, scale, False))
    again = A.fused_attention_qkv_backward(qkv, grad, heads, scale)
    require(torch.equal(again, leaf.grad), "fp32 L = 577 backward: two launches differ")
    print(f"  fused_attention_qkv_backward: fp32 L = 577 on the global variant, "
          f"{launched} launch through the function, two launches bit-identical")
    kernel_ms = cuda_ms(lambda: A.fused_attention_qkv_backward(qkv, grad, heads, scale), iters=5)
    plain_ms = cuda_ms(lambda: A.attention_backward_plain(qkv, grad, heads, scale, False), iters=5)
    print(f"  fused_attention_qkv_backward {what}, global variant: {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")

    # bf16 past 208 keys: the mma sweep (ViT-L/14's 257, ViT-L/14@336's 577), also
    # causal with seq_valid, under the float and int8 rules.
    for b, seq in ((8, 257), (4, 577)):
        qkv = (1.5 * torch.randn(b, seq, 3 * 16 * 64, generator=gen, device="cuda")).to(
            torch.bfloat16)
        for causal, valid in ((False, None), (True, seq - 57)):
            tag = (f"bf16 {b} x {seq} x {3 * 16 * 64}{' causal' if causal else ''}"
                   f"{f', seq_valid {valid}' if valid else ''} (mma sweep)")
            checks.int8("attention_int8", tag,
                        A.attention_int8(qkv, 16, scale, causal, out_mul, valid),
                        A.attention_int8_plain(qkv, 16, scale, causal, out_mul, valid))
            checks.float("fused_attention_qkv", tag, A.fused_attention_qkv(qkv, 16, scale, causal),
                         A.attention_core_plain(qkv.float(), 16, scale, causal))
            out = A.attention_block(qkv, 16, scale, causal, valid)
            checks.float("attention_block", tag, out,
                         A.attention_core_plain(qkv.float(), 16, scale, causal, 1.0, valid))
            require(torch.equal(out, A.attention_block(qkv, 16, scale, causal, valid)),
                    f"attention_block {tag}: two launches differ")
            # The backward's rows kernel sweeps here too (no seq_valid in training);
            # its inputs come from a generator of their own.
            tag = f"bf16 {b} x {seq} x {3 * 16 * 64}{' causal' if causal else ''} (rows sweep)"
            grad = torch.randn(b, seq, 16 * 64, generator=bwd_gen, device="cuda").to(
                torch.bfloat16)
            out = A.fused_attention_qkv_backward(qkv, grad, 16, scale, causal)
            checks.float("fused_attention_qkv_backward", tag, out, A.attention_backward_plain(
                qkv.float(), grad.float(), 16, scale, causal))
            require(torch.equal(out, A.fused_attention_qkv_backward(qkv, grad, 16, scale, causal)),
                    f"fused_attention_qkv_backward {tag}: two launches differ")
    # bf16 past 848 keys: the backward's global body (V and g through L2).
    b, seq = 1, 900
    require(A.backward_body(torch.bfloat16, seq, 64) == "mma_global",
            f"bf16 L = {seq}: not on the backward's global body")
    qkv = (1.5 * torch.randn(b, seq, 3 * 16 * 64, generator=bwd_gen, device="cuda")).to(
        torch.bfloat16)
    grad = torch.randn(b, seq, 16 * 64, generator=bwd_gen, device="cuda").to(torch.bfloat16)
    for causal in (False, True):
        tag = f"bf16 {b} x {seq} x {3 * 16 * 64}{' causal' if causal else ''} (V and g through L2)"
        out = A.fused_attention_qkv_backward(qkv, grad, 16, scale, causal)
        checks.float("fused_attention_qkv_backward", tag, out, A.attention_backward_plain(
            qkv.float(), grad.float(), 16, scale, causal))
        require(torch.equal(out, A.fused_attention_qkv_backward(qkv, grad, 16, scale, causal)),
                f"fused_attention_qkv_backward {tag}: two launches differ")

    b, seq, heads, d = 32, 197, 6, 32
    what = f"head_dim 32, {b} x {seq} x {3 * heads * d}"
    for dtype in (torch.bfloat16, torch.float32):
        qkv = (1.5 * torch.randn(b, seq, 3 * heads * d, generator=gen, device="cuda")).to(dtype)
        tag = f"{what} {str(dtype)[6:]}"
        checks.float("fused_attention_qkv", tag, A.fused_attention_qkv(qkv, heads, d ** -0.5),
                     A.attention_core_plain(qkv.float(), heads, d ** -0.5, False))
        checks.float("attention_block", tag, A.attention_block(qkv, heads, d ** -0.5, False),
                     A.attention_core_plain(qkv.float(), heads, d ** -0.5, False, 1.0))
        checks.int8("attention_int8", tag, A.attention_int8(qkv, heads, d ** -0.5, False, out_mul),
                    A.attention_int8_plain(qkv, heads, d ** -0.5, False, out_mul))
        grad = torch.randn(b, seq, heads * d, generator=gen, device="cuda").to(dtype)
        # The plain version with the kernel's casts on the same inputs: the scale
        # 32^-1/2 magnifies the bf16 rounding of dL against an fp32 reference.
        checks.float("fused_attention_qkv_backward", tag,
                     A.fused_attention_qkv_backward(qkv, grad, heads, d ** -0.5),
                     A.attention_backward_plain(qkv, grad, heads, d ** -0.5, False).float())


# The ablation benches (fitclip_torch/bench): each new kernel, the TPU kernel
# it replaces (the pallas_call of the script's arm) and its source.
S1_SITE = "scripts/bench_block_layer.py:545"
BENCH_KERNELS = {
    **{f"ln_quant_{m}": (S1_SITE, "csrc/ln_quant.cu") for m in ("one", "fold", "cast")},
    **{f"attention_{m}": (S1_SITE, "csrc/attention.cu")
       for m in ("div", "fold2", "sm2", "sm2div", "nomax", "cast")},
    **{f"int8_gemm_{m}": (S1_SITE, "csrc/int8_gemm.cu")
       for m in ("sigmoid", "bf16", "fold", "fold16", "sigmoid_cast")},
    # S1s: `full`'s kernels on two CUDA streams (no kernel of its own).
    "block_layer_skew": ("scripts/bench_block_layer.py:149", "bench/block_layer.py"),
    **{f"attention_{m}": ("scripts/bench_attn_int8.py:200", "csrc/attention.cu")
       for m in ("head0", "bf16logits", "nosoftmax")},
    **{m: ("scripts/bench_attn_int8.py:200", "csrc/bench_arms.cu")
       for m in ("attn_amax", "attention_i8qk", "attention_i8qkav")},
    "slice_requant": ("scripts/bench_fit_block.py:159", "csrc/bench_arms.cu"),
}


def bench_kernel_phase(torch, checks: KernelChecks):
    """Phase 3, the bench kernels at the benches' production shapes: S1's
    pieces on 512 frames x 197 x 768 (M = 100,864 rows), S2's on 512 x 197 x
    2304 bf16, slice-requant on S3's 32 x 785 x 2304. Returns {name: timing}."""
    from fitclip_torch.bench import attn_int8 as S2
    from fitclip_torch.bench import kernels as P
    from fitclip_torch.ops import block as K

    gen = torch.Generator(device="cuda").manual_seed(12)
    frames, seq, w, heads = S2.FRAMES, S2.SEQ, S2.WIDTH, S2.HEADS
    m, d = frames * seq, w // heads
    times = {}

    def rand_int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    # S1's LN prologues on the bf16 layer input.
    x = torch.randn(m, w, generator=gen, device="cuda").to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(w, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(w, generator=gen, device="cuda")
    inv = 127.0 / 4.0
    for mode in ("one", "fold", "cast"):
        name = f"ln_quant_{mode}"
        wrapper = getattr(P, name)
        checks.int8(name, f"{m} x {w} bf16", wrapper(x, gamma, beta, inv),
                    P.ln_quant_variant_plain(x, gamma, beta, inv, K.LN_EPS, mode))
        times[name] = timing(
            cuda_ms(lambda: wrapper(x, gamma, beta, inv)),
            cuda_ms(lambda: P.ln_quant_variant_plain(x, gamma, beta, inv, K.LN_EPS, mode), iters=5),
            None, bound(m * w * 2 + m * w + 2 * w * 4, 9 * m * w, "fp32"))
    del x

    # S1's fc epilogues at (M, 4W, W).
    a, wf = rand_int8(m, w), rand_int8(4 * w, w)
    unit = (torch.rand(4 * w, generator=gen, device="cuda") + 0.5) / (73.0 * 73.0 * w ** 0.5)
    folded = (unit * 20.0, 2.0 * torch.randn(4 * w, generator=gen, device="cuda"),
              -1.702 * K.LOG2E / (127.0 / 6.0))
    unfolded = (unit, 0.1 * torch.randn(4 * w, generator=gen, device="cuda"), 127.0 / 6.0)
    for act in ("sigmoid", "bf16", "fold", "fold16", "sigmoid_cast"):
        name = f"int8_gemm_{act}"
        wrapper = getattr(P, name)
        scale, bias, kv = folded if act in ("fold", "fold16") else unfolded
        checks.int8(name, f"{m} x {4 * w} x {w}", wrapper(a, wf, scale, bias, kv),
                    P.int8_gemm_act_plain(a, wf, scale, bias, kv, act=act))
        times[name] = timing(
            cuda_ms(lambda: wrapper(a, wf, scale, bias, kv)),
            cuda_ms(lambda: P.int8_gemm_act_plain(a, wf, scale, bias, kv, act=act), iters=3),
            cuda_ms(lambda: torch._int_mm(a, wf.t())),
            bound(m * w + 4 * w * w + 4 * w * 8 + m * 4 * w, 2 * m * 4 * w * w, "int8"))
    del a, wf

    # S1's attention cores (int8 out) and S2's float modes, on S2's input.
    qkv = S2.make_qkv(frames)
    core_ops = 4 * frames * heads * seq * seq * d
    qkv_bytes = frames * seq * 3 * w * 2
    out_mul = 127.0 / 2.5
    for mode in ("div", "fold2", "sm2", "sm2div", "nomax", "cast", "head0", "bf16logits",
                 "nosoftmax"):
        name = f"attention_{mode}"
        wrapper = getattr(P, name)
        mul = 127.0 / 0.5 if mode == "cast" else out_mul  # cast: att itself in int8's range
        out = wrapper(qkv, heads, d ** -0.5, False, mul)
        ref = P.attention_variant_plain(qkv, heads, d ** -0.5, False, mul, None, mode)
        if out.dtype == torch.int8:
            checks.int8(name, f"{frames} x {seq} x {3 * w}", out, ref)
        else:  # the plain version's casts (weights to bf16) on the same inputs
            checks.float(name, f"{frames} x {seq} x {3 * w}", out, ref.float())
        del out, ref
        read = frames * seq * 3 * d * 2 if mode == "head0" else qkv_bytes
        times[name] = timing(
            cuda_ms(lambda: wrapper(qkv, heads, d ** -0.5, False, mul), iters=5),
            cuda_ms(lambda: P.attention_variant_plain(qkv, heads, d ** -0.5, False, mul, None,
                                                      mode), iters=3), None,
            bound(read + frames * seq * w * (1 if mode in ("div", "fold2", "sm2", "sm2div",
                                                           "nomax", "cast") else 2),
                  core_ops, "bf16"))

    # S2's amax pass and s8 attention.
    scales = P.attn_amax(qkv, 1)
    checks.float("attn_amax", f"{frames} x {seq} x {3 * w}", scales, P.attn_amax_plain(qkv, 1))
    parts = qkv.view(frames, seq, 3, w)
    times["attn_amax"] = timing(
        cuda_ms(lambda: P.attn_amax(qkv, 1)), cuda_ms(lambda: P.attn_amax_plain(qkv, 1)),
        cuda_ms(lambda: torch.linalg.vector_norm(parts, float("inf"), dim=(1, 3))),
        bound(qkv_bytes + frames * 3 * 4, frames * seq * 3 * w, "fp32"))
    half = core_ops // 2
    v_step = float(scales[:, 2].max()) / 127.0
    for name, av8 in (("attention_i8qk", False), ("attention_i8qkav", True)):
        wrapper = getattr(P, name)
        out = wrapper(qkv, scales, heads, d ** -0.5)
        ref = P.attention_s8_plain(qkv, heads, d ** -0.5, 1, av8).float()
        if av8:
            checks.s8(name, f"{frames} x {seq} x {3 * w}", out, ref, v_step)
        else:
            checks.float(name, f"{frames} x {seq} x {3 * w}", out, ref)
        del out, ref
        times[name] = timing(
            cuda_ms(lambda: wrapper(qkv, scales, heads, d ** -0.5), iters=5),
            cuda_ms(lambda: P.attention_s8_plain(qkv, heads, d ** -0.5, 1, av8), iters=3), None,
            bound(qkv_bytes + frames * 3 * 4 + frames * seq * w * 2,
                  {"int8": core_ops} if av8 else {"int8": half, "bf16": half}))
    del qkv, parts

    # slice-requant on S3's joint qkv.
    clips, n = 32, 785
    joint = torch.randn(clips, n, 3 * w, generator=gen, device="cuda").to(torch.bfloat16)
    checks.int8("slice_requant", f"{clips} x {n} x {3 * w}", P.slice_requant(joint, inv),
                P.slice_requant_plain(joint, inv))
    times["slice_requant"] = timing(
        cuda_ms(lambda: P.slice_requant(joint, inv)),
        cuda_ms(lambda: P.slice_requant_plain(joint, inv)), None,
        bound(clips * n * w * 3, clips * n * w * 2, "fp32"))
    return times


def bench_phase(torch, checks: KernelChecks, wrappers, steps=(2, 7, 2)):
    """Phase 10, the port's bench path (fitclip_torch/bench, the entry points
    of ``python -m fitclip_torch.bench``): (a) every S1, S2 and S3 arm against
    its plain twin at 32 frames (S3: 8 clips), the two-stream S1s bit for bit
    against `full`; (b) with the launch counts zeroed, every case of the three
    ablation benches at its script's production shape, with the kernels'
    agreement with `full` (cos_vs_full); (c) one encode reading each for int8
    and bf16 at 128 clips with bench.py's gates. Each case is timed over 2 and
    7 chained steps, in two trials (the reference's count): one trial alone
    can read a long short run, as S1s's two streams sometimes give, and then
    no marginal time. Returns ({path: launches}, {"skew": timing}, records)."""
    from fitclip_torch.bench import attn_int8 as S2
    from fitclip_torch.bench import block_layer as S1
    from fitclip_torch.bench import encode
    from fitclip_torch.bench import fit_block as S3
    from fitclip_torch.bench import kernels as P
    from fitclip_torch.bench.kernels import WRAPPERS

    start = time.perf_counter()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(32, S1.SEQ, S1.WIDTH)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    layer = S1.layer_block(S1.make_layer_params(rng))
    missed = []

    def arm_check(check, *args):  # every arm is checked; the phase fails after
        try:
            check(*args)
        except RuntimeError as error:
            missed.append(str(error))

    for mode in S1.ARMS:
        ops = S1.arm_operands(layer, mode)
        arm_check(checks.float, "bench arms", f"S1 {mode}", S1.run_arm(x.clone(), ops, mode),
                  S1.run_arm(x, ops, mode, plain=True).float())
    ops = S1.arm_operands(layer, "full")
    full = S1.run_arm(x, ops, "full")
    skew = S1.SkewSchedule()(x, ops)
    require(torch.equal(skew, full), "S1s (two streams) is not bit-identical to `full`")
    checks._record("block_layer_skew", 0.0)
    print("  bench arms S1s: two streams over 8 chunks, bit-identical to `full`")
    qkv = S2.make_qkv(32)
    v_step = float(P.attn_amax_plain(qkv, 1)[:, 2].max()) / 127.0
    for mode in S2.ARMS:
        out, ref = S2.run_arm(qkv, mode), S2.run_arm(qkv, mode, plain=True).float()
        if mode == "i8qkav":
            arm_check(checks.s8, "bench arms", f"S2 {mode}", out, ref, v_step)
        else:
            arm_check(checks.float, "bench arms", f"S2 {mode}", out, ref)
    fit_layer = S3.load_layer()
    cfg, fit_ops = fit_layer
    fx = S3.layer_input(cfg, 8)
    fit_plain = {}
    for mode in S3.ARMS:
        fit_plain[mode] = S3.run_arm(fx, fit_ops, mode, cfg.num_heads, cfg.num_frames,
                                     plain=True).float()
        arm_check(checks.layer, "bench arms", f"S3 {mode}",
                  S3.run_arm(fx, fit_ops, mode, cfg.num_heads, cfg.num_frames), fit_plain[mode],
                  fx)
    require(not missed, "bench arms against their plain twins: " + "; ".join(missed))
    # A planted wrong arm: `nocls` (only the CLS row differs) held as `full`
    # must miss the block rule.
    try:
        checks.layer("planted", "bench arms: S3 nocls held as full",
                     S3.run_arm(fx, fit_ops, "nocls", cfg.num_heads, cfg.num_frames),
                     fit_plain["full"], fx)
    except RuntimeError:
        print("  bench arms: the block rule rejects `nocls` held as `full`")
    else:
        require(False, "the block rule does not tell S3's `nocls` from `full`")
    del x, qkv, fx, full, skew
    print(f"bench arms against their plain twins: {time.perf_counter() - start:.1f} s")

    counted = {**wrappers, **{w.__name__: w for w in WRAPPERS}, "block_layer_skew": S1.SkewSchedule}
    for fn in counted.values():
        fn.launches = 0
    records = []
    s1_cases = ",".join(sorted(S1.ARMS) + sorted(S1.RENAMES) + ["b2", "skew"])
    records += list(S1.run(s1_cases, check=True, steps=steps))
    records += list(S2.run(",".join(f"core_{m}" for m in S2.MODES), check=True, steps=steps))
    records += list(S3.run(",".join(list(S3.ARMS) + ["b2", "pad8", "split2"]), check=True,
                           steps=steps, layer=fit_layer))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    for dtype in ("int8", "bf16"):
        records.append(encode.run(dtype, 128, steps=steps))
    for record in records:
        print(f"  {json.dumps(record)}")

    # S1s's entry: the layer on two streams at 512 frames, its plain twin, and
    # the layer's bound (int8 GEMMs and the bf16-equivalent attention core).
    frames, seq, w, heads = S1.FRAMES, S1.SEQ, S1.WIDTH, S1.HEADS
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(frames, seq, w)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    m = frames * seq
    skew = timing(next(r["ms"] for r in records if r.get("case") == "skew"),
                  cuda_ms(lambda: S1.run_arm(x, ops, "full", plain=True), iters=1, warmup=1),
                  None, bound(m * w * 2 * 2 + 12 * w * w + 20 * w * 4,
                              {"int8": 2 * m * 12 * w * w,
                               "bf16": 4 * frames * heads * seq * seq * (w // heads)}))
    print(f"bench phase: {time.perf_counter() - start:.1f} s")
    return {"bench": launches}, {"block_layer_skew": skew}, records


def token_ids(rows: int, rng: np.random.Generator, context: int = 77, vocab: int = 49408):
    """Random token rows ending in the max-id EOT token (as bench.py makes them)."""
    ids = np.zeros((rows, context), np.int64)
    for row in range(rows):
        n = int(rng.integers(5, context - 7))
        ids[row, :n] = rng.integers(1, vocab - 1, n)
        ids[row, n] = vocab - 1
    return ids


class CountingLoader:
    """Batches in a fixed order. Notes the launch counters as it hands out each
    batch, so successive notes differ by the launches of one train step."""

    def __init__(self, batches, counters):
        self.batches, self.counters, self.notes = batches, counters, []

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for batch in self.batches:
            self.notes.append(self.counters())
            yield batch


class TrainData:
    """A data module with a train split only (run_train then skips validation)."""

    def __init__(self, batches, counters):
        self.loader = CountingLoader(batches, counters)

    def train_dataloader(self):
        return self.loader

    def val_dataloader(self):
        raise NotImplementedError


def step_launches(notes, final):
    """Per-step launch counts from the loader's notes and the counts at the end."""
    marks = [*notes, final]
    return [{k: after[k] - before[k] for k in after} for before, after in zip(marks, marks[1:])]


def plain_attention_function(torch):
    """fused_attention_qkv with the kernels' plain versions as forward and backward."""
    from fitclip_torch.ops import attention as A

    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, heads, scale, causal):
            ctx.save_for_backward(qkv)
            ctx.args = (heads, scale, causal)
            return A.attention_core_plain(qkv, heads, scale, causal)

        @staticmethod
        def backward(ctx, grad_out):
            (qkv,) = ctx.saved_tensors
            return A.attention_backward_plain(qkv, grad_out, *ctx.args), None, None, None

    return lambda qkv, heads, scale, causal=False: PlainAttention.apply(qkv, heads, scale,
                                                                         causal)


def train(torch, slot, batches, model_cfg, counters, workdir: Path, max_steps=None,
          checkpoint_dir=None, checkpoint_path=None):
    """One run_train call; returns (state, losses per step, launches per step)."""
    from fitclip_torch.training.train_runner import run_train

    data = TrainData(batches, counters)
    trainer_cfg = {"max_epochs": 1, "log_every_n_steps": 1, "max_steps": max_steps}
    callbacks = None
    if checkpoint_dir:
        callbacks = {"checkpoint": {"dirpath": str(checkpoint_dir), "monitor": None,
                                    "every_n_epochs": 0, "train_time_interval_seconds": None}}
    optimizer_cfg = {"lr": 3e-6, "weight_decay": 0.01, "eps": 1e-8}  # config/*trainer.yaml
    out = run_train(slot, data, model_cfg, trainer_cfg, optimizer_cfg, callbacks,
                    log_dir=str(workdir), checkpoint_path=checkpoint_path)
    torch.cuda.synchronize()
    launches = step_launches(data.loader.notes, counters())
    logged = [json.loads(line) for line in (workdir / "metrics.jsonl").read_text().splitlines()]
    return out["state"], [entry["loss/train"] for entry in logged], launches


def same_bits(torch, a, b) -> bool:
    """Params, moments, AdamW count and step of two train states are identical."""
    named_a, named_b = a.named_parameters(), b.named_parameters()
    return (a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
            and all(torch.equal(named_a[n], named_b[n]) for n in named_a)
            and all(torch.equal(a.opt_state[k][n], b.opt_state[k][n])
                    for k in ("mu", "nu") for n in named_a))


def step_chains(torch, fn, chains: int = 5, steps: int = 3, warmup: int = 2):
    """ms per step of each of ``chains`` chains of ``steps`` steps after warm-up,
    each chain timed by CUDA events from its first step to its last."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(chains):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / steps)
    return out


# A train step's device time by group (first match by kernel name): the attention
# backward (K3b: the bf16 tensor-core kernels, or the fp32 CUDA-core ones), the
# forward attention, the port's GEMM and LayerNorm kernels (the int8 teacher),
# cuBLAS and the fused AdamW.
STEP_GROUPS = (
    ("K3b", ("rows_mma_kernel", "columns_mma_kernel", "::rows_kernel<", "::columns_kernel<")),
    ("forward attention", ("attention_mma_kernel", "attention_kernel_f32")),
    ("port GEMM + LN", ("int8_gemm_kernel", "bf16_gemm_kernel", "ln_kernel")),
    ("cuBLAS", ("nvjet", "cublas", "cutlass", "xmma", "gemm", "gemv")),
    ("optimizer", ("Adam", "multi_tensor_apply")),
)
K3B_MMA = ("rows_mma_kernel", "columns_mma_kernel")


def step_profile(torch, what, fn, require_mma):
    """torch.profiler over one step: its device ms by group and the top kernels.
    With require_mma, the bf16 backward must show both tensor-core kernels and
    no CUDA-core body."""
    per_kernel, busy = profile_ms(torch, fn, calls=1)
    total = sum(per_kernel.values())
    groups = {name: 0.0 for name, _ in STEP_GROUPS}
    groups["other"] = 0.0
    for key, ms in per_kernel.items():
        group = next((name for name, marks in STEP_GROUPS if any(m in key for m in marks)),
                     "other")
        groups[group] += ms
    print(f"{what} profile, one step: device {total:.3f} ms, busy share {busy:.3f} of the "
          f"host window; by group (ms, share): " +
          ", ".join(f"{name} {ms:.3f} ({ms / total:.2%})" for name, ms in groups.items()))
    for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.3f} {ms / total:7.2%}  {key[:100]}")
    if require_mma:
        for name in K3B_MMA:
            ms = sum(v for k, v in per_kernel.items() if name in k)
            require(ms > 0, f"{what}: the profile shows no {name}")
        slow = [k for k in per_kernel if "::rows_kernel<" in k or "::columns_kernel<" in k]
        require(not slow, f"{what}: the bf16 backward ran a CUDA-core body: {slow}")
    return {"device_ms": total, "busy": busy, "groups_ms": groups}


def step_timings(torch, student_template, teacher, batch, ts_batch, require_mma):
    """Phase 6 (d): the contrastive (32 clips) and teacher-student (8 + 8, the
    int8 teacher) steps that run_train drives, on fresh states: ms per step as
    the median of 5 chains of 3 steps after warm-up (with min and max), peak
    memory, and a profile of one step of each."""
    from fitclip_torch.training.state import init_train_state, make_optimizer
    from fitclip_torch.training.steps import (make_contrastive_train_step,
                                              make_teacher_student_train_step)
    from fitclip_torch.training.train_runner import make_batch_preparer

    frames = student_template.encoder.num_frames
    optimizer = make_optimizer(3e-6, weight_decay=0.01, eps=1e-8, fused=True)
    timings = {}
    for kind in ("contrastive", "teacher_student"):
        torch.cuda.empty_cache()
        encoder = copy.deepcopy(student_template.encoder)
        if kind == "contrastive":
            state = init_train_state(encoder, optimizer, init_temperature=0.015)
            step = make_contrastive_train_step(encoder, optimizer)
            device_batch = make_batch_preparer("cuda")(batch)
        else:
            state = init_train_state(encoder, optimizer, init_temperature=0.05,
                                     with_teacher_student_scale=True)
            step = make_teacher_student_train_step(encoder, teacher.encoder, optimizer,
                                                   labeled_loss_share=0.9999)
            device_batch = make_batch_preparer("cuda")(ts_batch)
        torch.cuda.reset_peak_memory_stats()
        chains = step_chains(torch, lambda: step(state, device_batch))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        median = float(np.median(chains))
        timings[kind] = {"ms": median, "min_ms": min(chains), "max_ms": max(chains),
                         "chains_ms": chains, "peak_gib": peak}
        clips = 32 if kind == "contrastive" else 16
        print(f"train (d) {kind} step, {'32' if clips == 32 else '8 + 8'} clips x {frames} "
              f"frames: median {median:.3f} ms (min {min(chains):.3f}, max {max(chains):.3f}; "
              f"5 chains of 3 steps), {clips * 1e3 / median:.1f} clips/s, peak {peak:.2f} GiB")
        timings[kind]["profile"] = step_profile(torch, f"train (d) {kind}",
                                                lambda: step(state, device_batch), require_mma)
        del state, step, encoder, device_batch
    return timings


def training_phase(torch, student_template, teacher, wrappers, workdir: Path):
    """Phase 6; returns ({phase: launches summed over its steps}, timings)."""
    import fitclip_torch.models.clip.model as model_module
    from fitclip_torch.models.clip.load import LoadedEncoder
    from fitclip_torch.ops.losses import nce_loss
    from fitclip_torch.training.train_runner import make_batch_preparer

    def counters():
        return {name: fn.launches for name, fn in wrappers.items()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def student():
        return LoadedEncoder(copy.deepcopy(student_template.encoder))

    rng = np.random.default_rng(2)
    size = student_template.encoder.config.vision.image_size
    frames = student_template.encoder.num_frames

    def clips(n):
        return rng.integers(0, 256, size=(n, frames, size, size, 3), dtype=np.uint8)

    # config/trainer.yaml's temperature; fit_temperature false freezes it.
    contrastive_cfg = {"init_temperature": 0.015, "min_temperature": 0.001,
                       "fit_temperature": False}
    batches = [{"video": clips(32), "text": token_ids(32, rng)} for _ in range(5)]
    per_layer = {"fused_attention_qkv": 1, "fused_attention_qkv_backward": 1}
    totals = {}

    # (a) Contrastive, the kernel path.
    zero()
    straight, losses, launches = train(torch, student(), batches, contrastive_cfg, counters,
                                       workdir / "contrastive")
    totals["contrastive"] = counters()
    expected = {k: 2 * LAYERS * per_layer.get(k, 0) for k in wrappers}
    print(f"train (a) contrastive, 32 clips x {frames} frames: losses {losses}; "
          f"launches per step {launches[0]}")
    require(len(losses) == 5 and all(np.isfinite(losses)), f"contrastive losses {losses}")
    require(all(step == expected for step in launches),
            f"contrastive launches per step {launches}, expected {expected}")

    # The gradient reaches in_proj through the attention kernels.
    device_batch = make_batch_preparer("cuda")(batches[0])
    model = straight.params["encoder"].model
    in_projs = [model.visual.transformer.blocks[0].attn.in_proj.weight,
                model.text.transformer.blocks[0].attn.in_proj.weight]
    encoder = straight.params["encoder"]
    scores = torch.exp(straight.params["logit_scale"][0]) * (
        encoder.encode_video(device_batch["video"]).float()
        @ encoder.encode_text(device_batch["text"]).float().T)
    for tower, grad in zip(("vision", "text"),
                           torch.autograd.grad(nce_loss(scores), in_projs)):
        norm = float(grad.float().norm())
        print(f"train (a) {tower} block 0 in_proj gradient norm {norm:.4e}")
        require(np.isfinite(norm) and norm > 0, f"{tower} in_proj gradient norm {norm}")

    # (c) Resume: 3 steps, checkpoint, restore, 2 more.
    zero()
    checkpoints = workdir / "checkpoints"
    train(torch, student(), batches, contrastive_cfg, counters, workdir / "resume_3",
          max_steps=3, checkpoint_dir=checkpoints)
    resumed, resumed_losses, _ = train(torch, student(), batches, contrastive_cfg, counters,
                                       workdir / "resume_5", max_steps=5,
                                       checkpoint_path=str(checkpoints / "last"))
    totals["resume"] = counters()
    bitwise = same_bits(torch, resumed, straight)
    print(f"train (c) resume: 3 steps + checkpoint + 2 steps; losses after resume "
          f"{resumed_losses}; bit-identical to 5 straight steps: {bitwise}")
    require(bitwise, "resumed params or moments differ from the straight run")
    del resumed

    # (a) again with the plain attention forward and backward.
    zero()
    with swapped(model_module, fused_attention_qkv=plain_attention_function(torch)):
        _, plain_losses, plain_launches = train(torch, student(), batches, contrastive_cfg,
                                                counters, workdir / "contrastive_plain")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    print(f"train (a) plain attention: losses {plain_losses}; relative differences {rel}")
    require(not any(any(step.values()) for step in plain_launches),
            "the plain-attention run launched a kernel")
    require(len(plain_losses) == 5 and max(rel) <= LOSS_RTOL,
            f"kernel vs plain attention losses beyond relative {LOSS_RTOL}: {rel}")
    del straight, model, in_projs, encoder, scores

    # (b) Teacher-student with the int8 teacher.
    ts_cfg = {"init_temperature": 0.05, "min_temperature": 0.001, "fit_temperature": True,
              "labeled_dataset_loss_share": 0.9999}

    def ts_batch():
        def sub():
            video, text = clips(8), token_ids(8, rng)
            return {"video_student": video, "text_student": text,
                    "video_teacher": video, "text_teacher": text}
        return {"labeled": sub(), "unlabeled": sub()}

    ts_batches = [ts_batch() for _ in range(3)]
    zero()
    _, ts_losses, ts_launches = train(torch, {"student": student(), "teacher": teacher},
                                      ts_batches, ts_cfg, counters, workdir / "teacher_student")
    totals["teacher_student"] = counters()
    expected = {k: 2 * LAYERS * {**per_layer, **INT8_LAUNCHES_PER_LAYER}.get(k, 0)
                for k in wrappers}
    print(f"train (b) teacher-student, 8 + 8 clips, int8 teacher: losses {ts_losses}; "
          f"launches per step {ts_launches[0]}")
    require(len(ts_losses) == 3 and all(np.isfinite(ts_losses)),
            f"teacher-student losses {ts_losses}")
    require(all(step == expected for step in ts_launches),
            f"teacher-student launches per step {ts_launches}, expected {expected}")
    shutil.rmtree(workdir)

    # (d) Timings and a profile of the steps run_train drives, on fresh states.
    timings = step_timings(torch, student_template, teacher, batches[0], ts_batches[0],
                           require_mma=True)
    return totals, timings


def wordpiece_ids(rows: int, rng: np.random.Generator, context: int = 77, vocab: int = 30522):
    """Random DistilBERT rows: [CLS] (101), ids, [SEP] (102), [PAD] (0) to the end."""
    ids = np.zeros((rows, context), np.int64)
    for row in range(rows):
        n = int(rng.integers(5, context - 2))
        ids[row, 0], ids[row, n + 1] = 101, 102
        ids[row, 1:n + 1] = rng.integers(1000, vocab, n)
    return ids


def profile_ms(torch, fn, calls: int = 3):
    """torch.profiler over ``calls`` calls: ({kernel name: device ms per call},
    device busy share of the host window)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3
    per_kernel = {}
    for event in prof.key_averages():
        if str(getattr(event, "device_type", "")).endswith("CUDA"):
            us = getattr(event, "self_device_time_total", None)
            if us is None:
                us = event.self_cuda_time_total
            if us > 0:
                per_kernel[event.key] = us / 1e3 / calls
    return per_kernel, sum(per_kernel.values()) * calls / window_ms


# The CUDA-core forward attention bodies by their kernel names (fp32 only; every
# bf16 path runs attention_mma.cuh's attention_mma_kernel or space_mma_kernel).
CUDA_CORE_ATTENTION = ("attention_kernel_f32", "space_kernel_f32")


def print_profile(torch, what, fn, top=10, mma=None):
    """The profile's top kernels; with mma (kernel names), require that those
    tensor-core attention bodies ran and no CUDA-core attention body did."""
    per_kernel, busy = profile_ms(torch, fn)
    total = sum(per_kernel.values())
    print(f"{what} profile, device {total:.3f} ms per call, busy share {busy:.3f} of the host "
          f"window; top kernels (ms per call, share):")
    for key, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:9.3f} {ms / total:7.2%}  {key[:100]}")
    if mma:
        for name in mma:
            ms = sum(v for k, v in per_kernel.items() if name in k)
            print(f"  {what}: {name} {ms:.3f} ms per call ({ms / total:.2%})")
            require(ms > 0, f"{what}: the profile shows no {name}")
        slow = [k for k in per_kernel if any(name in k for name in CUDA_CORE_ATTENTION)]
        require(not slow, f"{what}: a bf16 path ran a CUDA-core attention body: {slow}")


def fit_phase(torch, wrappers):
    """Phase 7: Frozen-in-Time base, int8 (K4's kernels) and bf16 (K5/K6),
    from seed 0; returns ({path: launches}, timings)."""
    import fitclip_torch.models.frozen_in_time.video_transformer as vt
    from fitclip_torch.models.clip.encoder import l2_normalize
    from fitclip_torch.models.frozen_in_time.encoder import EMBED_EPS
    from fitclip_torch.models.frozen_in_time.fit_fast import encode_video_features_fast
    from fitclip_torch.models.frozen_in_time.load import load_frozen_in_time_encoder
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops.fit_block import fused_fit_int8_layer_plain

    def counters():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in wrappers.items()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def expect(per_layer):
        return {k: FIT_LAYERS * per_layer.get(k, 0) for k in wrappers}

    start = time.perf_counter()
    int8_enc = load_frozen_in_time_encoder(dtype="int8", device="cuda", seed=0).encoder
    bf16_enc = load_frozen_in_time_encoder(dtype="bfloat16", device="cuda", seed=0).encoder
    print(f"fit: loaded int8 and bf16 FiT base in {time.perf_counter() - start:.1f} s "
          f"(fused_block {int8_enc.fused_block} / {bf16_enc.fused_block}, fused_attention "
          f"{int8_enc.fused_attention} / {bf16_enc.fused_attention})")
    gen = torch.Generator(device="cuda").manual_seed(5)
    clips, frames = FIT["clips"], FIT["frames"]

    def uint8_video(n):
        return torch.randint(0, 256, (n, frames, 224, 224, 3), generator=gen, device="cuda",
                             dtype=torch.uint8)

    calib, video = uint8_video(8), uint8_video(clips)
    text = torch.from_numpy(wordpiece_ids(256, np.random.default_rng(6))).cuda()

    paths = {}
    zero()
    int8_enc.calibrate(calib)
    paths["fit_calibrate"] = counters()
    zero()
    int8_emb = int8_enc.encode_video(video)
    paths["fit_int8_encode"] = counters()
    zero()
    bf16_emb = bf16_enc.encode_video(video)
    paths["fit_bf16_encode"] = counters()
    zero()
    text_emb = bf16_enc.encode_text(text)
    paths["fit_text_encode"] = counters()
    print(f"fit: launches per path (nonzero counts) "
          f"{ {path: {k: n for k, n in c.items() if n} for path, c in paths.items()} }")
    nothing = expect({})
    require(paths["fit_calibrate"] == nothing, "FiT calibration launched a kernel")
    require(paths["fit_int8_encode"] == expect(FIT_INT8_LAUNCHES_PER_LAYER),
            f"FiT int8 encode launches {paths['fit_int8_encode']}")
    require(paths["fit_bf16_encode"] == expect(FIT_BF16_LAUNCHES_PER_LAYER),
            f"FiT bf16 encode launches {paths['fit_bf16_encode']}")
    require(paths["fit_text_encode"] == nothing, "the DistilBERT tower launched a kernel")

    # Gate (i): the kernel paths against the same models through the plain versions.
    zero()
    features = encode_video_features_fast(int8_enc.video, int8_enc._prepare_video(video),
                                          layer_fn=fused_fit_int8_layer_plain)
    plain = {"int8": l2_normalize(int8_enc.vid_proj(features.float()), eps=EMBED_EPS)}
    with swapped(vt, fused_attention_qkv_gkv=A.attention_gkv_plain,
                 fused_time_attention=A.time_attention_plain):
        plain["bf16"] = bf16_enc.encode_video(video)
    require(counters() == nothing, "the plain FiT paths launched a kernel")
    for tag, emb in (("int8", int8_emb), ("bf16", bf16_emb)):
        cos = min_cosine(emb, plain[tag])
        print(f"fit gate (i) {tag} video: kernels vs plain on the card, min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"FiT {tag}: kernel path vs plain path cosine {cos}")
    cos = min_cosine(int8_emb, bf16_emb)
    print(f"fit gate (ii) video: int8 vs bf16, min cosine {cos:.6f}")
    require(cos > GATE_COSINE, f"FiT int8 vs bf16 cosine {cos}")
    require(int8_emb.shape == (clips, 256) and bool(torch.isfinite(int8_emb).all())
            and bool(torch.isfinite(bf16_emb).all()), "FiT video embeddings not finite (32, 256)")
    require(text_emb.shape == (256, 256) and bool(torch.isfinite(text_emb).all()),
            "FiT text embeddings not finite (256, 256)")
    print(f"fit: text embeddings {tuple(text_emb.shape)}, all finite")
    del plain, features

    timings = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timings["int8_ms"] = cuda_ms(lambda: int8_enc.encode_video(video), iters=10)
    timings["int8_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    timings["bf16_ms"] = cuda_ms(lambda: bf16_enc.encode_video(video), iters=10)
    timings["bf16_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    timings["text_ms"] = cuda_ms(lambda: bf16_enc.encode_text(text), iters=10)
    print(f"fit: int8 encode_video, {clips} clips x {frames} frames: {timings['int8_ms']:.3f} ms, "
          f"{clips * 1e3 / timings['int8_ms']:.1f} clips/s, peak {timings['int8_peak_gib']:.2f} "
          f"GiB; bf16: {timings['bf16_ms']:.3f} ms, {clips * 1e3 / timings['bf16_ms']:.1f} "
          f"clips/s, peak {timings['bf16_peak_gib']:.2f} GiB; encode_text, 256 rows x 77: "
          f"{timings['text_ms']:.3f} ms, {256e3 / timings['text_ms']:.1f} rows/s")

    print_profile(torch, "fit: int8 encode_video", lambda: int8_enc.encode_video(video), top=12,
                  mma=("space_mma_kernel",))
    print_profile(torch, "fit: bf16 encode_video", lambda: bf16_enc.encode_video(video), top=6,
                  mma=("space_mma_kernel",))
    return paths, timings


def s3dg_phase(torch, wrappers):
    """Phase 8: the S3D-G family from seed 0 on the card: MIL-NCE bf16 and int8 (the
    stem on K7, the int8 sites on int8_gemm_bias) and VideoCLIP bf16. Returns
    ({path: launches}, timings)."""
    from fitclip_torch.models.mil_nce import load_mil_nce_encoder
    from fitclip_torch.models.s3dg_fast import s3dg_fast_apply
    from fitclip_torch.models.videoclip import load_videoclip_encoder

    def counters():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in wrappers.items()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def expect(**counts):
        return {k: counts.get(k, 0) for k in wrappers}

    start = time.perf_counter()
    bf16_enc = load_mil_nce_encoder(dtype="bfloat16", device="cuda", seed=0).encoder
    int8_enc = load_mil_nce_encoder(dtype="int8", device="cuda", seed=0).encoder
    vc_enc = load_videoclip_encoder(dtype="bfloat16", device="cuda", seed=0).encoder
    print(f"s3dg: loaded MIL-NCE bf16 and int8 and VideoCLIP bf16 in "
          f"{time.perf_counter() - start:.1f} s (fast {bf16_enc.fast} / {int8_enc.fast} / "
          f"{vc_enc.fast})")
    gen = torch.Generator(device="cuda").manual_seed(8)
    rng = np.random.default_rng(9)
    m, v = MIL_NCE, VIDEOCLIP

    def uint8_video(n, frames):
        return torch.randint(0, 256, (n, frames, m["size"], m["size"], 3), generator=gen,
                             device="cuda", dtype=torch.uint8)

    calib, video, vc_video = (uint8_video(m["calib"], m["frames"]),
                              uint8_video(m["clips"], m["frames"]),
                              uint8_video(v["videos"], v["frames"]))
    words = rng.integers(1, m["vocab"], (m["text_rows"], m["tokens"]))
    words[np.arange(m["tokens"]) >= rng.integers(3, m["tokens"], (m["text_rows"], 1))] = 0
    mil_text = torch.from_numpy(words).cuda()
    vc_ids = wordpiece_ids(v["text_rows"], rng, context=v["tokens"] - 1)
    vc_text = torch.from_numpy(np.concatenate([vc_ids[:, :1], np.full((len(vc_ids), 1), 102),
                                               vc_ids[:, 1:]], axis=1)).cuda()  # [CLS] [SEP] ...

    paths = {}
    zero()
    int8_enc.calibrate(calib)
    paths["mil_nce_calibrate"] = counters()
    zero()
    int8_emb = int8_enc.encode_video(video)
    paths["mil_nce_int8_encode"] = counters()
    zero()
    bf16_emb = bf16_enc.encode_video(video)
    paths["mil_nce_bf16_encode"] = counters()
    zero()
    mil_text_emb = bf16_enc.encode_text(mil_text)
    paths["mil_nce_text_encode"] = counters()
    zero()
    vc_emb = vc_enc.encode_video(vc_video)
    paths["videoclip_encode"] = counters()
    zero()
    vc_text_emb = vc_enc.encode_text(vc_text)
    paths["videoclip_text_encode"] = counters()
    print(f"s3dg: launches per path (nonzero counts) "
          f"{ {path: {k: n for k, n in c.items() if n} for path, c in paths.items()} }")
    stem = expect(s3dg_stem=1)
    for path, want in (("mil_nce_calibrate", stem), ("mil_nce_bf16_encode", stem),
                       ("mil_nce_int8_encode", expect(s3dg_stem=1,
                                                      int8_gemm_bias=S3DG_INT8_SITES)),
                       ("videoclip_encode", stem), ("mil_nce_text_encode", expect()),
                       ("videoclip_text_encode", expect())):
        require(paths[path] == want, f"{path} launches {paths[path]}, expected {want}")

    # Gate (i): each kernel path against the same model through the plain versions.
    zero()
    plain = {"MIL-NCE bf16": s3dg_fast_apply(bf16_enc.video, bf16_enc._prepare_video(video),
                                             torch.bfloat16, plain=True),
             "MIL-NCE int8": s3dg_fast_apply(int8_enc.video, int8_enc._prepare_video(video),
                                             torch.bfloat16, int8=True, plain=True)}
    clips = vc_enc._clips(vc_video)
    features = s3dg_fast_apply(vc_enc.s3dg, clips, torch.bfloat16, plain=True)
    plain["VideoCLIP bf16"] = vc_enc.model.forward_video(
        features.reshape(v["videos"], -1, features.shape[-1]),
        torch.ones(v["videos"], 1, dtype=torch.int64, device="cuda"), vc_enc.CLS_ID,
        vc_enc.SEP_ID)
    require(counters() == expect(), "the plain S3D-G paths launched a kernel")
    for tag, emb in (("MIL-NCE bf16", bf16_emb), ("MIL-NCE int8", int8_emb),
                     ("VideoCLIP bf16", vc_emb)):
        cos = min_cosine(emb, plain[tag])
        print(f"s3dg gate (i) {tag} video: kernels vs plain on the card, min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"{tag}: kernel path vs plain path cosine {cos}")
    cos = min_cosine(int8_emb, bf16_emb)
    print(f"s3dg gate (ii) MIL-NCE video: int8 vs bf16, min cosine {cos:.6f}")
    require(cos > S3DG_GATE_INT8, f"MIL-NCE int8 vs bf16 cosine {cos}")
    for tag, emb, shape in (("MIL-NCE bf16 video", bf16_emb, (m["clips"], 512)),
                            ("MIL-NCE int8 video", int8_emb, (m["clips"], 512)),
                            ("MIL-NCE text", mil_text_emb, (m["text_rows"], 512)),
                            ("VideoCLIP video", vc_emb, (v["videos"], 768)),
                            ("VideoCLIP text", vc_text_emb, (v["text_rows"], 768))):
        require(emb.shape == shape and bool(torch.isfinite(emb).all()),
                f"{tag} embeddings {tuple(emb.shape)} not finite {shape}")
        print(f"s3dg: {tag} embeddings {tuple(emb.shape)}, all finite, mean row norm "
              f"{float(emb.float().norm(dim=-1).mean()):.4f}")
    del plain, features, clips

    timings = {}
    torch.cuda.empty_cache()
    for tag, fn in (("mil_nce_bf16", lambda: bf16_enc.encode_video(video)),
                    ("mil_nce_int8", lambda: int8_enc.encode_video(video)),
                    ("videoclip", lambda: vc_enc.encode_video(vc_video))):
        torch.cuda.reset_peak_memory_stats()
        timings[f"{tag}_ms"] = cuda_ms(fn, iters=10)
        timings[f"{tag}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    timings["mil_nce_text_ms"] = cuda_ms(lambda: bf16_enc.encode_text(mil_text), iters=10)
    timings["videoclip_text_ms"] = cuda_ms(lambda: vc_enc.encode_text(vc_text), iters=10)
    print(f"s3dg: MIL-NCE encode_video, {m['clips']} clips x {m['frames']} frames: bf16 "
          f"{timings['mil_nce_bf16_ms']:.3f} ms, "
          f"{m['clips'] * 1e3 / timings['mil_nce_bf16_ms']:.1f} clips/s, peak "
          f"{timings['mil_nce_bf16_peak_gib']:.2f} GiB; int8 {timings['mil_nce_int8_ms']:.3f} ms, "
          f"{m['clips'] * 1e3 / timings['mil_nce_int8_ms']:.1f} clips/s, peak "
          f"{timings['mil_nce_int8_peak_gib']:.2f} GiB; encode_text, {m['text_rows']} rows x "
          f"{m['tokens']}: {timings['mil_nce_text_ms']:.3f} ms, "
          f"{m['text_rows'] * 1e3 / timings['mil_nce_text_ms']:.1f} rows/s")
    print(f"s3dg: VideoCLIP encode_video, {v['videos']} videos x {v['frames']} frames: "
          f"{timings['videoclip_ms']:.3f} ms, {v['videos'] * 1e3 / timings['videoclip_ms']:.1f} "
          f"videos/s, peak {timings['videoclip_peak_gib']:.2f} GiB; encode_text, "
          f"{v['text_rows']} rows x {v['tokens']}: {timings['videoclip_text_ms']:.3f} ms, "
          f"{v['text_rows'] * 1e3 / timings['videoclip_text_ms']:.1f} rows/s")

    print_profile(torch, "s3dg: MIL-NCE bf16 encode_video", lambda: bf16_enc.encode_video(video),
                  top=15)
    return paths, timings


def k2_launches(layers: int, towers: int = 2) -> dict:
    """K2's seven launches per layer, over both towers."""
    return {name: n * layers * towers for name, n in K2_LAUNCHES_PER_LAYER.items()}


def tower_cosines(a, b):
    return {tower: min_cosine(x, y) for tower, x, y in zip(("vision", "text"), a, b)}


def clip_bf16_fused_phase(torch, wrappers, module_enc, video, text, video32):
    """Phase 9 (a): CLIP ViT-B/16 bf16 with fused_block=True (K2), against the
    plain layer and the bf16 module path of the same seed (``module_enc``, phase
    4's encoder). Returns ({path: launches}, timings)."""
    from fitclip_torch.models.clip.fast_eval import encode_frames_fast, encode_text_fast
    from fitclip_torch.models.clip.load import load_clip_encoder
    from fitclip_torch.ops import block as K

    def counters():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in wrappers.items()}

    enc = load_clip_encoder("ViT-B/16", dtype="bfloat16", device="cuda", seed=0,
                            fused_block=True).encoder
    enc.fold_pixel_normalization()
    for fn in wrappers.values():
        fn.launches = 0
    video_emb, text_emb = enc.encode_video(video), enc.encode_text(text)
    launches = counters()
    expected = {name: 0 for name in wrappers}
    expected.update(k2_launches(LAYERS))
    print(f"clip bf16 fused_block: launches {({k: n for k, n in launches.items() if n})}")
    require(launches == expected, f"CLIP bf16 fused_block launches {launches}, expected {expected}")

    frames = enc._prepare_frames(video)
    kernel = (encode_frames_fast(enc.model, frames), encode_text_fast(enc.model, text))
    plain = (encode_frames_fast(enc.model, frames, layer_fn=K.fused_bf16_layer_plain),
             encode_text_fast(enc.model, text, layer_fn=K.fused_bf16_layer_plain))
    for tower, cos in tower_cosines(kernel, plain).items():
        print(f"clip bf16 gate (i) {tower}: K2 vs fused_bf16_layer_plain on the card, "
              f"min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"CLIP K2 {tower}: kernel vs plain cosine {cos}")
    module = (module_enc.encode_video(video), module_enc.encode_text(text))
    for tower, cos in tower_cosines((video_emb, text_emb), module).items():
        print(f"clip bf16 gate (ii) {tower}: K2 vs the bf16 module path, min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"CLIP K2 {tower}: K2 vs module path cosine {cos}")
    del kernel, plain, module
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: enc.encode_video(video32), iters=10)
    timings = {"clip_bf16_fused_ms": ms,
               "clip_bf16_fused_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"clip bf16 fused_block encode_video, 32 clips x 4 frames: {ms:.3f} ms, "
          f"{32e3 / ms:.1f} clips/s, peak {timings['clip_bf16_fused_peak_gib']:.2f} GiB")
    print_profile(torch, "clip bf16 fused_block encode_video", lambda: enc.encode_video(video32),
                  mma=("attention_mma_kernel",))
    return {"clip_bf16_fused_encode": launches}, timings


def slip_phase(torch, wrappers, video, calib_text, text, video32):
    """Phase 9 (b): SLIP ViT-B/16 (Mu et al., ECCV 2022; SlipConfig.vit_b16) from
    seed 0 on the card, four paths: int8 fused_block (K1, exact GELU in the
    vision tower), bf16 fused_block (K2), the bf16 module path (K3f) and the
    int8 module path with fused attention (K8 and the static denses on K1's
    GEMM). Returns ({path: launches}, timings)."""
    import fitclip_torch.models.clip.model as model_module
    from fitclip_torch.models import slip_fast
    from fitclip_torch.models.slip import load_slip_encoder
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import block as K

    def counters():
        torch.cuda.synchronize()
        return {name: fn.launches for name, fn in wrappers.items()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def expect(**counts):
        return {name: counts.get(name, 0) for name in wrappers}

    start = time.perf_counter()
    int8_enc = load_slip_encoder(dtype="int8", device="cuda", seed=0).encoder
    bf16_enc = load_slip_encoder(dtype="bfloat16", device="cuda", seed=0,
                                 fused_block=True).encoder
    print(f"slip: loaded int8 and bf16 SLIP ViT-B/16 in {time.perf_counter() - start:.1f} s "
          f"(fused_block {int8_enc.fused_block} / {bf16_enc.fused_block}, fused_attention "
          f"{int8_enc.fused_attention} / {bf16_enc.fused_attention})")

    def encode(enc, fused_block):
        """Both towers through the encoder with fused_block set (the module
        path when False)."""
        enc.fused_block = fused_block
        return enc.encode_video(video), enc.encode_text(text)

    paths, emb = {}, {}
    zero()
    int8_enc.calibrate(video, calib_text)
    paths["slip_calibrate"] = counters()
    for tag, enc, fused_block in (("int8_fused", int8_enc, True), ("bf16_fused", bf16_enc, True),
                                  ("bf16_module", bf16_enc, False),
                                  ("int8_module", int8_enc, False)):
        zero()
        emb[tag] = encode(enc, fused_block)
        paths[f"slip_{tag}_encode"] = counters()
    print(f"slip: launches per path (nonzero counts) "
          f"{ {path: {k: n for k, n in c.items() if n} for path, c in paths.items()} }")
    per_tower = 2 * LAYERS
    for path, want in (
            ("slip_calibrate", expect(fused_attention_qkv=per_tower)),
            ("slip_int8_fused_encode", expect(**{k: n * per_tower
                                                 for k, n in INT8_LAUNCHES_PER_LAYER.items()})),
            ("slip_bf16_fused_encode", expect(**k2_launches(LAYERS))),
            ("slip_bf16_module_encode", expect(fused_attention_qkv=per_tower)),
            ("slip_int8_module_encode", expect(fused_int8_qkv_attention=per_tower,
                                               int8_gemm_bias=3 * per_tower))):
        require(paths[path] == want, f"{path} launches {paths[path]}, expected {want}")

    # Gate (i): each kernel path against the same model through the plain versions
    # (the fused paths per frame, through slip_fast, as phase 4 compares K1).
    frames = int8_enc._prepare_frames(video)
    kernel, plain = dict(emb), {}
    for tag, enc, layer in (("int8_fused", int8_enc, K.fused_int8_layer_plain),
                            ("bf16_fused", bf16_enc, K.fused_bf16_layer_plain)):
        kernel[tag] = (slip_fast.encode_frames_fast(enc.model, frames),
                       slip_fast.encode_text_fast(enc.model, text))
        plain[tag] = (slip_fast.encode_frames_fast(enc.model, frames, layer_fn=layer),
                      slip_fast.encode_text_fast(enc.model, text, layer_fn=layer))
    zero()
    with swapped(model_module, fused_attention_qkv=A.attention_core_plain):
        plain["bf16_module"] = encode(bf16_enc, False)
    with swapped(model_module, fused_int8_qkv_attention=A.fused_int8_qkv_attention_plain), \
            swapped(K, int8_gemm_bias=K.int8_gemm_bias_plain):
        plain["int8_module"] = encode(int8_enc, False)
    require(counters() == expect(), "the plain SLIP paths launched a kernel")
    for tag in plain:
        for tower, cos in tower_cosines(kernel[tag], plain[tag]).items():
            print(f"slip gate (i) {tag} {tower}: kernels vs plain on the card, "
                  f"min cosine {cos:.6f}")
            require(cos > GATE_COSINE, f"SLIP {tag} {tower}: kernel vs plain cosine {cos}")
    # Gate (ii): int8 against bf16 (scripts/bench_families.py's gate); (iii) K8 against K1.
    for gate, (a, b) in (("(ii) int8 fused_block vs bf16 module path", ("int8_fused", "bf16_module")),
                         ("(iii) int8 module path (K8) vs int8 fused_block (K1)",
                          ("int8_module", "int8_fused"))):
        for tower, cos in tower_cosines(emb[a], emb[b]).items():
            print(f"slip gate {gate} {tower}: min cosine {cos:.6f}")
            require(cos > GATE_COSINE, f"SLIP gate {gate} {tower}: cosine {cos}")
    for tag, (v, t) in emb.items():
        require(v.shape == (video.shape[0], 512) and t.shape == (text.shape[0], 512)
                and bool(torch.isfinite(v).all()) and bool(torch.isfinite(t).all()),
                f"SLIP {tag} embeddings {tuple(v.shape)} / {tuple(t.shape)} not finite")
    del kernel, plain, emb, frames

    rows = torch.from_numpy(token_ids(256, np.random.default_rng(12))).cuda()
    timings = {}
    torch.cuda.empty_cache()
    for tag, enc, fused_block in (("int8_fused", int8_enc, True), ("bf16_fused", bf16_enc, True),
                                  ("bf16_module", bf16_enc, False),
                                  ("int8_module", int8_enc, False)):
        enc.fused_block = fused_block
        torch.cuda.reset_peak_memory_stats()
        timings[f"{tag}_ms"] = cuda_ms(lambda: enc.encode_video(video32), iters=10)
        timings[f"{tag}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        timings[f"{tag}_text_ms"] = cuda_ms(lambda: enc.encode_text(rows), iters=5)
        print(f"slip {tag}: encode_video, 32 clips x 4 frames: {timings[f'{tag}_ms']:.3f} ms, "
              f"{32e3 / timings[f'{tag}_ms']:.1f} clips/s, peak {timings[f'{tag}_peak_gib']:.2f} "
              f"GiB; encode_text, 256 rows x 77: {timings[f'{tag}_text_ms']:.3f} ms, "
              f"{256e3 / timings[f'{tag}_text_ms']:.1f} rows/s")
    print_profile(torch, "slip int8 module path (K8) encode_video",
                  lambda: int8_enc.encode_video(video32), mma=("attention_mma_kernel",))
    return paths, timings


def train_steps_only(torch, package: Path) -> int:
    """``--train-steps [DIR]``: phase 6 (d) alone, for the fitclip_torch package
    under DIR (default: this checkout), so that two trees' steps are timed by the
    same code in one run. Prints the card, the timings and their profiles, and
    one JSON line of the timings."""
    sys.path.insert(0, str(package))
    from fitclip_torch import _build
    from fitclip_torch.models.clip.load import LoadedEncoder, load_clip_encoder

    print(f"train steps of {package}; device: {torch.cuda.get_device_name(0)}; "
          f"nvidia-smi: {nvidia_smi()}")
    start = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s")
    rng = np.random.default_rng(2)
    with torch.no_grad():
        teacher = load_clip_encoder("ViT-B/16", dtype="int8", device="cuda", seed=0).encoder
        teacher.fold_pixel_normalization()
        teacher.calibrate(torch.from_numpy(rng.integers(0, 256, (8, 4, 224, 224, 3),
                                                        dtype=np.uint8)).cuda(),
                          torch.from_numpy(token_ids(32, rng)).cuda())
    student = load_clip_encoder("ViT-B/16", dtype="bfloat16", device="cuda", seed=0)

    def clips(n):
        return rng.integers(0, 256, size=(n, 4, 224, 224, 3), dtype=np.uint8)

    sub = lambda: {"video_student": clips(8), "text_student": token_ids(8, rng)}  # noqa: E731
    ts_batch = {half: {**part, "video_teacher": part["video_student"],
                       "text_teacher": part["text_student"]}
                for half, part in (("labeled", sub()), ("unlabeled", sub()))}
    timings = step_timings(torch, student, LoadedEncoder(teacher),
                           {"video": clips(32), "text": token_ids(32, rng)}, ts_batch,
                           require_mma=False)
    print(json.dumps({"train_steps": timings, "package": str(package)}))
    return 0


def main() -> int:
    import torch

    # Phase 1: the device.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--train-steps"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return train_steps_only(torch, Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else ROOT)
    sys.path.insert(0, str(ROOT))
    from fitclip_torch import _build
    from fitclip_torch.models.clip.fast_eval import encode_frames_fast, encode_text_fast
    from fitclip_torch.models.clip.load import LoadedEncoder, load_clip_encoder
    from fitclip_torch.ops import attention as A
    from fitclip_torch.ops import block as K
    from fitclip_torch.ops.s3dg_stem import s3dg_stem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}); nvidia-smi: {card}; TF32 off")

    # Phase 2: the build.
    start = time.perf_counter()
    library = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - start:.1f} s -> {library}")
    for line in (library.parent / "ptxas.txt").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # Phase 3: each kernel against its plain version.
    print("kernels against their plain versions:")
    checks = KernelChecks()
    times = kernel_phase(torch, checks)
    times.update(float_layer_kernel_phase(torch, checks))
    times.update(fit_kernel_phase(torch, checks))
    times.update(s3dg_kernel_phase(torch, checks))
    fault_kernel_phase(torch, checks)
    times.update(bench_kernel_phase(torch, checks))
    torch.cuda.empty_cache()

    # Phase 4: the slice. Encoding is inference: no autograd graph.
    torch.set_grad_enabled(False)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    start = time.perf_counter()
    int8_enc = load_clip_encoder("ViT-B/16", dtype="int8", device="cuda", seed=0).encoder
    float_enc = load_clip_encoder("ViT-B/16", dtype="bfloat16", device="cuda", seed=0).encoder
    int8_enc.fold_pixel_normalization()
    float_enc.fold_pixel_normalization()
    print(f"slice: loaded int8 and bf16 ViT-B/16 in {time.perf_counter() - start:.1f} s")
    video = torch.randint(0, 256, (8, 4, 224, 224, 3), generator=gen, device="cuda",
                          dtype=torch.uint8)
    calib_text = torch.from_numpy(token_ids(32, rng)).cuda()
    text = torch.from_numpy(token_ids(8, rng)).cuda()

    wrappers = {"ln_quant": K.ln_quant, "int8_gemm_bias": K.int8_gemm_bias,
                "int8_gemm_residual": K.int8_gemm_residual,
                "int8_gemm_gelu": K.int8_gemm_gelu, "attention_int8": A.attention_int8,
                "fused_attention_qkv": A.fused_attention_qkv,
                "fused_attention_qkv_backward": A.fused_attention_qkv_backward,
                "fused_attention_qkv_gkv": A.fused_attention_qkv_gkv,
                "fused_time_attention": A.fused_time_attention,
                "fit_cls_attention_int8": A.fit_cls_attention_int8,
                "fit_time_attention_int8": A.fit_time_attention_int8,
                "fit_space_attention_int8": A.fit_space_attention_int8,
                "s3dg_stem": s3dg_stem, "ln_cast": K.ln_cast, "bf16_gemm_bias": K.bf16_gemm_bias,
                "bf16_gemm_residual": K.bf16_gemm_residual, "bf16_gemm_gelu": K.bf16_gemm_gelu,
                "attention_block": A.attention_block,
                "fused_int8_qkv_attention": A.fused_int8_qkv_attention}
    for fn in wrappers.values():
        fn.launches = 0
    int8_enc.calibrate(video, calib_text)
    torch.cuda.synchronize()
    after_calibration = {name: fn.launches for name, fn in wrappers.items()}
    video_emb = int8_enc.encode_video(video)
    text_emb = int8_enc.encode_text(text)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"slice: launches after calibration {after_calibration}; after encoding {launches}")
    layers = LAYERS
    require(after_calibration["fused_attention_qkv"] == 2 * layers,
            "calibration did not run the qkv-mode attention kernel on every layer")
    expected = {name: 0 for name in wrappers}
    expected.update({"ln_quant": 4 * layers, "int8_gemm_bias": 2 * layers,
                     "int8_gemm_residual": 4 * layers, "int8_gemm_gelu": 2 * layers,
                     "attention_int8": 2 * layers, "fused_attention_qkv": 2 * layers})
    require(launches == expected, f"launch counts {launches}, expected {expected}")

    frames = int8_enc._prepare_frames(video)
    for tower, kernel_emb, plain_emb in (
            ("vision", encode_frames_fast(int8_enc.model, frames),
             encode_frames_fast(int8_enc.model, frames, layer_fn=K.fused_int8_layer_plain)),
            ("text", encode_text_fast(int8_enc.model, text),
             encode_text_fast(int8_enc.model, text, layer_fn=K.fused_int8_layer_plain))):
        cos = min_cosine(kernel_emb, plain_emb)
        print(f"slice gate (i) {tower}: kernels vs plain on the card, min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"{tower}: kernel path vs plain path cosine {cos}")
    for tower, int8_emb, float_emb in (("vision", video_emb, float_enc.encode_video(video)),
                                       ("text", text_emb, float_enc.encode_text(text))):
        cos = min_cosine(int8_emb, float_emb)
        print(f"slice gate (ii) {tower}: int8 vs bf16 float model, min cosine {cos:.6f}")
        require(cos > GATE_COSINE, f"{tower}: int8 vs bf16 cosine {cos}")
    scores = text_emb.float() @ video_emb.float().T
    require(scores.shape == (8, 8) and bool(torch.isfinite(scores).all()),
            f"text x video scores: shape {tuple(scores.shape)} or non-finite values")
    print(f"slice: text x video scores {tuple(scores.shape)}, all finite, "
          f"diagonal mean {float(scores.diagonal().mean()):.4f}")

    # Phase 5: the slice's throughput at 32 clips.
    video32 = torch.randint(0, 256, (32, 4, 224, 224, 3), generator=gen, device="cuda",
                            dtype=torch.uint8)
    torch.cuda.reset_peak_memory_stats()
    int8_ms = cuda_ms(lambda: int8_enc.encode_video(video32), iters=10)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    float_ms = cuda_ms(lambda: float_enc.encode_video(video32), iters=10)
    print(f"slice: int8 encode_video, 32 clips x 4 frames: {int8_ms:.3f} ms, "
          f"{32e3 / int8_ms:.1f} clips/s, peak {peak_gib:.2f} GiB; "
          f"bf16 float model: {float_ms:.3f} ms, {32e3 / float_ms:.1f} clips/s")
    print_profile(torch, "clip int8 encode_video", lambda: int8_enc.encode_video(video32),
                  mma=("attention_mma_kernel",))
    print_profile(torch, "clip bf16 module path encode_video",
                  lambda: float_enc.encode_video(video32), top=6, mma=("attention_mma_kernel",))

    # Phase 9 runs here, while phase 4's inputs and bf16 encoder are at hand.
    # (a) CLIP ViT-B/16 bf16 with fused_block=True (K2); (b) SLIP ViT-B/16.
    clip_k2_paths, clip_k2_times = clip_bf16_fused_phase(torch, wrappers, float_enc, video, text,
                                                         video32)
    slip_paths, slip_times = slip_phase(torch, wrappers, video, calib_text, text, video32)
    torch.cuda.empty_cache()

    # Phase 6: training.
    torch.set_grad_enabled(True)
    student = load_clip_encoder("ViT-B/16", dtype="bfloat16", device="cuda", seed=0)
    paths, train_times = training_phase(torch, student, LoadedEncoder(int8_enc), wrappers,
                                        ROOT / "build" / "chip_smoke_train")

    # Phase 7: Frozen-in-Time. Inference: no autograd graph.
    torch.set_grad_enabled(False)
    del student
    torch.cuda.empty_cache()
    fit_paths, fit_times = fit_phase(torch, wrappers)

    # Phase 8: the S3D-G family (MIL-NCE, VideoCLIP).
    torch.cuda.empty_cache()
    s3dg_paths, s3dg_times = s3dg_phase(torch, wrappers)

    # Phase 10: the bench path (python -m fitclip_torch.bench's arms and encode).
    torch.cuda.empty_cache()
    bench_paths, bench_times, _ = bench_phase(torch, checks, wrappers)
    times.update(bench_times)
    paths = {"encode": launches, **paths, **fit_paths, **s3dg_paths, **clip_k2_paths,
             **slip_paths, **bench_paths}
    print(f"launches per path (nonzero counts): "
          f"{ {path: {k: n for k, n in c.items() if n} for path, c in paths.items()} }")
    for name in wrappers:
        require(any(counts[name] for counts in paths.values()),
                f"{name} was launched in no path")
    for name in BENCH_KERNELS:
        require(bench_paths["bench"][name] > 0, f"{name} was not launched on the bench path")

    fit_attention = ("fused_attention_qkv_gkv", "fused_time_attention",
                     "fit_cls_attention_int8", "fit_time_attention_int8",
                     "fit_space_attention_int8")
    replaces = {"fused_attention_qkv": "fitclip_tpu/ops/attention.py:41",
                "fused_attention_qkv_backward": "fitclip_tpu/ops/attention.py:349",
                "fused_attention_qkv_gkv": "fitclip_tpu/ops/attention.py:85",
                "fused_time_attention": "fitclip_tpu/ops/attention.py:168",
                "s3dg_stem": "fitclip_tpu/ops/s3dg_stem.py:322",
                "fused_int8_qkv_attention": "fitclip_tpu/ops/attention.py:495",
                **{name: "fitclip_tpu/ops/block.py:210" for name in K2_LAUNCHES_PER_LAYER},
                **{name: "fitclip_tpu/ops/fit_block.py:748" for name in fit_attention[2:]}}
    sources = {"ln_quant": "ln_quant.cu", "attention_int8": "attention.cu",
               "fused_attention_qkv": "attention.cu", "ln_cast": "ln_quant.cu",
               "attention_block": "attention.cu", "fused_int8_qkv_attention": "attention.cu",
               **{name: "bf16_gemm.cu" for name in K2_LAUNCHES_PER_LAYER if "gemm" in name},
               "fused_attention_qkv_backward": "attention_bwd.cu", "s3dg_stem": "s3dg_stem.cu",
               **{name: "fit_attention.cu" for name in fit_attention}}
    # The __global__ bodies of the attention rows on the paths timed here (bf16):
    # attention.cu's and the FiT space kernel's tensor-core core, attention_mma.cuh,
    # and the backward's two kernels, attention_bwd_mma.cuh.
    bodies = {**{name: "attention_mma_kernel" for name in (
                  "attention_int8", "fused_attention_qkv", "attention_block",
                  "fused_int8_qkv_attention",
                  *(n for n in BENCH_KERNELS if n.startswith("attention_") and "i8" not in n))},
              "fused_attention_qkv_gkv": "space_mma_kernel",
              "fit_space_attention_int8": "space_mma_kernel",
              "fused_attention_qkv_backward": "+".join(K3B_MMA)}
    record = [{"name": name, "route": "cuda",
               "source": f"fitclip_torch/csrc/{sources.get(name, 'int8_gemm.cu')}",
               "replaces": replaces.get(name, "fitclip_tpu/ops/block.py:137"),
               "launches": sum(counts[name] for counts in paths.values()),
               "max_abs_err": checks.max_abs_err[name], **times[name]}
              for name in wrappers]
    record += [{"name": name, "route": "cuda", "source": f"fitclip_torch/{source}",
                "replaces": site, "launches": bench_paths["bench"][name],
                "max_abs_err": checks.max_abs_err[name], **times[name]}
               for name, (site, source) in BENCH_KERNELS.items()]
    for entry in record:
        if entry["name"] in bodies:
            entry["kernel"] = bodies[entry["name"]]
    for entry in record:
        library = entry["library_ms"]
        print(f"  {entry['name']}: {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, "
              f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}), library "
              f"{'none' if library is None else f'{library:.4f} ms'}")
    print(json.dumps({"kernels": record}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
