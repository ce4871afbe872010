"""S3: the int8 Frozen-in-Time SpaceTimeBlock with pieces toggled, on Hopper
(port of ``scripts/bench_fit_block.py``: ``make_variant``, ``launch_variant``
and ``main``).

The TPU script times one block at 32 clips x 785 x 768 (FiT base, 4 frames of
196 patches and the CLS row) as a Pallas kernel body with pieces switched per
case. On Hopper the block is ``ops/fit_block.py``'s twelve launches, and an arm
is a steps tuple of its ``_layer``:

- `full`: the shipped K4. `b{n}`, `pad8` and `split{n}` change only the TPU's
  block rows, row layout or operand split: they compute `full`'s function on
  `full`'s launches, so they are not timed again and print one record
  carrying ``same_function_as``: `full`;
- `noattn`, `notime`, `nospace`: that half's attention core (both halves for
  `noattn`) becomes the slice-requant kernel, round(qkv[:, :, :W] * inv_out),
  and the half's denses stay;
- `nocls`: the CLS row comes from slice-requant in place of the
  ``fit_cls_attention_int8`` launch; the frame rows keep their attention;
- `nomlp`: the block stops after the space half.

Each arm has a plain twin built the same way from the plain versions.
"""

import json
import os
from typing import Dict, NamedTuple

import numpy as np
import torch

from fitclip_torch.bench import kernels as P
from fitclip_torch.ops import attention as A
from fitclip_torch.ops import fit_block as FB
from fitclip_torch.ops.quant import quantize_rint
from fitclip_torch.utils.benchmarking import flat_cosine, sustained_seconds_per_step

CLIPS = int(os.environ.get("BENCH_CLIPS", "32"))
CALIBRATION_CLIPS = 8
DEFAULT_CASES = "full,b2,noattn,notime,nospace,nocls,nomlp"


class Arm(NamedTuple):
    """The halves whose attention core is a slice (``skip``), whether the CLS
    row is a slice, whether the MLP half runs."""
    skip: tuple = ()
    cls_slice: bool = False
    mlp: bool = True


ARMS: Dict[str, Arm] = {
    "full": Arm(),
    "noattn": Arm(skip=("time", "space")),
    "notime": Arm(skip=("time",)),
    "nospace": Arm(skip=("space",)),
    "nocls": Arm(cls_slice=True),
    "nomlp": Arm(mlp=False),
}


def arm_of(case: str) -> str:
    """A case of the TPU script -> the arm that computes its function:
    ``b{n}``, `pad8` and ``split{n}`` are `full`."""
    if (case.startswith("b") and case[1:].isdigit() or case == "pad8"
            or case.startswith("split") and case[5:].isdigit()):
        return "full"
    if case not in ARMS:
        raise ValueError(f"unknown case {case!r}: expected one of "
                         f"{sorted(ARMS) + ['pad8', 'b<n>', 'split<n>']}")
    return case


def _attention_step(arm: Arm, plain: bool):
    """The steps tuple's attention: (qkv, heads, frames, half, out_mul) -> int8."""
    def kernel(qkv, heads, frames, half, out_mul):
        if half in arm.skip:
            return P.slice_requant(qkv, out_mul)
        if not arm.cls_slice:
            return FB.fit_attention_int8(qkv, heads, frames, half, out_mul)
        out = P.slice_requant(qkv, out_mul, rows=1)
        rows = A.fit_time_attention_int8 if half == "time" else A.fit_space_attention_int8
        return rows(qkv, heads, frames, out_mul, out)

    def plain_step(qkv, heads, frames, half, out_mul):
        if half in arm.skip:
            return P.slice_requant_plain(qkv, out_mul)
        if not arm.cls_slice:
            return FB.fit_attention_int8_plain(qkv, heads, frames, half, out_mul)
        return torch.cat([P.slice_requant_plain(qkv[:, :1], out_mul),
                          quantize_rint(A.fit_rows_attention_int8_plain(qkv, heads, frames, half,
                                                                        out_mul))], dim=1)
    return plain_step if plain else kernel


def arm_steps(mode: str, plain: bool = False) -> FB._Steps:
    base = FB._PLAIN if plain else FB._KERNELS
    return base._replace(attention=_attention_step(ARMS[mode], plain))


def run_arm(x: torch.Tensor, ops: FB.FitLayerOperands, mode: str, heads: int, frames: int,
            plain: bool = False) -> torch.Tensor:
    """One block of arm ``mode`` on the joint x (B, 1 + F*P, W), through its
    kernels or its plain twin."""
    x, steps = x.contiguous(), arm_steps(mode, plain)
    if ARMS[mode].mlp:
        return FB._layer(x, ops, heads, frames, steps)
    return FB.attention_halves(x, ops, heads, frames, steps).to(x.dtype).view(x.shape)


def load_layer(device="cuda", seed: int = 0, calibration_clips: int = CALIBRATION_CLIPS):
    """Block 0 of the port's FiT base from ``seed``, int8, calibrated on
    ``calibration_clips`` uint8 clips drawn from the same seed (the script
    calibrates its JAX twin on 8 clips). Returns (config, operands)."""
    from fitclip_torch.models.frozen_in_time.load import load_frozen_in_time_encoder

    enc = load_frozen_in_time_encoder(dtype="int8", device=device, seed=seed,
                                      fused_attention=False, fused_block=False).encoder
    cfg = enc.config
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 256, (calibration_clips, cfg.num_frames, cfg.img_size, cfg.img_size,
                                  3), dtype=np.uint8)
    with torch.no_grad():
        enc.calibrate(torch.from_numpy(video).to(device))
        ops = enc.video.blocks[0].int8_operands()
    return cfg, ops


def layer_input(cfg, clips: int, device="cuda", seed: int = 0) -> torch.Tensor:
    """The script's block input: N(0, 1) (clips, 1 + F*P, W) from ``seed``, bf16."""
    n = 1 + cfg.num_frames * (cfg.img_size // cfg.patch_size) ** 2
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(clips, n, cfg.embed_dim)).astype(np.float32)
    return torch.from_numpy(x).to(device, torch.bfloat16)


def run(cases: str = DEFAULT_CASES, check: bool = False, clips: int = CLIPS,
        steps=(5, 25, 2), device="cuda", layer=None):
    """Time each arm at clips x 785 x 768 on the card, once; yields one
    record per case with the script's keys (ms_per_layer, batch_clips), and
    cos_vs_full with check. A case that only renames an arm (`b2`, `pad8`,
    `split2`) yields a record carrying ``same_function_as`` and no time of its
    own; its arm is timed under its own name."""
    arms = {case: arm_of(case) for case in cases.split(",")}
    cfg, ops = layer or load_layer(device)
    heads, frames = cfg.num_heads, cfg.num_frames
    x = layer_input(cfg, clips, device)
    name = torch.cuda.get_device_name(0)
    with torch.no_grad():
        ref = run_arm(x, ops, "full", heads, frames) if check else None
        for mode in dict.fromkeys(arms.values()):
            record = {"case": mode}
            if check:
                record["cos_vs_full"] = round(flat_cosine(
                    run_arm(x, ops, mode, heads, frames), ref), 6)
            seconds = sustained_seconds_per_step(
                lambda n: [run_arm(x, ops, mode, heads, frames) for _ in range(n)], *steps)
            record.update(ms_per_layer=round(seconds * 1e3, 3), batch_clips=clips, device=name)
            yield record
        for case, mode in arms.items():
            if case != mode:
                yield {"case": case, "same_function_as": mode, "device": name}


def main(args) -> None:
    for record in run(args.cases or DEFAULT_CASES, args.check):
        print(json.dumps(record), flush=True)
