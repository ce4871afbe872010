"""The headline benchmark on Hopper (port of ``bench.py``): zero-shot video
eval throughput, clips/s on one card.

The same encoder as the TPU's: CLIP ViT-B/16 from seed 0 with the pixel
normalization folded into the patch embedding, clips of 4 uniform uint8
frames of 224^2 already on the device, L2-normalized frame-mean embeddings.
``BENCH_DTYPE`` picks int8 (W8A8 on K1's kernels, calibrated on 8 clips and 32
token rows) or bf16 (the float layer kernels, K2); ``BENCH_CLIPS`` the batch
(128). Gates, each a min-row cosine > 0.999 on 4 clips or rows, run on the
card every time, as the TPU script's do:

  1 / 1t  the bf16 encoder on the attention kernel against the plain
          attention (the script's "einsum" side), video and causal text;
  2 / 2t  int8 against bf16, video and text (int8 only);
  3       K2 against the bf16 module path (bf16 only).

The TPU script's 5000 clips/s baseline is a TPU target, so ``vs_baseline`` is
null: no H100 baseline is fixed yet.
"""

import json
import os

import numpy as np
import torch

from fitclip_torch.utils.benchmarking import sustained_seconds_per_step

GATE = 0.999
METRIC = "clip_vit_b16_eval_throughput"


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min())


def _gate(name: str, value: float, gates: dict) -> None:
    gates[name] = round(value, 6)
    if not value > GATE:
        raise RuntimeError(f"gate {name}: min cosine {value} is not above {GATE}")


def _text_ids(rng: np.random.Generator, rows: int = 4, context: int = 77) -> np.ndarray:
    """The script's ragged token rows: a random length, then the end token."""
    ids = np.zeros((rows, context), np.int64)
    for row in range(rows):
        n = int(rng.integers(5, 70))
        ids[row, :n] = rng.integers(1, 49407, n)
        ids[row, n] = 49407
    return ids


def _load(dtype: str, device, fused_attention: bool = True):
    from fitclip_torch.models.clip.load import load_clip_encoder

    enc = load_clip_encoder("ViT-B/16", dtype=dtype, device=device, seed=0,
                            fused_attention=fused_attention).encoder
    return enc.fold_pixel_normalization()


def run(dtype: str = "int8", clips: int = 128, device="cuda", steps=(5, 25, 2)) -> dict:
    """The gates, then the sustained clips/s of ``encode_video`` at ``clips``
    clips. Returns the script's record, with the gates and the card's name."""
    if dtype not in ("int8", "bf16"):
        raise ValueError(f"BENCH_DTYPE must be int8 or bf16, got {dtype!r}")
    rng = np.random.default_rng(0)
    video = torch.from_numpy(rng.integers(0, 256, size=(clips, 4, 224, 224, 3),
                                          dtype=np.uint8)).to(device)
    small = video[:4]
    gates = {}
    with torch.no_grad():
        bf16_enc = _load("bfloat16", device)
        einsum_enc = _load("bfloat16", device, fused_attention=False)
        bf16_emb = bf16_enc.encode_video(small)
        _gate("1", _cosine(bf16_emb, einsum_enc.encode_video(small)), gates)
        text = torch.from_numpy(_text_ids(rng)).to(device)
        bf16_text = bf16_enc.encode_text(text)
        _gate("1t", _cosine(bf16_text, einsum_enc.encode_text(text)), gates)
        del einsum_enc
        if dtype == "int8":
            encoder = _load("int8", device)
            calib_text = torch.from_numpy(rng.integers(1, 49408, size=(32, 77))).to(device)
            encoder.calibrate(video[:8], calib_text)
            _gate("2", _cosine(encoder.encode_video(small), bf16_emb), gates)
            _gate("2t", _cosine(encoder.encode_text(text), bf16_text), gates)
        else:
            encoder = bf16_enc
            encoder.fused_block = True  # the float layer kernels (K2)
            _gate("3", _cosine(encoder.encode_video(small), bf16_emb), gates)
        seconds = sustained_seconds_per_step(
            lambda n: [encoder.encode_video(video) for _ in range(n)], *steps)
    return {"metric": METRIC, "value": round(clips / seconds, 1), "unit": "clips/sec/chip",
            "vs_baseline": None, "dtype": dtype, "clips": clips, "gates": gates,
            "device": torch.cuda.get_device_name(0)}


def main(args=None) -> None:
    record = run(os.environ.get("BENCH_DTYPE", "int8"), int(os.environ.get("BENCH_CLIPS", "128")))
    print(json.dumps(record), flush=True)
