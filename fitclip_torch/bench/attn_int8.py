"""S2: variants of the packed attention core on Hopper (port of
``scripts/bench_attn_int8.py``: ``_variant_kernel``'s modes and ``main``).

The TPU script times the attention core alone (projection excluded) at 512
frames x 197 x 768, 12 heads, on a bf16 (B, 197, 3 x 768) qkv, and reports
TFLOP/s on the core's FLOPs and the min-row cosine against an fp32 oracle on
8 frames. Each mode here is one or two launches:

- `bf16`, `nt`: K3f's qkv mode (``ops/attention.fused_attention_qkv``); the
  TPU's K-transpose choice does not change the function;
- `i8qk`, `i8qkav`: the amax pass (per block of ``block`` frames, over every
  head's q, k and v), then the s8 attention of ``csrc/bench_arms.cu``: QK^T
  (and for `i8qkav` P.V) on s8 ``mma.sync.m16n8k32``;
- `bf16logits`, `nosoftmax`: modes of ``csrc/attention.cu``;
- `nopack`: every head attends with head 0's q, k and v. The TPU script
  perturbs head h's q by 1 + h * 1e-6, which rounds to 1 in bf16, so each
  head's slice of its output is head 0's attention.

Each arm has a plain twin in fp32 arithmetic with the same casts.
"""

import json
import os
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from fitclip_torch.bench import kernels as P
from fitclip_torch.ops import attention as A
from fitclip_torch.utils.benchmarking import sustained_seconds_per_step

FRAMES = int(os.environ.get("BENCH_ATTN_FRAMES", "512"))
SEQ = 197
WIDTH = 768
HEADS = 12
HEAD_DIM = WIDTH // HEADS
ORACLE_FRAMES = 8
DEFAULT_CASES = "core_bf16,core_i8qk,core_i8qkav"
MODES = ("bf16", "nt", "i8qk", "i8qkav", "bf16logits", "nosoftmax", "nopack")


class Arm(NamedTuple):
    kernel: Callable
    plain: Callable
    same_function_as: str = None


def _s8(av8: bool):
    wrapper = P.attention_i8qkav if av8 else P.attention_i8qk

    def kernel(qkv, heads, scale, block):
        return wrapper(qkv, P.attn_amax(qkv, block), heads, scale, block)

    def plain(qkv, heads, scale, block):
        return P.attention_s8_plain(qkv, heads, scale, block, av8)
    return kernel, plain


def _variant(wrapper, mode):
    def kernel(qkv, heads, scale, block):
        return wrapper(qkv, heads, scale)

    def plain(qkv, heads, scale, block):
        return P.attention_variant_plain(qkv, heads, scale, False, 1.0, None, mode)
    return kernel, plain


def _packed(qkv, heads, scale, block):
    return A.fused_attention_qkv(qkv, heads, scale)


def _packed_plain(qkv, heads, scale, block):
    return A.attention_core_plain(qkv, heads, scale, False)


ARMS: Dict[str, Arm] = {
    "bf16": Arm(_packed, _packed_plain),
    "nt": Arm(_packed, _packed_plain, "bf16"),
    "i8qk": Arm(*_s8(False)),
    "i8qkav": Arm(*_s8(True)),
    "bf16logits": Arm(*_variant(P.attention_bf16logits, "bf16logits")),
    "nosoftmax": Arm(*_variant(P.attention_nosoftmax, "nosoftmax")),
    "nopack": Arm(*_variant(P.attention_head0, "head0")),
}


def run_arm(qkv: torch.Tensor, mode: str, heads: int = HEADS, block: int = 1,
            plain: bool = False) -> torch.Tensor:
    """The attention core of ``mode`` on qkv (B, L, 3W), through its kernels or
    its plain twin; output (B, L, W) in qkv's dtype."""
    arm = ARMS[mode]
    scale = (qkv.shape[-1] // 3 // heads) ** -0.5
    return (arm.plain if plain else arm.kernel)(qkv.contiguous(), heads, scale, block)


def mode_of(case: str) -> str:
    """A case name of the TPU script (``core_<mode>``) -> its mode."""
    mode = case[len("core_"):] if case.startswith("core_") else case
    if mode not in ARMS:
        raise ValueError(f"unknown case {case!r}: expected core_<mode> with mode in {MODES}")
    return mode


def oracle(qkv: np.ndarray, heads: int = HEADS) -> np.ndarray:
    """The script's fp32 einsum oracle: (B, L, 3W) fp32 -> (B, L, W)."""
    batch, seq, triple = qkv.shape
    width = triple // 3
    q, k, v = (t.reshape(batch, seq, heads, width // heads)
               for t in np.split(qkv.astype(np.float32), 3, axis=-1))
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * ((width // heads) ** -0.5)
    logits -= logits.max(-1, keepdims=True)
    w = np.exp(logits)
    w /= w.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", w, v).reshape(batch, seq, width)


def min_row_cosine(a: np.ndarray, b: np.ndarray) -> float:
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-9
    return float((num / den).min())


def core_flops(frames: int, seq: int = SEQ, width: int = WIDTH) -> float:
    """QK^T + P.V, fp-equivalent (the script's count)."""
    return 2.0 * 2 * frames * seq * seq * width


def sdpa_ms(qkv: torch.Tensor, heads: int, steps) -> float:
    """One F.scaled_dot_product_attention call on the same q, k and v (heads
    first, made contiguous outside the timed call): the `bf16` arm's yardstick."""
    batch, seq, triple = qkv.shape
    q, k, v = (t.reshape(batch, seq, heads, -1).transpose(1, 2).contiguous()
               for t in qkv.split(triple // 3, dim=-1))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = (triple // 3 // heads) ** -0.5
    return sustained_seconds_per_step(lambda n: [sdpa(q, k, v, scale=scale) for _ in range(n)],
                                      *steps) * 1e3


def make_qkv(frames: int = FRAMES, device="cuda") -> torch.Tensor:
    """The script's input: N(0, 0.7^2) fp32 from seed 0, cast to bf16."""
    rng = np.random.default_rng(0)
    qkv = rng.normal(size=(frames, SEQ, 3 * WIDTH)).astype(np.float32) * 0.7
    return torch.from_numpy(qkv).to(device, torch.bfloat16)


def run(cases: str = DEFAULT_CASES, block: int = 1, check: bool = False, frames: int = FRAMES,
        steps=(5, 25, 2), device="cuda"):
    """Time each case at frames x 197 x 2304 on the card; yields one record per
    case with the script's keys (ms, tflops, min_cosine_vs_fp32), and
    max_abs_vs_plain with check."""
    qkv = make_qkv(frames, device)
    ref = oracle(qkv[:ORACLE_FRAMES].float().cpu().numpy())
    with torch.no_grad():
        for case in cases.split(","):
            mode = mode_of(case)
            small = run_arm(qkv[:ORACLE_FRAMES], mode, HEADS, block)
            record = {"case": case, "block": block}
            if check:
                plain = run_arm(qkv[:ORACLE_FRAMES], mode, HEADS, block, plain=True)
                record["max_abs_vs_plain"] = float((small.float() - plain.float()).abs().max())
            seconds = sustained_seconds_per_step(
                lambda n: [run_arm(qkv, mode, HEADS, block) for _ in range(n)], *steps)
            record.update(ms=round(seconds * 1e3, 3),
                          tflops=round(core_flops(frames) / seconds / 1e12, 1),
                          min_cosine_vs_fp32=round(min_row_cosine(small.float().cpu().numpy(),
                                                                  ref), 6))
            if mode == "bf16":
                record["library_ms"] = round(sdpa_ms(qkv, HEADS, steps), 3)
            if ARMS[mode].same_function_as:
                record["same_function_as"] = ARMS[mode].same_function_as
            record["device"] = torch.cuda.get_device_name(0)
            yield record


def main(args) -> None:
    for record in run(args.cases or DEFAULT_CASES, args.block or 1, args.check):
        print(json.dumps(record), flush=True)
