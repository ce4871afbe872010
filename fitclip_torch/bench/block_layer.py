"""S1 and S1s: the int8 ViT-B/16 layer with pieces toggled, on Hopper (port of
``scripts/bench_block_layer.py``: ``make_layer_params``, ``make_run``,
``make_skew_run`` and ``main``).

The TPU script times one layer at 512 frames x 197 x 768, 12 heads, as a
Pallas kernel body with pieces switched per ``mode``. On Hopper the layer is
``ops/block.py``'s seven launches, and every mode factors into four pieces:
the LN prologue before the QKV dense (P1) and before the MLP (P2), the
attention core with its requant (A) and the fc epilogue (E); the out- and
MLP-projection GEMMs are K1's residual GEMM unchanged. ``ARMS`` maps each mode
to its pieces (``fitclip_torch/bench/kernels.py``), and an arm is a steps tuple
of ``ops/block.py:_layer``. Note that `full` is not the shipped K1: it keeps
the attention and the MLP unfolded (weights exps * (1 / denom), an fp32
output requantized after the core; QuickGELU as h * sigmoid(1.702 h), then
rint(g * inv_p)).

The modes that change only the TPU's instruction order or block rows
(``b{n}``, `heads3`, `headloop`, `softsub`, `b2split`; `opt`, whose per-head
requant is `bf16gelu`'s requant after the concat) compute another arm's
function on its launches (each head already has its own CTA): they are not
timed again and print one record carrying ``same_function_as``. `alias` runs
`full`'s kernels with the last projection writing over the layer's input
buffer, in place. `skew` (S1s, the TPU's software-pipelined grid)
is two CUDA streams over chunks of frames: the attention half of chunk i
(P1, A, out-projection) overlaps the MLP half of chunk i - 1, events order
them, and the output is bit for bit `full`'s.

Each arm has a plain twin built the same way from the plain versions.
"""

import dataclasses
import functools
import json
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from fitclip_torch.bench import kernels as P
from fitclip_torch.convert.from_jax import int8_layer_from_jax
from fitclip_torch.models.clip.model import ResidualBlock
from fitclip_torch.ops import attention as A
from fitclip_torch.ops import block as K
from fitclip_torch.ops.quant import QUANT_EPS
from fitclip_torch.utils.benchmarking import flat_cosine, sustained_seconds_per_step

FRAMES = int(os.environ.get("BENCH_BLOCK_FRAMES", "512"))
SEQ = 197
WIDTH = 768
HEADS = 12
DEFAULT_CASES = "full,noattn,nomlp,bf16gelu,noquant"
SKEW_CHUNKS = 8


class Arm(NamedTuple):
    """An S1 mode as its pieces: the LN prologues (both halves), the attention
    core, the fc epilogue (None: the MLP half is skipped)."""
    ln: str
    attention: str
    epilogue: Optional[str]
    same_function_as: Optional[str] = None


_FULL = Arm("two", "div", "sigmoid")
ARMS: Dict[str, Arm] = {
    "full": _FULL,
    "alias": _FULL._replace(same_function_as="full"),
    "noattn": Arm("two", "slice", "sigmoid"),
    "nomlp": Arm("two", "div", None),
    "bf16gelu": Arm("two", "div", "bf16"),
    "noquant": Arm("cast", "cast", "sigmoid_cast"),
    "lnfold": Arm("fold", "div", "sigmoid"),
    "lnvar": Arm("one", "fold", "fold"),
    "avfold": Arm("two", "fold", "fold"),
    "avfold2": Arm("two", "fold2", "fold"),
    "sm2": Arm("two", "sm2", "sigmoid"),
    "sm2div": Arm("two", "sm2div", "sigmoid"),
    "smf": Arm("two", "sm2", "fold"),
    "smfdiv": Arm("two", "sm2div", "folddiv"),
    "sm2mlp16": Arm("two", "sm2", "fold16"),
    "mlpfold": Arm("two", "div", "fold"),
    "mlpfold16": Arm("two", "div", "fold16"),
    "nomax": Arm("two", "nomax", "sigmoid"),
}

# piece -> (kernel wrapper, plain version)
_LN = {"two": (K.ln_quant, K.ln_quant_plain),
       **{m: (getattr(P, f"ln_quant_{m}"), functools.partial(P.ln_quant_variant_plain, mode=m))
          for m in ("one", "fold", "cast")}}
_ATTENTION = {"fold": (A.attention_int8, A.attention_int8_plain),
              "slice": (P.attention_slice, P.attention_slice_plain),
              **{m: (getattr(P, f"attention_{m}"),
                     functools.partial(P.attention_variant_plain, mode=m))
                 for m in ("div", "fold2", "sm2", "sm2div", "nomax", "cast")}}
_EPILOGUE = {"folddiv": (K.int8_gemm_gelu, K.int8_gemm_gelu_plain),
             **{m: (getattr(P, f"int8_gemm_{m}"), functools.partial(P.int8_gemm_act_plain, act=m))
                for m in ("sigmoid", "bf16", "fold", "fold16", "sigmoid_cast")}}
_UNFOLDED = ("sigmoid", "bf16", "sigmoid_cast")  # epilogues on fs, fb and inv_p


# The script's modes that rename an arm: the same function on the same launches.
RENAMES = {"heads3": "full", "headloop": "full", "softsub": "full", "b2split": "full",
           "opt": "bf16gelu"}


def arm_of(case: str) -> str:
    """A case name of the TPU script -> the arm (or `skew`) that computes its
    function: ``b{n}`` and the RENAMES are another arm's."""
    if case.startswith("b") and case[1:].isdigit():
        return "full"
    case = RENAMES.get(case, case)
    if case not in ARMS and case != "skew":
        raise ValueError(f"unknown case {case!r}: expected one of "
                         f"{sorted(ARMS) + sorted(RENAMES) + ['skew', 'b<n>']}")
    return case


def make_layer_params(rng: np.random.Generator, width: int = WIDTH):
    """The script's ``make_layer_params`` with numpy: int8 denses quantized
    per output channel from N(0, 0.02) weights, N(0, 0.01) biases, act_scale
    3.0, unit LayerNorms; the same draws in the same order. Returns the JAX
    package's layer node (numpy leaves)."""
    def dense(n_in, n_out):
        w = rng.normal(size=(n_in, n_out)).astype(np.float32) * 0.02
        amax = np.maximum(np.abs(w).max(axis=-2), QUANT_EPS)
        scale = (amax / 127.0).astype(np.float32)
        q = np.clip(np.rint(w / scale[None, :]), -127, 127).astype(np.int8)
        return {"kernel_q": q, "scale": scale,
                "bias": rng.normal(size=n_out).astype(np.float32) * 0.01,
                "act_scale": np.asarray([3.0], np.float32)}

    def ln():
        return {"ln": {"scale": np.ones(width, np.float32), "bias": np.zeros(width, np.float32)}}

    return {"ln_1": ln(), "ln_2": ln(),
            "attn": {"in_proj": dense(width, 3 * width), "out_proj": dense(width, width)},
            "mlp_fc": dense(width, 4 * width), "mlp_proj": dense(4 * width, width)}


def layer_block(params, heads: int = HEADS, device="cuda") -> ResidualBlock:
    """The layer node as a quantized ResidualBlock (QuickGELU) on ``device``."""
    width = params["ln_1"]["ln"]["scale"].shape[0]
    block = ResidualBlock(width, heads, False, True, torch.bfloat16, quantized=True)
    block.load_state_dict(int8_layer_from_jax(params))
    return block.to(device)


def arm_operands(block: ResidualBlock, mode: str) -> K.Int8LayerOperands:
    """The layer's operands as the arm's pieces take them: the unfolded fc
    dequant (fs, fb, kv = inv_p) for the unfolded epilogues, and for the sm2
    arms D^-1/2 * log2e folded into the Q columns of the QKV scale and bias."""
    arm = ARMS[mode]
    ops = block.int8_operands()
    with torch.no_grad():
        if arm.epilogue in _UNFOLDED:
            _, fs, fb, _ = K.dense_operands(block.mlp_fc)
            _, _, _, inv_p = K.dense_operands(block.mlp_proj)
            ops = dataclasses.replace(ops, fs2=fs, fb2=fb, kv=inv_p.item())
        if arm.attention in ("sm2", "sm2div"):
            width = ops.wq.shape[1]
            s = np.float32((width // block.heads) ** -0.5 * K.LOG2E)
            cols = torch.ones(3 * width, device=ops.qs.device)
            cols[:width] = float(s)
            ops = dataclasses.replace(ops, qs=ops.qs * cols, qb=ops.qb * cols)
    return ops


def _aliased_residual(target: torch.Tensor):
    """`alias`'s projections: K1's residual GEMM, the last one (the MLP
    projection, whose residual is not the layer input) writing into
    ``target``, the layer input's buffer, which nothing reads any more."""
    rows = target.view(-1, target.shape[-1])

    def residual(a, w, scale, bias, res, out_dtype):
        if res.data_ptr() == target.data_ptr():  # the out-projection reads x
            return K.int8_gemm_residual(a, w, scale, bias, res, out_dtype)
        if out_dtype != target.dtype:
            raise ValueError(f"alias: the output is {out_dtype}, the input buffer {target.dtype}")
        K._gemm(a, w, scale, bias, K._RESIDUAL, rows, residual=res)
        K.int8_gemm_residual.launches += 1
        return rows
    return residual


def arm_steps(mode: str, plain: bool = False, alias_of: Optional[torch.Tensor] = None):
    """The ``_layer`` steps of an arm (its plain twin with plain=True). With
    ``alias_of`` (a CUDA tensor), the final projection writes into that buffer."""
    arm = ARMS[mode]
    pick = 1 if plain else 0
    residual = K.int8_gemm_residual_plain if plain else K.int8_gemm_residual
    if alias_of is not None:
        residual = _aliased_residual(alias_of)
    epilogue = _EPILOGUE[arm.epilogue][pick] if arm.epilogue else None
    return K._Steps(_LN[arm.ln][pick], K.int8_gemm_bias_plain if plain else K.int8_gemm_bias,
                    _ATTENTION[arm.attention][pick], residual, epilogue)


def run_arm(x: torch.Tensor, ops: K.Int8LayerOperands, mode: str, heads: int = HEADS,
            plain: bool = False) -> torch.Tensor:
    """One layer of arm ``mode`` on x (B, L, W): through its kernels, or its
    plain twin. `alias` overwrites x with the output and returns it."""
    x = x.contiguous()
    alias = mode == "alias" and not plain and x.device.type == "cuda"
    steps = arm_steps(mode, plain, alias_of=x if alias else None)
    if ARMS[mode].epilogue is not None:
        return K._layer(x, ops, heads, False, K.LN_EPS, None, steps)
    batch, seq, width = x.shape
    x32 = K.attention_half(x.view(-1, width), ops, batch, seq, heads, False, K.LN_EPS, None,
                           steps)
    return x32.to(x.dtype).view(x.shape)


class SkewSchedule:
    """S1s: `full`'s layer as two streams over ``chunks`` chunks of frames.
    The attention half of chunk i (P1, A, out-projection) runs on one stream
    while the MLP half of chunk i - 1 runs on the other; an event per chunk
    orders the halves. Replaces scripts/bench_block_layer.py:make_skew_run."""

    launches = 0

    def __init__(self, chunks: int = SKEW_CHUNKS):
        self.chunks = chunks
        self._streams = None

    def __call__(self, x: torch.Tensor, ops: K.Int8LayerOperands, heads: int = HEADS,
                 plain: bool = False) -> torch.Tensor:
        steps = arm_steps("full", plain)
        batch, seq, width = x.shape
        pieces = x.contiguous().split(-(-batch // self.chunks))
        if plain or x.device.type == "cpu":  # the same function, chunk by chunk
            return torch.cat([self._chunk(c, ops, heads, steps) for c in pieces])
        if self._streams is None:
            self._streams = (torch.cuda.Stream(x.device), torch.cuda.Stream(x.device))
        attn_stream, mlp_stream = self._streams
        main = torch.cuda.current_stream(x.device)
        attn_stream.wait_stream(main)
        mlp_stream.wait_stream(main)
        outs = []
        for c in pieces:
            with torch.cuda.stream(attn_stream):
                x32 = K.attention_half(c.view(-1, width), ops, c.shape[0], seq, heads, False,
                                       K.LN_EPS, None, steps)
                ready = torch.cuda.Event()
                ready.record(attn_stream)
            with torch.cuda.stream(mlp_stream):
                mlp_stream.wait_event(ready)
                x32.record_stream(mlp_stream)
                outs.append(K.mlp_half(x32, ops, K.LN_EPS, steps, x.dtype))
        main.wait_stream(attn_stream)
        main.wait_stream(mlp_stream)
        for y in outs:
            y.record_stream(main)
        SkewSchedule.launches += 1
        return torch.cat(outs).view(batch, seq, width)

    @staticmethod
    def _chunk(c, ops, heads, steps):
        b, seq, width = c.shape
        x32 = K.attention_half(c.view(-1, width), ops, b, seq, heads, False, K.LN_EPS, None,
                               steps)
        return K.mlp_half(x32, ops, K.LN_EPS, steps, c.dtype).view(b, seq, width)


def layer_flops(frames: int, seq: int = SEQ, width: int = WIDTH) -> float:
    """The script's fp-equivalent FLOPs of the full layer (projections, core, MLP)."""
    dense = 2 * frames * seq * width * (3 * width + width + 8 * width)
    core = 2 * 2 * frames * seq * seq * width
    return float(dense + core)


def run(cases: str = DEFAULT_CASES, check: bool = False, frames: int = FRAMES,
        steps=(5, 25, 2), device="cuda"):
    """Time each arm at frames x 197 x 768 on the card, once; yields one
    record per case with the script's keys (ms, tflops_fp_equiv, cos_vs_full
    with check). A case that renames an arm yields a record carrying
    ``same_function_as`` and no time of its own; its arm is timed under its
    own name."""
    arms = {case: arm_of(case) for case in cases.split(",")}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(frames, SEQ, WIDTH)).astype(np.float32)).to(
        device, torch.bfloat16)
    layer = layer_block(make_layer_params(rng, WIDTH), HEADS, device)
    skew = SkewSchedule()
    name = torch.cuda.get_device_name(0)
    with torch.no_grad():
        ref = run_arm(x, arm_operands(layer, "full"), "full", HEADS) if check else None
        for mode in dict.fromkeys(arms.values()):
            if mode == "skew":
                ops = arm_operands(layer, "full")
                fn = functools.partial(skew, x, ops, HEADS)
            else:
                ops = arm_operands(layer, mode)
                # `alias` overwrites its input: it gets a buffer of its own.
                xin = x.clone() if mode == "alias" else x
                fn = functools.partial(run_arm, xin, ops, mode, HEADS)
            record = {"case": mode}
            if check:
                out = skew(x, ops, HEADS) if mode == "skew" else run_arm(
                    x.clone() if mode == "alias" else x, ops, mode, HEADS)
                record["cos_vs_full"] = round(flat_cosine(out, ref), 6)
                if mode == "skew":
                    record["same_bits_as_full"] = bool(torch.equal(out, ref))
            seconds = sustained_seconds_per_step(lambda n: [fn() for _ in range(n)], *steps)
            record["ms"] = round(seconds * 1e3, 3)
            record["tflops_fp_equiv"] = round(layer_flops(frames) / seconds / 1e12, 1)
            same = "full" if mode == "skew" else ARMS[mode].same_function_as
            if same:
                record["same_function_as"] = same
            record["device"] = name
            yield record
        for case, mode in arms.items():
            if case != mode:
                yield {"case": case, "same_function_as": mode, "device": name}


def main(args) -> None:
    for record in run(args.cases or DEFAULT_CASES, args.check):
        print(json.dumps(record), flush=True)
