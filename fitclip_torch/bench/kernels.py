"""The kernel pieces of the ablation bench arms, each beside its plain version.

The TPU ablation benches (``scripts/bench_block_layer.py`` S1,
``scripts/bench_attn_int8.py`` S2, ``scripts/bench_fit_block.py`` S3) each copy
a whole-layer Pallas kernel and toggle pieces of it. On Hopper a layer is a
fixed composition of launches (``ops/block.py``, ``ops/fit_block.py``), so an
arm swaps the launches whose function it changes. This module holds those
launches: modes of the shipped kernels (``csrc/ln_quant.cu``,
``csrc/attention.cu``, ``csrc/int8_gemm.cu``) and the kernels of
``csrc/bench_arms.cu``.

- LN prologue before a dense (S1's P): ``ln_quant_one`` (single-pass variance,
  `lnvar`), ``ln_quant_fold`` (inv folded into the affine, `lnfold`),
  ``ln_quant_cast`` (LN truncated to int8, `noquant`); the shipped two-pass
  ``ops/block.ln_quant`` is the fourth.
- Attention core with its requant, int8 out (S1's A): ``attention_div``
  (`full`'s core, then rint(att * inv_o)), ``attention_fold2``,
  ``attention_sm2``, ``attention_sm2div``, ``attention_nomax``,
  ``attention_cast`` and ``slice_requant``; the shipped int8 mode
  (``ops/attention.attention_int8``) is `avfold`'s.
- fc epilogue (S1's E): ``int8_gemm_sigmoid`` (`full`'s unfolded QuickGELU),
  ``int8_gemm_gelu_bf16``, ``int8_gemm_fold`` (rcp.approx), ``int8_gemm_fold16``,
  ``int8_gemm_sigmoid_cast``; the shipped ``ops/block.int8_gemm_gelu`` with
  QuickGELU is `folddiv`'s.
- S2's float-output attention modes: ``attention_head0`` (`nopack`),
  ``attention_bf16logits``, ``attention_nosoftmax``; its int8 modes: the amax
  pass ``attn_amax`` and the s8 attention ``attention_i8qk`` /
  ``attention_i8qkav`` (QKᵀ, and for the latter P.V, on s8 mma.sync).

Each wrapper takes its plain version for a CPU tensor only; for a CUDA tensor
it launches its kernel or raises, and adds one to its ``launches``. Where the
TPU arm multiplies by ``pl.reciprocal(approx=True)`` the kernel uses the
card's ``rcp.approx`` and the plain version divides exactly.
"""

from typing import Optional

import torch

from fitclip_torch import _build
from fitclip_torch.ops import attention as A
from fitclip_torch.ops import block as K
from fitclip_torch.ops.quant import int_matmul, quantize_rint

LOG2E = K.LOG2E


def trunc_int8(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int8 convert: truncation toward zero, saturated."""
    return torch.trunc(x).clamp(-128, 127).to(torch.int8)


def _counted(name: str, doc: str):
    def decorate(fn):
        fn.__name__ = fn.__qualname__ = name
        fn.__doc__ = doc
        fn.launches = 0
        return fn
    return decorate


# --- S1's LN prologues (csrc/ln_quant.cu modes) ---------------------------------

_LN_MODES = {"one": 1, "fold": 2, "cast": 3}


def ln_quant_variant_plain(x, weight, bias, inv: float, eps: float, mode: str) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    if mode == "one":
        var = (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean
        normed = (x32 - mean) * torch.rsqrt(var + eps)
    else:
        centered = x32 - mean
        normed = centered * torch.rsqrt((centered * centered).mean(dim=-1, keepdim=True) + eps)
    if mode == "fold":
        return quantize_rint(normed * (weight * inv) + bias * inv)
    y = normed * weight + bias
    return trunc_int8(y) if mode == "cast" else quantize_rint(y * inv)


def _ln_quant_variant(mode: str):
    @_counted(f"ln_quant_{mode}", f"(rows, W) -> int8 (rows, W): S1's `{mode}` LN prologue "
              "(csrc/ln_quant.cu). Replaces the LN + quantize of "
              "scripts/bench_block_layer.py:make_run.")
    def wrapper(x, weight, bias, inv, eps=K.LN_EPS):
        if x.device.type == "cpu":
            return ln_quant_variant_plain(x, weight, bias, inv, eps, mode)
        out = K.ln_quant_launch(x, weight, bias, inv, eps, _LN_MODES[mode])
        wrapper.launches += 1
        return out
    return wrapper


ln_quant_one = _ln_quant_variant("one")
ln_quant_fold = _ln_quant_variant("fold")
ln_quant_cast = _ln_quant_variant("cast")


# --- attention modes (csrc/attention.cu) ------------------------------------------

_ATTENTION_MODES = {"div": 3, "fold2": 4, "sm2": 5, "sm2div": 6, "nomax": 7, "cast": 8,
                    "head0": 9, "bf16logits": 10, "nosoftmax": 11}


def attention_variant_plain(qkv, heads: int, scale: float, causal: bool, out_mul: float,
                            seq_valid: Optional[int], mode: str) -> torch.Tensor:
    """The plain version of every bench mode of csrc/attention.cu: int8 (B, L,
    W) for S1's modes, qkv's dtype for S2's. The sm2 modes take q already
    scaled (scale is not applied)."""
    batch, seq, triple = qkv.shape
    width = triple // 3
    head_dim = width // heads

    def split(t):
        return t.reshape(batch, seq, heads, head_dim).transpose(1, 2)

    if mode == "head0":
        qkv = torch.cat([qkv[..., p * width:p * width + head_dim].repeat(1, 1, heads)
                         for p in range(3)], dim=-1)
    q_scale = 1.0 if mode in ("sm2", "sm2div") else scale
    q = split(qkv[..., :width] * torch.tensor(q_scale, dtype=qkv.dtype, device=qkv.device))
    k, v = split(qkv[..., width:2 * width]), split(qkv[..., 2 * width:])
    logits = q.float() @ k.float().transpose(-1, -2)
    if causal:
        keep = torch.ones(seq, seq, dtype=torch.bool, device=qkv.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    if seq_valid is not None and seq_valid < seq:
        logits = logits.masked_fill(torch.arange(seq, device=qkv.device) >= seq_valid, -1e30)
    if mode == "nosoftmax":
        weights = logits
    elif mode == "bf16logits":
        lb = logits.to(torch.bfloat16)
        exps = torch.exp(lb - lb.amax(dim=-1, keepdim=True))
        denom = exps.float().sum(dim=-1, keepdim=True)
        weights = exps * (1.0 / denom).to(torch.bfloat16)
    else:
        if mode == "nomax":
            exps = torch.exp(logits)
        else:
            shifted = logits - logits.amax(dim=-1, keepdim=True)
            exps = (torch.exp2(shifted * LOG2E) if mode == "fold2" else
                    torch.exp2(shifted) if mode in ("sm2", "sm2div") else torch.exp(shifted))
        denom = exps.sum(dim=-1, keepdim=True)
        if mode in ("head0", "sm2div", "nomax"):
            weights = exps / denom
        elif mode == "fold2":
            weights = exps * (out_mul * (1.0 / denom))
        else:  # div, sm2, cast: _attention_core's exps * (1 / denom)
            weights = exps * (1.0 / denom)
    out = weights.to(v.dtype).float() @ v.float()
    out = out.transpose(1, 2).reshape(batch, seq, width)
    if mode in ("head0", "bf16logits", "nosoftmax"):
        return out.to(qkv.dtype)
    if mode == "cast":
        return trunc_int8(out)
    return quantize_rint(out if mode == "fold2" else out * out_mul)


def _attention_variant(mode: str, doc: str):
    int8_out = mode not in ("head0", "bf16logits", "nosoftmax")

    @_counted(f"attention_{mode}", doc)
    def wrapper(qkv, heads, scale, causal=False, out_mul=1.0, seq_valid=None):
        if qkv.device.type == "cpu":
            return attention_variant_plain(qkv, heads, scale, causal, out_mul, seq_valid, mode)
        batch, seq, triple = qkv.shape
        out = torch.empty(batch, seq, triple // 3, device=qkv.device,
                          dtype=torch.int8 if int8_out else qkv.dtype)
        q_scale = 1.0 if mode in ("sm2", "sm2div") else scale
        A._launch(qkv, heads, q_scale, causal, seq_valid, out, _ATTENTION_MODES[mode], out_mul)
        wrapper.launches += 1
        return out
    return wrapper


_S1 = "Replaces the attention core of scripts/bench_block_layer.py:make_run"
attention_div = _attention_variant("div", f"`full`'s core: weights exps * (1 / denom), then "
                                          f"rint(att * out_mul) -> int8. {_S1}.")
attention_fold2 = _attention_variant("fold2", f"exp2((l - peak) log2e), weights exps * (out_mul "
                                              f"* rcp.approx(sum)) -> int8 (`avfold2`). {_S1}.")
attention_sm2 = _attention_variant("sm2", f"q pre-scaled by D^-1/2 log2e, exp2, weights exps * "
                                          f"rcp.approx(sum), rint(att * out_mul) (`sm2`). {_S1}.")
attention_sm2div = _attention_variant("sm2div", f"`sm2` with an exact divide. {_S1}.")
attention_nomax = _attention_variant("nomax", f"exp(l) with no max subtraction, exps / denom, "
                                              f"rint(att * out_mul) (`nomax`). {_S1}.")
attention_cast = _attention_variant("cast", f"`full`'s core truncated to int8 (`noquant`). "
                                            f"{_S1}.")
_S2 = "Replaces a mode of scripts/bench_attn_int8.py:_variant_kernel"
attention_head0 = _attention_variant("head0", f"every head attends with head 0's q, k, v "
                                              f"(`nopack`). {_S2}.")
attention_bf16logits = _attention_variant("bf16logits", f"bf16 logits and exp, fp32 sum, "
                                                        f"weights exps * bf16(1 / denom). {_S2}.")
attention_nosoftmax = _attention_variant("nosoftmax", f"weights = bf16(logits), timing only. "
                                                      f"{_S2}.")


# --- slice_requant (csrc/bench_arms.cu) ------------------------------------------

def slice_requant_plain(qkv: torch.Tensor, inv: float) -> torch.Tensor:
    return quantize_rint(qkv[..., :qkv.shape[-1] // 3].float() * inv)


@_counted("slice_requant", "round(qkv[:, row0:row0 + rows, :W] * inv) -> int8 (clips, n, W), "
          "written into ``out`` (allocated where None). Replaces the attention core of the "
          "`noattn` arm of scripts/bench_block_layer.py:make_run and of the `noattn`, "
          "`notime`, `nospace` and `nocls` arms of scripts/bench_fit_block.py:make_variant.")
def slice_requant(qkv: torch.Tensor, inv: float, out: Optional[torch.Tensor] = None,
                  row0: int = 0, rows: Optional[int] = None) -> torch.Tensor:
    clips, n, triple = qkv.shape
    width = triple // 3
    rows = n - row0 if rows is None else rows
    if out is None:
        out = torch.empty(clips, n, width, dtype=torch.int8, device=qkv.device)
    if out.shape != (clips, n, width) or out.dtype != torch.int8:
        raise ValueError(f"out must be int8 {(clips, n, width)}, got {out.dtype} {tuple(out.shape)}")
    if row0 < 0 or rows < 1 or row0 + rows > n:
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside the clip's {n} rows")
    if qkv.device.type == "cpu":
        out[:, row0:row0 + rows] = slice_requant_plain(qkv[:, row0:row0 + rows], inv)
        return out
    _build.check_cuda_operand("qkv", qkv, ndim=3)
    _build.check_cuda_operand("out", out, torch.int8, 3)
    _build.call("fitclip_slice_requant", qkv.data_ptr(), _build.dtype_code(qkv.dtype),
                out.data_ptr(), clips, n, row0, rows, width, float(inv))
    slice_requant.launches += 1
    return out


def attention_slice(qkv, heads, scale, causal=False, out_mul=1.0, seq_valid=None):
    """S1's `noattn` core in the attention step's signature."""
    return slice_requant(qkv, out_mul)


def attention_slice_plain(qkv, heads, scale, causal=False, out_mul=1.0, seq_valid=None):
    return slice_requant_plain(qkv, out_mul)


# --- S1's fc epilogues (csrc/int8_gemm.cu Act codes) ------------------------------

_ACTS = {"sigmoid": 2, "bf16": 3, "fold": 4, "fold16": 5, "sigmoid_cast": 6}


def _bf16(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32).to(torch.bfloat16)


def int8_gemm_act_plain(a, w, scale, bias, kv: float, quick_gelu: bool = True, *,
                        act: str) -> torch.Tensor:
    """The plain version of the fc epilogue ``act``: for sigmoid, bf16 and
    sigmoid_cast scale/bias are the unfolded dequant (fs, fb) and kv is inv_p;
    for fold and fold16 they are fs2, fb2 and the exp2 multiplier."""
    acc = int_matmul(a, w)
    if act in ("bf16", "fold16"):
        accb = acc.to(torch.float32).to(torch.bfloat16)
        t = accb * _bf16(scale).to(acc.device) + _bf16(bias).to(acc.device)
        one = _bf16(1.0)
        if act == "bf16":
            g = t * (one / (one + torch.exp(-(_bf16(1.702) * t))))
            g = g * _bf16(kv)
        else:
            g = t * (one / (one + torch.exp2(t * _bf16(kv))))
        return quantize_rint(g.float())
    t = acc * scale + bias
    if act == "fold":
        return quantize_rint(t / (1.0 + torch.exp2(t * kv)))
    g = t * (1.0 / (1.0 + torch.exp(-(1.702 * t))))
    return trunc_int8(g) if act == "sigmoid_cast" else quantize_rint(g * kv)


def _gemm_act(act: str, doc: str):
    @_counted(f"int8_gemm_{act}", doc)
    def wrapper(a, w, scale, bias, kv, quick_gelu=True):
        if a.device.type == "cpu":
            return int8_gemm_act_plain(a, w, scale, bias, kv, act=act)
        out = torch.empty(a.shape[0], w.shape[0], dtype=torch.int8, device=a.device)
        K._gemm(a, w, scale, bias, K._GELU, out, kv=kv, act=_ACTS[act])
        wrapper.launches += 1
        return out
    return wrapper


_E = "Replaces the MLP fc epilogue of scripts/bench_block_layer.py:make_run"
int8_gemm_sigmoid = _gemm_act("sigmoid", f"h = acc * fs + fb, h * sigmoid(1.702 h), rint(g * "
                                         f"inv_p) (`full`). {_E}.")
int8_gemm_bf16 = _gemm_act("bf16", f"dequant, QuickGELU and inv_p in bf16, the round in fp32 "
                                   f"(`bf16gelu`, `opt`). {_E}.")
int8_gemm_fold = _gemm_act("fold", f"t = acc * fs2 + fb2, t * rcp.approx(1 + exp2(t kv)) "
                                   f"(`mlpfold`). {_E}.")
int8_gemm_fold16 = _gemm_act("fold16", f"the folded QuickGELU in bf16 (`mlpfold16`). {_E}.")
int8_gemm_sigmoid_cast = _gemm_act("sigmoid_cast", f"`full`'s GELU truncated to int8 "
                                                   f"(`noquant`). {_E}.")

# --- S2's int8 attention (csrc/bench_arms.cu) --------------------------------------

def attn_amax_plain(qkv: torch.Tensor, block: int) -> torch.Tensor:
    """(frames, L, 3W) -> (ceil(frames / block), 3) fp32: per block of frames,
    max |x| of q, k and v over every head, floored at 1e-6."""
    frames, seq, triple = qkv.shape
    blocks = -(-frames // block)
    pad = blocks * block - frames
    parts = qkv.float().abs().reshape(frames, seq, 3, triple // 3).amax(dim=(1, 3))
    if pad:
        parts = torch.cat([parts, parts.new_zeros(pad, 3)])
    return parts.reshape(blocks, block, 3).amax(dim=1).clamp_min(1e-6)


@_counted("attn_amax", "bf16 (frames, L, 3W) -> fp32 (ceil(frames / block), 3): the dynamic "
          "per-block q, k and v scales of the int8 modes of "
          "scripts/bench_attn_int8.py:_variant_kernel.")
def attn_amax(qkv: torch.Tensor, block: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return attn_amax_plain(qkv, block)
    _build.check_cuda_operand("qkv", qkv, torch.bfloat16, 3)
    frames, seq, triple = qkv.shape
    if triple % 24 or triple // 8 > 1024:
        raise ValueError(f"attn_amax takes 3W with W a multiple of 8 and 3W <= 8192, not {triple}")
    scales = torch.empty(-(-frames // block), 3, dtype=torch.float32, device=qkv.device)
    _build.call("fitclip_attn_amax", qkv.data_ptr(), scales.data_ptr(), frames, seq, triple // 3,
                int(block))
    attn_amax.launches += 1
    return scales


def s8_operands_plain(qkv: torch.Tensor, block: int):
    """S2's int8 operands: q, k and v as rint(x * (127 / amax)) clipped to
    +-127, int8 (frames, L, W) each, with their per-frame amax (frames, 3).
    127 / amax is one fp32 division, as the script and the kernel take it
    (``127.0 / amax`` would be reciprocal(amax) * 127, two roundings)."""
    frames, _, triple = qkv.shape
    width = triple // 3
    amax = attn_amax_plain(qkv, block).repeat_interleave(block, dim=0)[:frames]
    inv = torch.full_like(amax, 127.0) / amax
    x32 = qkv.float()
    ops = [quantize_rint(x32[..., p * width:(p + 1) * width] * inv[:, p, None, None])
           for p in range(3)]
    return (*ops, amax)


def attention_s8_plain(qkv: torch.Tensor, heads: int, scale: float, block: int,
                       av8: bool) -> torch.Tensor:
    """The plain version of ``attention_i8qk`` (av8 False) and
    ``attention_i8qkav`` (av8 True), output in qkv's dtype."""
    frames, seq, triple = qkv.shape
    width = triple // 3
    q8, k8, v8, amax = s8_operands_plain(qkv, block)

    def split(t):
        return t.float().reshape(frames, seq, heads, width // heads).transpose(1, 2)

    # int8 products summed in fp32 are exact here: |sum| <= 127^2 * max(D, L) < 2^24.
    logit_scale = (amax[:, 0] * amax[:, 1] * scale / (127.0 * 127.0)).view(frames, 1, 1, 1)
    logits = (split(q8) @ split(k8).transpose(-1, -2)) * logit_scale
    exps = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    denom = exps.sum(dim=-1, keepdim=True)
    if av8:
        weights = torch.round(exps / denom * 127.0)
        out = (weights @ split(v8)) * (amax[:, 2] / (127.0 * 127.0)).view(frames, 1, 1, 1)
    else:
        v = qkv[..., 2 * width:].reshape(frames, seq, heads, width // heads).transpose(1, 2)
        out = (exps / denom).to(qkv.dtype).float() @ v.float()
    return out.transpose(1, 2).reshape(frames, seq, width).to(qkv.dtype)


def _attention_s8(av8: bool, doc: str):
    @_counted("attention_i8qkav" if av8 else "attention_i8qk", doc)
    def wrapper(qkv, scales, heads, scale, block=1):
        if qkv.device.type == "cpu":
            return attention_s8_plain(qkv, heads, scale, block, av8)
        _build.check_cuda_operand("qkv", qkv, torch.bfloat16, 3)
        _build.check_cuda_operand("scales", scales, torch.float32, 2)
        frames, seq, triple = qkv.shape
        if triple != 3 * heads * A.HEAD_DIM:
            raise ValueError(f"the s8 attention takes head_dim {A.HEAD_DIM}; got (B, L, 3W) = "
                             f"{tuple(qkv.shape)} with {heads} heads")
        if scales.shape != (-(-frames // block), 3):
            raise ValueError(f"scales must be ({-(-frames // block)}, 3), got {tuple(scales.shape)}")
        smem = _build.library().fitclip_attention_s8_smem_bytes(seq, int(av8))
        if smem > A.SMEM_LIMIT:
            raise ValueError(f"sequence length {seq} needs {smem} bytes of shared memory per "
                             f"block; an H100 block has {A.SMEM_LIMIT}")
        out = torch.empty(frames, seq, triple // 3, dtype=qkv.dtype, device=qkv.device)
        _build.call("fitclip_attention_s8", qkv.data_ptr(), scales.data_ptr(), out.data_ptr(),
                    frames, seq, heads, int(block), float(scale), int(av8))
        wrapper.launches += 1
        return out
    return wrapper


_S2_S8 = ("scales from attn_amax. Replaces the `{}` mode of "
          "scripts/bench_attn_int8.py:_variant_kernel")
attention_i8qk = _attention_s8(False, "int8 q and k, QK^T on s8 mma.sync.m16n8k32, fp32 "
                                      "softmax, bf16 weights, P.V on bf16 mma.sync in fp32 "
                                      "-> bf16; "
                                      + _S2_S8.format("i8qk") + ".")
attention_i8qkav = _attention_s8(True, "as attention_i8qk, with weights rint(w * 127) and v "
                                       "int8, P.V also on s8 mma.sync -> bf16; "
                                       + _S2_S8.format("i8qkav") + ".")

WRAPPERS = (ln_quant_one, ln_quant_fold, ln_quant_cast, attention_div, attention_fold2,
            attention_sm2, attention_sm2div, attention_nomax, attention_cast, slice_requant,
            int8_gemm_sigmoid, int8_gemm_bf16, int8_gemm_fold, int8_gemm_fold16,
            int8_gemm_sigmoid_cast, attention_head0, attention_bf16logits, attention_nosoftmax,
            attn_amax, attention_i8qk, attention_i8qkav)
