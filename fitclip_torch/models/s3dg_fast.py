"""The fast eval forward of S3D-G: port of ``fitclip_tpu/models/s3dg_fast.py``
(``s3dg_fast_apply`` and ``quantize_s3dg_fast``) with the JAX package's defaults
fixed: a plain fp32 mean, one block-diagonal gate matmul, conv_2b as a channel
matmul over the stem's output, and the stem always through K7 (``ops/s3dg_stem.py``).

Same parameters as the module path (``models/s3dg.py``), restructured:
- BatchNorm folded into each conv in fp32, then cast (``fold_bn``);
- each Inception block's three parallel 1x1x1 branch stems merged into one
  channel matmul;
- self-gating from one fp32 mean of the block output and one block-diagonal
  gate matmul, applied after the max pool that follows mixed_3c, mixed_4f and
  the stem's conv_2c (sigmoid gates are positive, so max commutes with them),
  and for mixed_5c on the pooled (B, C) vector (the mean is linear).

int8: ``quantize_s3dg_fast`` adds W8A8 sites for each block's merged stems and
b3 conv from ``from_block`` on, and the FC (conv_2b too when every site is
quantized). A site runs a static per-tensor quantize on the activation, then
the Hopper int8 GEMM with the dequant and bias epilogue (``ops/block.py:
int8_gemm_bias``), then ReLU; in calibration (``dynamic_observing``) it runs the
dynamic per-row quantize and records its input's abs-max.
"""

from typing import Optional

import numpy as np
import torch

from fitclip_torch.models.s3dg import (BLOCKS, S3DG, STConv3D, conv3d_ndhwc,
                                       max_pool_3d_tf_padding)
from fitclip_torch.ops.block import dense_operands, int8_gemm_bias, int8_gemm_bias_plain
from fitclip_torch.ops.quant import quantize_rint, quantize_weight
from fitclip_torch.ops.s3dg_stem import BN_EPS, fold_bn, s3dg_stem, s3dg_stem_plain


# --- operands, folded once per parameter version -----------------------------

def _conv_operands(st: STConv3D, dtype):
    ops = [fold_bn(st.conv1.kernel, st.bn1, dtype)]
    if st.separable:
        ops.append(fold_bn(st.conv2.kernel, st.bn2, dtype))
    return ops


def _matrix(st: STConv3D, dtype):
    kernel, bias = fold_bn(st.conv1.kernel, st.bn1, dtype)
    return kernel.reshape(kernel.shape[-2], kernel.shape[-1]), bias


def _gate_operands(gates):
    """One fp32 (C, C) block-diagonal kernel and (C,) bias for the gate FCs."""
    kernel = torch.block_diag(*(g.fc.kernel.float() for g in gates))
    return kernel, torch.cat([g.fc.bias.float() for g in gates])


def fold_fast_operands(model: S3DG, dtype: torch.dtype) -> dict:
    """Every operand of the fast forward, folded from the module's parameters."""
    ops = {"stem": _conv_operands(model.conv1, dtype)[0],
           "conv_2b": _matrix(model.conv_2b, dtype),
           "conv_2c": _conv_operands(model.conv_2c, dtype),
           "gating": (model.gating.fc.kernel.float(), model.gating.fc.bias.float()),
           "fc": (model.fc.kernel.to(dtype), model.fc.bias.to(dtype))}
    for name in BLOCKS:
        block = getattr(model, name)
        stems = [_matrix(getattr(block, b), dtype) for b in ("conv_b0", "conv_b1_a", "conv_b2_a")]
        ops[name] = {"merged": (torch.cat([k for k, _ in stems], dim=-1),
                                torch.cat([b for _, b in stems])),
                     "b3": _matrix(block.conv_b3_b, dtype),
                     "b1": _conv_operands(block.conv_b1_b, dtype),
                     "b2": _conv_operands(block.conv_b2_b, dtype),
                     "gate": _gate_operands([getattr(block, f"gating_b{i}") for i in range(4)])}
    for path, site in _sites(model):
        ops[f"int8/{path}"] = dense_operands(site)
    return ops


def _sites(model: S3DG):
    out = []
    for name, node in model.int8.items():
        if isinstance(node, torch.nn.ModuleDict):
            out += [(f"{name}/{leaf}", site) for leaf, site in node.items()]
        else:
            out.append((name, node))
    return out


def fast_operands(model: S3DG, dtype: torch.dtype) -> dict:
    """``fold_fast_operands``, kept on the module while every parameter and buffer
    is unchanged (identity, storage and in-place version), so that calibration,
    ``load_state_dict`` and ``.to()`` all refold."""
    tensors = [*model.parameters(), *model.buffers()]
    key = (dtype, tuple((id(t), t.data_ptr(), t._version) for t in tensors))
    cache = getattr(model, "_fast_cache", None)
    if cache is None or cache[0] != key:
        with torch.no_grad():
            model._fast_cache = (key, fold_fast_operands(model, dtype))
    return model._fast_cache[1]


# --- the forward --------------------------------------------------------------

def _separable(x, ops, padding: int = 1):
    (k1, b1), (k2, b2) = ops
    x = torch.relu(conv3d_ndhwc(x, k1, 1, (0, padding, padding)) + b1)
    return torch.relu(conv3d_ndhwc(x, k2, 1, (padding, 0, 0)) + b2)


def _dense_relu(x, ops):
    kernel, bias = ops
    return torch.relu(x @ kernel + bias)


def _spatial_mean(x):
    return x.mean(dim=tuple(range(1, x.dim() - 1)), dtype=torch.float32)


def _gate(x, ops, dtype):
    kernel, bias = ops
    return torch.sigmoid(_spatial_mean(x) @ kernel + bias).to(dtype)


def _int8_site(site, operands, x, relu: bool, gemm):
    """A quantized channel matmul over x's last axis: static quantize + the int8
    GEMM, or (in calibration) the module's dynamic quantize, which records x's
    abs-max."""
    if site.dynamic:
        out = site(x)
    else:
        weight_q, out_scale, bias, inv = operands
        x_q = quantize_rint(x.float() * inv).reshape(-1, x.shape[-1])
        out = gemm(x_q, weight_q, out_scale, bias, x.dtype).reshape(*x.shape[:-1], -1)
    return torch.relu(out) if relu else out


def _block(model, ops, name, x, dtype, quantized, gemm, defer_gate=False):
    b0, b1a, _, _, _, _ = getattr(model, name).widths
    block_ops = ops[name]
    if quantized:
        merged = _int8_site(model.int8[name]["merged"], ops[f"int8/{name}/merged"], x, True,
                            gemm)
        branch3 = _int8_site(model.int8[name]["b3"], ops[f"int8/{name}/b3"],
                             max_pool_3d_tf_padding(x, 3, 1), True, gemm)
    else:
        merged = _dense_relu(x, block_ops["merged"])
        branch3 = _dense_relu(max_pool_3d_tf_padding(x, 3, 1), block_ops["b3"])
    branch1 = _separable(merged[..., b0:b0 + b1a], block_ops["b1"])
    branch2 = _separable(merged[..., b0 + b1a:], block_ops["b2"])
    out = torch.cat([merged[..., :b0], branch1, branch2, branch3], dim=-1)
    gates = _gate(out, block_ops["gate"], dtype)
    if defer_gate:
        return out, gates
    return out * gates[:, None, None, None, :]


def s3dg_fast_apply(model: S3DG, video: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
                    int8: bool = False, plain: bool = False) -> torch.Tensor:
    """The S3DG module's function at eval, restructured: (B, T, H, W, 3) pixels ->
    (B, 512) in ``dtype``. The encoders run bf16, the stem kernel's type; fp32
    runs where the stem takes its plain version (a CPU tensor, or ``plain``).
    ``int8`` runs the module's int8 sites (``quantize_s3dg_fast``); ``plain``
    swaps the Hopper kernels (stem, int8 GEMM) for their plain versions."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the fast S3DG forward runs in bf16 (or fp32), not {dtype}")
    if int8 and not model.quantized:
        raise ValueError("the int8 forward needs a model with int8 sites (quantize_s3dg_fast)")
    stem, gemm = (s3dg_stem_plain, int8_gemm_bias_plain) if plain else (s3dg_stem,
                                                                         int8_gemm_bias)
    ops = fast_operands(model, dtype)
    q = model.int8 if int8 else {}
    x = video.to(dtype)
    if model.use_space_to_depth:
        x = stem(x, *ops["stem"])
    else:
        kernel, bias = ops["stem"]
        x = torch.relu(conv3d_ndhwc(x, kernel, 2, (1, 3, 3)) + bias)
        x = max_pool_3d_tf_padding(x, (1, 3, 3), (1, 2, 2))
    if "conv_2b" in q:
        x = _int8_site(q["conv_2b"], ops["int8/conv_2b"], x, True, gemm)
    else:
        x = _dense_relu(x, ops["conv_2b"])
    x = _separable(x, ops["conv_2c"])
    gate = _gate(x, ops["gating"], dtype)  # from the 56^2 activation, applied at 28^2
    x = max_pool_3d_tf_padding(x, (1, 3, 3), (1, 2, 2)) * gate[:, None, None, None, :]

    def block(name, x, defer_gate=False):
        return _block(model, ops, name, x, dtype, name in q, gemm, defer_gate)

    x = block("mixed_3b", x)
    x, gate = block("mixed_3c", x, defer_gate=True)
    x = max_pool_3d_tf_padding(x, 3, 2) * gate[:, None, None, None, :]
    for name in ("mixed_4b", "mixed_4c", "mixed_4d", "mixed_4e"):
        x = block(name, x)
    x, gate = block("mixed_4f", x, defer_gate=True)
    x = max_pool_3d_tf_padding(x, 2, 2) * gate[:, None, None, None, :]
    x = block("mixed_5b", x)
    x, gate = block("mixed_5c", x, defer_gate=True)
    x = _spatial_mean(x).to(dtype) * gate
    if not model.use_last_layer:
        return x
    if "fc" in q:
        return _int8_site(q["fc"], ops["int8/fc"], x, False, gemm)
    kernel, bias = ops["fc"]
    return x @ kernel + bias


# --- int8 quantization of a numpy parameter tree (the JAX layout) -------------

def _folded_np(conv: dict, bn: dict) -> tuple:
    """``fold_bn`` in numpy fp32, on a tree's conv and BatchNorm nodes, as (in, out)."""
    inv = (np.float32(1.0) / np.sqrt(np.asarray(bn["running_var"], np.float32)
                                     + np.float32(BN_EPS))) * np.asarray(bn["weight"], np.float32)
    shift = np.asarray(bn["bias"], np.float32) - np.asarray(bn["running_mean"], np.float32) * inv
    kernel = np.asarray(conv["kernel"], np.float32) * inv
    return kernel.reshape(kernel.shape[-2], kernel.shape[-1]), shift


def _site(kernel2d: np.ndarray, bias: np.ndarray) -> dict:
    node = quantize_weight(kernel2d)
    node["bias"] = np.asarray(bias, np.float32)
    node["act_scale"] = np.ones((1,), np.float32)
    return node


def quantize_s3dg_fast(params: dict, from_block: Optional[str] = "mixed_4b") -> dict:
    """An S3DG tree (numpy, the JAX layout) -> the same tree plus an "int8"
    subtree: per-output-channel int8 weights of the BN-folded (fp32) 1x1x1 convs,
    act_scale ones until calibrated. Sites: each block's merged stems and b3 conv
    from ``from_block`` on, and the FC; ``from_block`` None or "conv_2b" also
    quantizes conv_2b and every block."""
    if "int8" in params:
        return params
    names = list(BLOCKS)
    start = 0 if from_block in (None, "conv_2b") else names.index(from_block)
    q = {}
    if start == 0:
        q["conv_2b"] = _site(*_folded_np(params["conv_2b"]["conv1"], params["conv_2b"]["bn1"]))
    for name in names[start:]:
        block = params[name]
        kernels, biases = zip(*(_folded_np(block[b]["conv1"], block[b]["bn1"])
                                for b in ("conv_b0", "conv_b1_a", "conv_b2_a")))
        q[name] = {"merged": _site(np.concatenate(kernels, axis=-1), np.concatenate(biases)),
                   "b3": _site(*_folded_np(block["conv_b3_b"]["conv1"],
                                           block["conv_b3_b"]["bn1"]))}
    q["fc"] = _site(params["fc"]["kernel"], params["fc"]["bias"])
    return {**params, "int8": q}

