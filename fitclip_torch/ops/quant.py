"""W8A8 int8 inference for the transformer's dense layers (port of
``fitclip_tpu/ops/quant.py``).

- Weights: symmetric per-output-channel int8, quantized offline by
  ``quantize_clip_params`` on a numpy parameter tree in the JAX package's
  layout (``kernel`` as (in, out), scan-stacked ``(layers, ...)`` leaves), so
  both packages produce the same arrays; ``convert/from_jax.py`` loads them.
- Activations: dynamic per-row int8 (``int8_dense``, the calibration mode) or
  static per-tensor int8 from a calibrated ``act_scale`` (``int8_dense_static``).
- int32 accumulation, fp32 dequant epilogue, cast to the activation dtype.

The activation-scale functions work on any module tree whose int8 denses
carry an ``act_scale`` buffer. A site is named by its module path with the
layer indices dropped ("visual/transformer/blocks/attn/in_proj"), and its
scales stack over the layers as (layers, 1): the JAX package's parameter path
and shape, so an act-scale ``.npz`` written by either package loads into the
other.

These denses are XLA in the JAX package, not Pallas. The static dense takes
its product through the operator of the fused layer's int8 GEMM
(``ops/block.py:int8_gemm_bias``: the Hopper kernel on the card); the dynamic
(calibration) dense stays plain PyTorch.
"""

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

QUANT_EPS = 1e-8

_BLOCK_DENSE_NAMES = ("mlp_fc", "mlp_proj")
_ATTN_DENSE_NAMES = ("in_proj", "out_proj")
# Frozen-in-Time's SpaceTimeTransformer: qkv/proj under attn and timeattn.
FIT_DENSE_NAMES = ("qkv", "proj", "mlp_fc1", "mlp_fc2")


def quantize_weight(kernel: np.ndarray) -> Dict[str, np.ndarray]:
    """fp32 (..., in, out) -> {kernel_q int8, scale fp32 (..., out)}:
    symmetric per-output-channel scales, leading (layer) axes preserved."""
    kernel = np.asarray(kernel, np.float32)
    amax = np.maximum(np.abs(kernel).max(axis=-2), QUANT_EPS)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.rint(kernel / scale[..., None, :]), -127, 127).astype(np.int8)
    return {"kernel_q": q, "scale": scale}


def _quantize_dense_node(node):
    quantized = quantize_weight(node["kernel"])
    kernel = np.asarray(node["kernel"])
    return {"kernel_q": quantized["kernel_q"], "scale": quantized["scale"],
            "bias": np.asarray(node["bias"], np.float32),
            "act_scale": np.ones(kernel.shape[:-2] + (1,), np.float32)}


def quantize_clip_params(params, names: Optional[tuple] = None):
    """Float numpy CLIP tree (JAX layout) -> the int8-dense tree. act_scale
    leaves start at the all-ones "uncalibrated" sentinel. ``names`` picks the
    dense nodes to quantize (FIT_DENSE_NAMES for a FiT video tree)."""
    if names is None:
        names = _BLOCK_DENSE_NAMES + _ATTN_DENSE_NAMES

    def walk(node):
        if not isinstance(node, dict):
            return np.asarray(node)
        return {key: (_quantize_dense_node(value)
                      if key in names and isinstance(value, dict) and "kernel" in value
                      else walk(value))
                for key, value in node.items()}

    return walk(params)


def quantize_rint(x32: torch.Tensor) -> torch.Tensor:
    """clip(round(x), -127, 127) as int8; torch.round rounds half to even."""
    return torch.clamp(torch.round(x32), -127, 127).to(torch.int8)


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x int8 (N, K)^T, returned as float32 (M, N).

    The plain product of the int8 GEMMs. CUDA has no integer matmul, and
    float32 is not exact once 127^2 * K > 2^24, so on the card the product is
    taken in float64 (exact below 2^53). Either way the int32 sum reaches
    float32 by one round-to-nearest, as ``acc.astype(float32)`` does."""
    if a.device.type == "cuda":
        return (a.double() @ w.double().T).float()
    return (a.int() @ w.int().T).float()


def int8_dense(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """DYNAMIC per-row activation quant (the calibration mode): divides by the
    row scale, as ops/quant.py:int8_dense does."""
    x32 = x.float()
    amax = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True), QUANT_EPS)
    row_scale = amax / 127.0
    x_q = quantize_rint(x32 / row_scale)
    acc = int_matmul(x_q.reshape(-1, x.shape[-1]), weight_q).reshape(*x.shape[:-1], -1)
    out = acc * (row_scale * scale.float()) + bias.float()
    return out.to(x.dtype)


def int8_dense_static(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """Static per-tensor activation quant: multiplies by 127 / act_scale. The
    product and its epilogue, acc * ((act / 127) * scale) + bias, are K1's int8
    GEMM's operator (``ops/block.py:int8_gemm_bias``: the kernel on the card,
    its plain version on the CPU)."""
    from fitclip_torch.ops.block import int8_gemm_bias  # block.py imports this module

    inv = 127.0 / torch.clamp_min(act_scale.float(), QUANT_EPS)
    x_q = quantize_rint(x.float() * inv).reshape(-1, x.shape[-1])
    out_scale = (act_scale.float() / 127.0) * scale.float()
    out = int8_gemm_bias(x_q, weight_q, out_scale, bias.float(), x.dtype)
    return out.reshape(*x.shape[:-1], -1)


def act_scale_sites(model: nn.Module) -> Dict[str, List[nn.Module]]:
    """{site path: [the site's int8 dense of each layer, in layer order]}."""
    sites: Dict[str, List[nn.Module]] = {}
    for name, module in model.named_modules():
        if isinstance(getattr(module, "act_scale", None), torch.Tensor):
            path = "/".join(part for part in name.split(".") if not part.isdigit())
            sites.setdefault(path, []).append(module)
    return sites


@contextlib.contextmanager
def dynamic_observing(model: nn.Module):
    """Every int8 dense of ``model`` in dynamic-quant mode, recording its
    input's abs-max in ``observed_amax``: the calibration pass."""
    denses = [m for modules in act_scale_sites(model).values() for m in modules]
    saved = [(m.dynamic, m.observe) for m in denses]
    try:
        for m in denses:
            m.dynamic, m.observe, m.observed_amax = True, True, None
        yield
    finally:
        for m, (dynamic, observe) in zip(denses, saved):
            m.dynamic, m.observe = dynamic, observe


def observed_act_amax(model: nn.Module, prefix: str = "") -> Dict[str, np.ndarray]:
    """{site: (layers, 1) abs-max} that the sites under ``prefix`` observed."""
    return {site: torch.cat([m.observed_amax for m in modules]).reshape(-1, 1)
            .float().cpu().numpy()
            for site, modules in act_scale_sites(model).items() if site.startswith(prefix)}


def merge_act_amax(a, b):
    """Elementwise-max merge of two act-amax dicts; either may be None, and a
    site that only one observed (a batch without text) keeps its abs-max."""
    if a is None:
        return b
    if b is None:
        return a
    return {key: np.maximum(np.asarray(a[key]), np.asarray(b[key]))
            if key in a and key in b else np.asarray(a[key] if key in a else b[key])
            for key in a.keys() | b.keys()}


def _write_scales(modules: List[nn.Module], values: np.ndarray) -> None:
    values = np.asarray(values, np.float32).reshape(len(modules), 1)
    with torch.no_grad():
        for module, value in zip(modules, values):
            module.act_scale.copy_(torch.from_numpy(value))


def apply_act_scales(model: nn.Module, act_amax: Dict[str, np.ndarray],
                     margin: float = 1.0) -> nn.Module:
    """Write observed activation abs-maxes (times margin, floored at
    QUANT_EPS) into the act_scale buffers, in place; sites missing from
    act_amax keep their scales."""
    for path, modules in act_scale_sites(model).items():
        if path in act_amax:
            amax = np.asarray(act_amax[path], np.float32).reshape(len(modules), 1)
            _write_scales(modules, np.maximum(amax * margin, QUANT_EPS))
    return model


def save_act_scales(path: str, model: nn.Module) -> None:
    """Persist the activation scales (only) to an .npz, one (layers, 1) array per site."""
    arrays = {site: np.stack([m.act_scale.detach().float().cpu().numpy()
                              for m in modules]).reshape(len(modules), 1)
              for site, modules in act_scale_sites(model).items()}
    np.savez(path, **arrays)


def load_act_scales(path: str, model: nn.Module) -> nn.Module:
    """Write persisted scales into the model, in place. Raises KeyError if the
    file does not cover every site: scales of another architecture must not
    half-apply."""
    with np.load(path) as loaded:
        for site, modules in act_scale_sites(model).items():
            _write_scales(modules, loaded[site])
    return model


def require_calibrated(model: nn.Module, context: str = "serving") -> None:
    """Fail closed on a model whose activation scales were never calibrated
    (the all-ones sentinel of a freshly quantized site)."""
    stale = [site for site, modules in act_scale_sites(model).items()
             if all(bool(torch.all(m.act_scale == 1.0)) for m in modules)]
    if stale:
        raise ValueError(
            f"{context}: {len(stale)} quantized site(s) have uncalibrated "
            f"activation scales (all-ones sentinel), e.g. {stale[:3]} — "
            "calibrate (ClipVideoTextEncoder.calibrate) or load a persisted "
            ".npz (load_act_scales) first")
