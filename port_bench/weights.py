"""Seeded weights, made on the device in one large draw.

A family lists its checkpoint's leaves as (name, shape, kind); every leaf is
a slice of one standard-normal draw, scaled by its kind. Denses and
convolutions are LeCun-normal (std = fan_in ** -0.5), embeddings 0.02,
positions 0.01, projections width ** -0.5; biases and LayerNorm shifts 0.02,
LayerNorm scales 1 + 0.1 z, so that no leaf is a constant a fault could hide
behind."""

import math
from typing import Dict, List, Tuple

import torch

from port_bench.traffic import generator

Leaf = Tuple[str, Tuple[int, ...], str]


def _scale(kind: str, shape) -> Tuple[float, float]:
    """(shift, std) of a leaf of this kind."""
    if kind == "dense":  # (out, in)
        return 0.0, shape[1] ** -0.5
    if kind == "conv":  # (out, in, kh, kw)
        return 0.0, math.prod(shape[1:]) ** -0.5
    if kind == "proj":  # (in, out)
        return 0.0, shape[0] ** -0.5
    if kind == "ln_weight":
        return 1.0, 0.1
    return 0.0, {"bias": 0.02, "ln_bias": 0.02, "embedding": 0.02, "position": 0.01}[kind]


def make(leaves: List[Leaf], seed: int, tag: str, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} drawn from the stream ``tag`` of ``seed``."""
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    draw = torch.randn(total, generator=generator(seed, tag, device), device=device)
    out, offset = {}, 0
    for name, shape, kind in leaves:
        n = math.prod(shape)
        shift, std = _scale(kind, shape)
        out[name] = (draw[offset:offset + n].view(shape) * std + shift)
        offset += n
    return out
