"""The reference's dense layer, in float32 or at a lower integer precision.

``bits=None`` is the plain float32 product. Otherwise ``bits`` is the
control's precision: an integer (weights rounded to that many bits per output
channel, the activation per tensor by its own abs-max, symmetric) or "fp8"
(both scaled so that their abs-max is e4m3's largest value, 448, and rounded
to e4m3); then the product in float32. The control puts the reference in the
program's place one precision below what the configuration states, so the
comparison must fail it. ``round_tensor`` rounds a stored activation (the
residual stream) the same way. The rounding's gradient passes straight
through."""

from typing import Optional, Union

import torch

FP8_MAX = 448.0


def _fake_quant(x: torch.Tensor, amax: torch.Tensor, bits: Union[int, str]) -> torch.Tensor:
    if bits == "fp8":
        scale = torch.clamp_min(amax, 1e-12) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    qmax = 2 ** (int(bits) - 1) - 1
    scale = torch.clamp_min(amax, 1e-8) / qmax
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def round_tensor(x: torch.Tensor, bits: Union[int, str, None]) -> torch.Tensor:
    """x rounded per tensor to ``bits`` (the control's stored activations); x itself for None."""
    if bits is None:
        return x
    return x + (_fake_quant(x, x.detach().abs().amax(), bits) - x).detach()


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           bits: Union[int, str, None] = None) -> torch.Tensor:
    """x (..., in) by weight (out, in) plus bias, in float32."""
    x, weight = x.float(), weight.float()
    if bits is not None:
        weight = weight + (_fake_quant(weight, weight.detach().abs().amax(dim=1, keepdim=True),
                                       bits) - weight).detach()
        x = x + (_fake_quant(x, x.detach().abs().amax(), bits) - x).detach()
    out = x @ weight.T
    return out if bias is None else out + bias.float()
