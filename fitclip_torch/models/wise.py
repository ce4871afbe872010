"""WiSE-FT weight-space ensembling over state dicts (port of
``fitclip_tpu/models/wise.py``).

Reference semantics (``aligner/wise.py:10-23``): elementwise
``(1 - w) * params1 + w * params2`` over identically structured parameter
sets, here two state dicts with the same names and shapes.

Only float weights merge. The JAX package merges an int8 weight too, into
fractional floats that are no longer an int8 weight; the port refuses it:
merge the float encoders, then quantize the result (ROADMAP.md, queue 3).
"""

from typing import Dict, Mapping

import torch


def wise_params(params1: Mapping[str, torch.Tensor], params2: Mapping[str, torch.Tensor],
                weight_for_2: float = 0.5) -> Dict[str, torch.Tensor]:
    """Linear interpolation of two state dicts (released recipe: 0.4), on
    params1's devices."""
    if set(params1) != set(params2):
        raise ValueError(
            "WiSE-FT requires identical parameter structures: only in model1 "
            f"{sorted(set(params1) - set(params2))[:5]}, only in model2 "
            f"{sorted(set(params2) - set(params1))[:5]}")
    for name, a in params1.items():
        b = params2[name]
        if a.shape != b.shape:
            raise ValueError(f"WiSE-FT requires identical parameter structures: {name} is "
                             f"{tuple(a.shape)} in model1 and {tuple(b.shape)} in model2")
        if not (a.is_floating_point() and b.is_floating_point()):
            raise ValueError(f"WiSE-FT merges float weights, and {name} is {a.dtype} in model1 "
                             f"and {b.dtype} in model2 (an int8-loaded encoder): merge the "
                             "float encoders and quantize the result")
    return {name: (1 - weight_for_2) * a + weight_for_2 * params2[name].to(a.device)
            for name, a in params1.items()}
