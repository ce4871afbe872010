"""Train state: the encoder, the learnable temperature(s), AdamW and its moments
(port of ``fitclip_tpu/training/state.py``).

- ``logit_scale`` starts at -log(init_temperature) and is clamped to
  -log(min_temperature) after every optimizer step; the teacher-student
  variant carries a second scale, ``ts_logit_scale``, with the same clamp.
- Parameters are named as the port's modules name them, prefixed
  ``encoder.`` (``encoder.visual.transformer.blocks.3.attn.in_proj.weight``).
  Freeze patterns are regexes matched with ``re.search`` against the JAX
  package's slash-joined paths (``encoder/visual/transformer/blocks/attn/
  in_proj/kernel``, ``jax_param_path``), so one pattern freezes the same
  leaves in both packages. The JAX tree stacks a transformer's layers on one
  leaf, so a pattern freezes a parameter in every layer, as there.
- ``AdamW`` updates the parameters in place, with plain ``torch._foreach_*``
  ops: the JAX optimizer is XLA, not a Pallas kernel. ``fused=True`` is
  ``make_fused_adamw``'s math term for term, ``fused=False`` the optax chain
  (``clip_by_global_norm`` + ``adamw`` under a freeze mask); the two differ
  only in how they clip. Frozen parameters carry a 0-dim placeholder moment.
"""

import dataclasses
import logging
import math
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

LOGGER = logging.getLogger(__name__)

Schedule = Union[float, Callable[[int], float]]
_LAYER_NORMS = frozenset(("ln_1", "ln_2", "ln_pre", "ln_post", "ln_final"))
TEMPERATURE_PATTERN = r"^(ts_)?logit_scale$"


def named_parameters(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{"encoder": ClipVideoTextEncoder, "logit_scale": (1,), ...} -> {name: tensor}."""
    named = {f"encoder.{n}": p for n, p in params["encoder"].model.named_parameters()}
    named.update((k, v) for k, v in params.items() if k != "encoder")
    return named


def jax_param_path(name: str) -> str:
    """The JAX package's slash-joined path of a port parameter name:
    ``encoder.text.transformer.blocks.0.ln_1.weight`` ->
    ``encoder/text/transformer/blocks/ln_1/ln/scale``."""
    parts = [p for i, p in enumerate(name.split("."))
             if not (p.isdigit() and i and name.split(".")[i - 1] == "blocks")]
    leaf = parts.pop()
    if parts and parts[-1] in _LAYER_NORMS:
        parts += ["ln", "scale" if leaf == "weight" else "bias"]
    else:
        parts.append("kernel" if leaf == "weight" else leaf)
    return "/".join(parts)


def freeze_mask(named: Mapping[str, torch.Tensor], patterns: Sequence[str]) -> Dict[str, bool]:
    """True = trainable, False = frozen: a parameter is frozen when a pattern
    `re.search`es its JAX path."""
    compiled = [re.compile(p) for p in patterns]
    unused = set(range(len(compiled)))
    mask = {}
    for name in named:
        path = jax_param_path(name)
        hits = [i for i, pattern in enumerate(compiled) if pattern.search(path)]
        unused.difference_update(hits[:1])
        mask[name] = not hits
    for i in sorted(unused):
        LOGGER.warning("Freeze pattern %r matched no parameters", patterns[i])
    return mask


def _pow32(base: float, exponent: int) -> float:
    """base ** exponent in fp32 arithmetic (as JAX computes the bias corrections)."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return float(one - torch.tensor(base, dtype=torch.float32) ** torch.tensor(
        float(exponent), dtype=torch.float32))


@dataclasses.dataclass
class AdamW:
    """AdamW over named parameters, updated in place.

    ``init(named)`` -> {"count": 0, "mu": {name: moment}, "nu": {...}};
    ``apply(named, grads, opt_state)`` -> the new opt_state. Term for term with
    ``make_fused_adamw``: bias correction on count + 1, eps outside the sqrt,
    decoupled weight decay on the old p, the lr schedule called with the count
    before the increment, the global-norm clip over trainable leaves only,
    frozen leaves skipped. ``moment_dtype`` (bfloat16) stores the moments
    narrowed; the update math is fp32 either way."""
    learning_rate: Schedule
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    mask: Optional[Dict[str, bool]] = None
    gradient_clip_val: Optional[float] = None
    moment_dtype: Optional[torch.dtype] = None
    fused: bool = True

    def trainable(self, name: str) -> bool:
        return self.mask is None or self.mask.get(name, True)

    def init(self, named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        def moment(name, p):
            if not self.trainable(name):
                return torch.zeros((), dtype=torch.float32, device=p.device)
            return torch.zeros_like(p, dtype=self.moment_dtype or p.dtype,
                                    memory_format=torch.contiguous_format)
        return {"count": 0, "mu": {n: moment(n, p) for n, p in named.items()},
                "nu": {n: moment(n, p) for n, p in named.items()}}

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        clip = self.gradient_clip_val
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.fused:  # min(1, clip / max(norm, 1e-16)) (state.py:fused_apply)
            return torch._foreach_mul(grads, torch.clamp(clip / torch.clamp(norm, min=1e-16),
                                                         max=1.0))
        # optax.clip_by_global_norm: g if norm < clip else (g / norm) * clip.
        scaled = torch._foreach_div(grads, norm)
        torch._foreach_mul_(scaled, clip)
        return [torch.where(norm < clip, g, s) for g, s in zip(grads, scaled)]

    @torch.no_grad()
    def apply(self, named: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
              opt_state: Mapping[str, Any]) -> Dict[str, Any]:
        count = int(opt_state["count"])
        lr = float(self.learning_rate(count) if callable(self.learning_rate)
                   else self.learning_rate)
        b1, b2 = self.betas
        bc1, bc2 = _pow32(b1, count + 1), _pow32(b2, count + 1)
        names = [n for n in named if self.trainable(n)]
        params = [named[n] for n in names]
        g32 = [grads[n].float() for n in names]
        if self.gradient_clip_val:
            g32 = self._clip(g32)
        mu = [opt_state["mu"][n].float() for n in names]
        nu = [opt_state["nu"][n].float() for n in names]

        new_mu = torch._foreach_mul(mu, b1)
        torch._foreach_add_(new_mu, torch._foreach_mul(g32, 1.0 - b1))
        new_nu = torch._foreach_mul(nu, b2)
        torch._foreach_add_(new_nu, torch._foreach_mul(torch._foreach_mul(g32, g32), 1.0 - b2))
        adam = torch._foreach_div(new_mu, bc1)
        denom = torch._foreach_div(new_nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(adam, denom)
        # p - lr * (adam + weight_decay * p), on the old p.
        update = torch._foreach_mul(params, self.weight_decay)
        torch._foreach_add_(update, adam)
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(params, update)

        out_mu, out_nu = dict(opt_state["mu"]), dict(opt_state["nu"])
        for n, m, v in zip(names, new_mu, new_nu):
            out_mu[n] = m.to(opt_state["mu"][n].dtype)
            out_nu[n] = v.to(opt_state["nu"][n].dtype)
        return {"count": count + 1, "mu": out_mu, "nu": out_nu}


def make_fused_adamw(learning_rate: Schedule, weight_decay: float, betas, eps: float,
                     mask: Optional[Dict[str, bool]], gradient_clip_val: Optional[float],
                     moment_dtype: Optional[torch.dtype] = None) -> AdamW:
    return AdamW(learning_rate, weight_decay, tuple(betas), eps, mask, gradient_clip_val,
                 moment_dtype, fused=True)


_MOMENT_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_optimizer(learning_rate: Schedule, weight_decay: float = 0.01,
                   betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                   freeze_patterns: Optional[Sequence[str]] = None,
                   fit_temperature: bool = True,
                   gradient_clip_val: Optional[float] = None,
                   params_example: Optional[Mapping[str, Any]] = None,
                   fused: bool = False,
                   moment_dtype: Optional[str] = None) -> AdamW:
    """AdamW as the reference configures it (torch.optim.AdamW, lr 3e-6), with
    optional global-norm clipping and freezing. ``fused=False`` is the optax
    chain's math; ``moment_dtype`` ("bfloat16") is fused-only, as in JAX.
    ``params_example`` is a params dict ({"encoder": ..., "logit_scale": ...})
    or {name: tensor}, needed to build a freeze mask."""
    if moment_dtype and not fused:
        raise ValueError("moment_dtype requires the fused optimizer")
    patterns = list(freeze_patterns or [])
    if not fit_temperature:
        patterns.append(TEMPERATURE_PATTERN)
    mask = None
    if patterns:
        if params_example is None:
            raise ValueError("freeze_patterns requires params_example to build the mask")
        named = (named_parameters(params_example) if "encoder" in params_example
                 else params_example)
        mask = freeze_mask(named, patterns)
    return AdamW(learning_rate, weight_decay, tuple(betas), eps, mask, gradient_clip_val,
                 _MOMENT_DTYPES[str(moment_dtype)] if moment_dtype else None, fused=fused)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, Any]  # {"encoder": ClipVideoTextEncoder, "logit_scale": (1,), ["ts_logit_scale"]}
    opt_state: Dict[str, Any]
    max_logit_scale: torch.Tensor  # the clamp bound, kept with the state

    def named_parameters(self) -> Dict[str, torch.Tensor]:
        return named_parameters(self.params)


def init_train_state(encoder: nn.Module, optimizer: AdamW, init_temperature: float = 0.05,
                     min_temperature: float = 0.001,
                     with_teacher_student_scale: bool = False) -> TrainState:
    device = next(encoder.parameters()).device
    params: Dict[str, Any] = {
        "encoder": encoder,
        "logit_scale": nn.Parameter(torch.full((1,), -math.log(init_temperature), device=device)),
    }
    if with_teacher_student_scale:
        params["ts_logit_scale"] = nn.Parameter(
            torch.full((1,), -math.log(init_temperature), device=device))
    return TrainState(step=0, params=params, opt_state=optimizer.init(named_parameters(params)),
                      max_logit_scale=torch.full((1,), -math.log(min_temperature), device=device))


def apply_updates_with_clamp(state: TrainState, grads: Mapping[str, torch.Tensor],
                             optimizer: AdamW) -> TrainState:
    """One optimizer step in place, then the temperature clamp
    logit_scale <= max_logit_scale, as the reference's optimizer_step does."""
    state.opt_state = optimizer.apply(state.named_parameters(), grads, state.opt_state)
    with torch.no_grad():
        for key in ("logit_scale", "ts_logit_scale"):
            if key in state.params:
                scale = state.params[key]
                scale.copy_(torch.minimum(scale, state.max_logit_scale))
    state.step += 1
    return state
