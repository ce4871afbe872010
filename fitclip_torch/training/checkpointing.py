"""Checkpoint save and restore of the whole TrainState (port of
``fitclip_tpu/training/checkpointing.py``, which writes Orbax directories).

A checkpoint is one ``torch.save`` file of CPU tensors: {"step", "params":
{name: tensor}, "opt_state": {"count", "mu", "nu"}, "max_logit_scale"}, with
the callback state (best-monitor value, early-stopping counters) in a JSON
sidecar beside it, ``<path>.trainer.json``. Restoring copies every tensor into
a state built for the same configuration, so a run resumes bit for bit. The
files are the port's own format."""

import json
import os
import pickle
from typing import Any, Dict, Optional

import torch

from fitclip_torch.training.state import TrainState


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def state_dict(state: TrainState) -> Dict[str, Any]:
    opt = state.opt_state
    return {"step": int(state.step),
            "params": _cpu(state.named_parameters()),
            "opt_state": {"count": int(opt["count"]), "mu": _cpu(opt["mu"]),
                          "nu": _cpu(opt["nu"])},
            "max_logit_scale": state.max_logit_scale.detach().cpu()}


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write atomically: a concurrent reader never sees a partial file."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    partial = f"{path}.{os.getpid()}.partial"
    torch.save(state_dict(state), partial)
    os.replace(partial, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Copy a checkpoint into ``template`` (a state of the same configuration:
    the same parameters, freeze mask and moment dtype), in place."""
    saved = load_checkpoint(path)
    named = template.named_parameters()
    if set(saved["params"]) != set(named):
        raise ValueError(f"{path} holds other parameters than this train state: "
                         f"{sorted(set(saved['params']) ^ set(named))[:5]}")
    with torch.no_grad():
        for name, param in named.items():
            param.copy_(saved["params"][name])
        for key in ("mu", "nu"):
            for name, moment in template.opt_state[key].items():
                source = saved["opt_state"][key][name]
                if source.shape != moment.shape or source.dtype != moment.dtype:
                    raise ValueError(f"{path}: moment {key}[{name}] is {source.dtype} "
                                     f"{tuple(source.shape)}, this optimizer keeps "
                                     f"{moment.dtype} {tuple(moment.shape)}")
                moment.copy_(source)
        template.max_logit_scale.copy_(saved["max_logit_scale"])
    template.opt_state["count"] = int(saved["opt_state"]["count"])
    template.step = int(saved["step"])
    return template


def is_full_train_state(path: str) -> bool:
    """True when the file holds a whole TrainState (a full resume is possible);
    False for anything else or an unreadable path."""
    try:
        saved = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True,
                           mmap=True)
    except (OSError, RuntimeError, ValueError, pickle.UnpicklingError):
        return False
    return isinstance(saved, dict) and {"step", "params", "opt_state"} <= set(saved)


def _trainer_state_path(checkpoint_path: str) -> str:
    return os.path.abspath(checkpoint_path).rstrip(os.sep) + ".trainer.json"


def save_trainer_state(checkpoint_path: str, data: Dict[str, Any]) -> None:
    with open(_trainer_state_path(checkpoint_path), "w") as file:
        json.dump(data, file)


def load_trainer_state(checkpoint_path: str) -> Optional[Dict[str, Any]]:
    path = _trainer_state_path(checkpoint_path)
    if not os.path.exists(path):
        return None
    with open(path) as file:
        return json.load(file)
