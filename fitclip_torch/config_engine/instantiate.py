"""Recursive ``_target_`` instantiation (port of
``fitclip_tpu/config_engine/instantiate.py``; a subset of
hydra.utils.instantiate): dotted-path import, nested dict/list instantiation,
``_partial_`` (a functools.partial), ``_args_`` positionals, kwargs at call
time, and ``_convert_``/``_recursive_`` (accepted and ignored: plain dicts are
returned everywhere).

The configs under ``config/`` name the JAX package's factories. A target
``fitclip_tpu.<path>`` resolves to ``fitclip_torch.<path>``; a target that the
port lacks raises, naming it, and never falls back to the JAX package. Other
targets import as they are named.
"""

import functools
import importlib
from typing import Any, Mapping

JAX_PACKAGE, PORT_PACKAGE = "fitclip_tpu", "fitclip_torch"


class NotPortedError(ImportError):
    pass


def port_target(path: str) -> str:
    """``fitclip_tpu.<path>`` -> ``fitclip_torch.<path>``; other paths unchanged."""
    head, _, rest = path.partition(".")
    return f"{PORT_PACKAGE}.{rest}" if head == JAX_PACKAGE and rest else path


def _import_target(path: str) -> Any:
    module_path, _, attr = path.rpartition(".")
    if not module_path:
        raise ImportError(f"_target_ '{path}' is not a dotted path")
    try:
        module = importlib.import_module(module_path)
    except ModuleNotFoundError as e:
        if e.name is None or not module_path.startswith(e.name):
            raise  # the module exists but one of its imports is missing
        # the target may be a nested attribute (module.Class.method)
        return getattr(_import_target(module_path), attr)
    return getattr(module, attr)


def resolve_target(path: str) -> Any:
    ported = port_target(path)
    try:
        return _import_target(ported)
    except (ImportError, AttributeError) as e:
        if ported == path:
            raise
        raise NotPortedError(
            f"_target_ {path!r} has no counterpart in {PORT_PACKAGE} ({ported!r}: {e}); "
            "see ROADMAP.md for the modules still to port") from e


def instantiate(node: Any, *args: Any, **kwargs: Any) -> Any:
    if isinstance(node, Mapping):
        if "_target_" in node:
            target = resolve_target(node["_target_"])
            positional = list(args) + [instantiate(a) for a in node.get("_args_", ())]
            call_kwargs = {
                key: instantiate(value) for key, value in node.items()
                if key not in ("_target_", "_partial_", "_args_", "_convert_", "_recursive_")
            }
            call_kwargs.update(kwargs)
            if node.get("_partial_", False):
                return functools.partial(target, *positional, **call_kwargs)
            return target(*positional, **call_kwargs)
        return {key: instantiate(value) for key, value in node.items()}
    if isinstance(node, list):
        return [instantiate(value) for value in node]
    return node
