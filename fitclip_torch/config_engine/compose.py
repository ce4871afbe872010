"""Hydra-compatible config composition (port of
``fitclip_tpu/config_engine/compose.py``), reading the repository's
``config/`` tree in place. It implements the subset of Hydra that the configs
use:

- config groups: ``encoder=clip_vit_b_16`` loads ``<dir>/encoder/clip_vit_b_16.yaml``
  into the ``encoder`` key; group dirs nest (``trainer/callbacks=default``).
- ``defaults`` lists in YAML (group defaults, ``_self_`` ordering, null slots,
  ``optional``, and package redirection ``group@key: name``).
- overrides: ``a.b=v`` (must exist), ``+a.b=v`` (add new), ``++a.b=v`` (force),
  ``~a.b`` (delete), ``+group@pkg.path=name`` (load group file at a package path).
- interpolation: ``${a.b}``, ``${oc.env:VAR}``, ``${oc.env:VAR,default}``.
- multirun: comma-separated choice overrides expand to a cartesian product.

YAML values parse with safe_load; scalars in overrides are YAML-parsed too, so
``lr=3e-6`` is a float and ``devices=-1`` an int.
"""

import copy
import itertools
import os
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import yaml

MISSING = "???"


class ConfigError(Exception):
    pass


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        data = yaml.safe_load(f)
    return data or {}


def _deep_merge(base: Dict[str, Any], overlay: Mapping[str, Any]) -> Dict[str, Any]:
    for key, value in overlay.items():
        if isinstance(value, Mapping) and isinstance(base.get(key), dict):
            _deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


def _set_path(cfg: Dict[str, Any], path: str, value: Any, create: bool) -> None:
    keys = path.split(".")
    node = cfg
    for key in keys[:-1]:
        if key not in node or node[key] is None:
            if not create:
                raise ConfigError(f"Path '{path}' not in config (use +{path}= to add)")
            node[key] = {}
        node = node[key]
        if not isinstance(node, dict):
            raise ConfigError(f"Cannot set '{path}': '{key}' is not a mapping")
    last = keys[-1]
    if not create and last not in node:
        raise ConfigError(f"Key '{path}' not in config (use +{path}= to add)")
    node[last] = value


def _del_path(cfg: Dict[str, Any], path: str) -> None:
    keys = path.split(".")
    node = cfg
    for key in keys[:-1]:
        node = node.get(key, {})
        if not isinstance(node, dict):
            return
    node.pop(keys[-1], None)


_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _parse_value(raw: str) -> Any:
    if raw == "":
        return ""
    try:
        value = yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw
    # YAML 1.1 misses bare scientific notation ("3e-6" stays a string).
    if isinstance(value, str) and _FLOAT_RE.match(value):
        return float(value)
    return value


class _Composer:
    def __init__(self, config_dir: str):
        self.config_dir = config_dir

    def group_file(self, group: str, name: str) -> str:
        return os.path.join(self.config_dir, group.replace(".", "/"), f"{name}.yaml")

    def load_group(self, group: str, name: str) -> Dict[str, Any]:
        path = self.group_file(group, name)
        if not os.path.exists(path):
            raise ConfigError(f"Config group file not found: {path}")
        node = _load_yaml(path)
        return self.process_defaults(node, base_group=group)

    def process_defaults(self, node: Dict[str, Any], base_group: str = "") -> Dict[str, Any]:
        """Resolve a node's `defaults` list into the node itself."""
        defaults = node.pop("defaults", None)
        if defaults is None:
            return node
        result: Dict[str, Any] = {}
        merged_self = False
        for entry in defaults:
            if entry == "_self_":
                _deep_merge(result, node)
                merged_self = True
                continue
            if isinstance(entry, str):
                # bare name: include sibling file from the same group dir
                sibling = self.load_group(base_group, entry) if base_group else \
                    self.process_defaults(_load_yaml(os.path.join(self.config_dir, f"{entry}.yaml")))
                _deep_merge(result, sibling)
                continue
            if not isinstance(entry, Mapping) or len(entry) != 1:
                raise ConfigError(f"Unsupported defaults entry: {entry!r}")
            key, name = next(iter(entry.items()))
            optional = False
            if isinstance(key, str) and key.startswith("optional "):
                optional = True
                key = key[len("optional "):]
            if isinstance(key, str) and (key.startswith("override ") or key.startswith("hydra/")):
                continue  # hydra-internal entries: not applicable
            if name is None:
                # placeholder slot filled from the CLI (e.g. `- data: null`)
                continue
            group, package = (key.split("@", 1) + [None])[:2] if "@" in key else (key, None)
            full_group = f"{base_group}/{group}" if base_group and not group.startswith("/") else group.lstrip("/")
            try:
                content = self.load_group(full_group, str(name))
            except ConfigError:
                if optional:
                    continue
                raise
            if package == "_global_":
                _deep_merge(result, content)
            else:
                if package is not None:
                    target_path = package
                else:
                    # Hydra default package: the group path with / -> .
                    target_path = group.replace("/", ".")
                    if target_path in (".", ""):
                        target_path = None
                if target_path:
                    wrapper: Dict[str, Any] = {}
                    _set_path(wrapper, target_path, content, create=True)
                    _deep_merge(result, wrapper)
                else:
                    _deep_merge(result, content)
        if not merged_self:
            _deep_merge(result, node)
        return result


def _split_override(argument: str) -> Tuple[str, str, Optional[str]]:
    """Returns (mode, path, value): mode in {set, add, force, delete}."""
    if argument.startswith("~"):
        return "delete", argument[1:], None
    if argument.startswith("++"):
        mode, rest = "force", argument[2:]
    elif argument.startswith("+"):
        mode, rest = "add", argument[1:]
    else:
        mode, rest = "set", argument
    if "=" not in rest:
        raise ConfigError(f"Override '{argument}' missing '='")
    path, value = rest.split("=", 1)
    return mode, path, value


def compose(config_dir: str, config_name: str,
            overrides: Sequence[str] = ()) -> Dict[str, Any]:
    composer = _Composer(config_dir)
    root_path = os.path.join(config_dir, f"{config_name}.yaml")
    if not os.path.exists(root_path):
        raise ConfigError(f"Config not found: {root_path}")
    cfg = composer.process_defaults(_load_yaml(root_path))

    group_overrides: List[Tuple[str, str, str, Optional[str]]] = []
    value_overrides: List[Tuple[str, str, Optional[str]]] = []
    for argument in overrides:
        mode, path, value = _split_override(argument)
        if mode == "delete":
            value_overrides.append((mode, path, value))
            continue
        group = path.split("@")[0]
        if mode in ("set", "add") and value is not None and \
                os.path.isdir(os.path.join(config_dir, group.replace(".", "/"))) and \
                os.path.exists(composer.group_file(group, str(_parse_value(value)))):
            package = path.split("@", 1)[1] if "@" in path else group
            group_overrides.append((mode, group, str(_parse_value(value)), package))
        else:
            value_overrides.append((mode, path, value))

    for mode, group, name, package in group_overrides:
        content = composer.load_group(group, name)
        target: Dict[str, Any] = {}
        _set_path(target, package, content, create=True)
        _deep_merge(cfg, target)

    for mode, path, value in value_overrides:
        if mode == "delete":
            _del_path(cfg, path)
        else:
            _set_path(cfg, path, _parse_value(value), create=mode in ("add", "force"))

    cfg = _resolve_interpolations(cfg)
    _check_missing(cfg)
    return cfg


_INTERP = re.compile(r"\$\{([^}]+)\}")


def _lookup(root: Dict[str, Any], dotted: str) -> Any:
    node: Any = root
    for key in dotted.split("."):
        if not isinstance(node, Mapping) or key not in node:
            raise ConfigError(f"Interpolation '${{{dotted}}}' not found")
        node = node[key]
    return node


def _resolve_value(value: Any, root: Dict[str, Any], depth: int = 0) -> Any:
    if depth > 10:
        raise ConfigError("Interpolation recursion limit exceeded")
    if isinstance(value, str):
        match = _INTERP.fullmatch(value.strip())
        if match:
            return _resolve_expr(match.group(1), root, depth)
        return _INTERP.sub(lambda m: str(_resolve_expr(m.group(1), root, depth)), value)
    if isinstance(value, dict):
        return {k: _resolve_value(v, root, depth) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_value(v, root, depth) for v in value]
    return value


def _resolve_expr(expr: str, root: Dict[str, Any], depth: int) -> Any:
    expr = expr.strip()
    if expr.startswith("oc.env:"):
        rest = expr[len("oc.env:"):]
        parts = rest.split(",", 1)
        var = parts[0].strip()
        if var in os.environ:
            return _parse_value(os.environ[var])
        if len(parts) == 2:
            return _parse_value(parts[1].strip())
        raise ConfigError(f"Environment variable '{var}' not set and no default given")
    return _resolve_value(_lookup(root, expr), root, depth + 1)


def _resolve_interpolations(cfg: Dict[str, Any]) -> Dict[str, Any]:
    return _resolve_value(cfg, cfg)


def _check_missing(cfg: Any, path: str = "") -> None:
    if isinstance(cfg, dict):
        for key, value in cfg.items():
            _check_missing(value, f"{path}.{key}" if path else str(key))
    elif isinstance(cfg, list):
        for i, value in enumerate(cfg):
            _check_missing(value, f"{path}[{i}]")
    elif cfg == MISSING:
        raise ConfigError(f"Mandatory value '{path}' (???) was not provided")


def expand_multirun(overrides: Sequence[str]) -> List[List[str]]:
    """Cartesian-product expansion of comma-separated choice overrides
    (hydra --multirun semantics). Bracketed lists are NOT expanded."""
    choices: List[List[str]] = []
    for argument in overrides:
        if "=" in argument and not argument.startswith("~"):
            head, value = argument.split("=", 1)
            if "," in value and not value.strip().startswith("["):
                choices.append([f"{head}={v}" for v in value.split(",")])
                continue
        choices.append([argument])
    return [list(combo) for combo in itertools.product(*choices)]
