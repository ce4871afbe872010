"""fitclip_torch stands without JAX: every module imports with jax and flax
blocked, and chip_smoke.py refuses to run (non-zero exit, no result line)
without a CUDA device or without the package beside it."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import fitclip_torch
names = [m.name for m in pkgutil.walk_packages(fitclip_torch.__path__, "fitclip_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "triton"))
assert not leaked, leaked
assert not any(m.startswith("fitclip_tpu") for m in sys.modules)
print(len(names))
"""


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_every_module_imports_without_jax():
    proc = _run(["-c", _BLOCKED_IMPORT], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    # Every module of the package was imported, the training path's included.
    assert int(proc.stdout.strip()) >= 39


def _last_line_is_ok(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    try:
        return bool(lines) and json.loads(lines[-1]).get("ok") is True
    except json.JSONDecodeError:
        return False


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_the_card_or_the_package(tmp_path, alone):
    import torch

    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real there")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _run(["chip_smoke.py"], cwd=cwd)
    assert proc.returncode != 0
    assert not _last_line_is_ok(proc.stdout)
