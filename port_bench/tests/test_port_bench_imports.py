"""The import guard: nothing under port_bench imports JAX, its libraries or
the JAX package (top-level names compared whole: the port's name begins with
the JAX package's), the reference imports nothing of the program, and the
harness's run-time check flags exactly those top-level names."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness

FILES = sorted(harness.PACKAGE.rglob("*.py"))


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax_import(path):
    assert not set(imported_tops(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.PACKAGE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(imported_tops(path)) <= {"contextlib", "math", "typing", "torch", "port_bench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("port_bench"):
            assert node.module.startswith("port_bench.reference")


def test_reference_loads_without_the_program():
    code = ("import sys, port_bench.reference.clip, port_bench.reference.fit, "
            "port_bench.reference.train; "
            "print(sorted(n for n in sys.modules if n.split('.')[0] in "
            "('fitclip_torch', 'fitclip_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_time_guard_compares_whole_top_level_names(monkeypatch):
    fake = {"jax.numpy": 1, "flax": 1, "fitclip_tpu.models": 1, "fitclip_torch.ops": 1,
            "fitclip_tpux": 1, "jaxtyping": 1}
    for name, value in fake.items():
        monkeypatch.setitem(sys.modules, name, value)
    found = harness.forbidden_modules()
    assert {"jax.numpy", "flax", "fitclip_tpu.models"} <= set(found)
    assert not {"fitclip_torch.ops", "fitclip_tpux", "jaxtyping"} & set(found)
