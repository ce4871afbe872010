"""fitclip_torch stands without JAX: every module imports with jax and flax
blocked and loads nothing of fitclip_tpu or demo/, and chip_smoke.py refuses to run (non-zero exit, no result line)
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
assert not any(m.split(".")[0] == "demo" for m in sys.modules)
print(" ".join(names))
"""


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_every_module_imports_without_jax():
    proc = _run(["-c", _BLOCKED_IMPORT], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    # Every module of the package was imported, the training path's and the
    # benches' included.
    assert len(names) >= 39
    bench = {f"fitclip_torch.bench.{m}" for m in ("__main__", "kernels", "encode", "block_layer",
                                                   "attn_int8", "fit_block")}
    assert bench <= set(names) and "fitclip_torch.utils.benchmarking" in names
    assert {f"fitclip_torch.serving.{m}" for m in ("batcher", "graphs", "embed_service")} <= \
        set(names)
    # The train-side CLI slice: the train command's data combinators, tune and sweep.
    assert {"fitclip_torch.cli.tune", "fitclip_torch.cli.sweep",
            "fitclip_torch.data.multi_source_sampler", "fitclip_torch.data.structured_batch",
            "fitclip_torch.data.data_module_group", "fitclip_torch.training.train_runner",
            "fitclip_torch.utils.logging"} <= set(names)
    # The CLIP ResNet and WiSE-FT slice, and the OpenAI-schema exporter.
    assert {"fitclip_torch.models.clip.resnet", "fitclip_torch.models.clip.resnet_clip",
            "fitclip_torch.models.wise", "fitclip_torch.convert.openai_state_dict",
            "fitclip_torch.convert.checkpoint_to_state_dict"} <= set(names)
    # The export slice and the last single-device utilities.
    assert {"fitclip_torch.serving.export", "fitclip_torch.serving.export_serving",
            "fitclip_torch.utils.profiling", "fitclip_torch.utils.viz"} <= set(names)
    # The distribution slice.
    assert {f"fitclip_torch.parallel.{m}" for m in ("multihost", "mesh", "collectives",
                                                    "sharding_rules")} <= set(names)
    # The last slice: the per-epoch loop and its checkpoint entry points,
    # subcorr, tensor parallelism and the pipeline.
    assert {"fitclip_torch.cli.evaluate_per_epoch",
            "fitclip_torch.convert.prepare_trained_clip_checkpoint_for_evaluation",
            "fitclip_torch.convert.prepare_trained_checkpoint_for_evaluation",
            "fitclip_torch.convert.apply_wise_ft", "fitclip_torch.utils.subcorr",
            "fitclip_torch.parallel.tensor_parallel", "fitclip_torch.parallel.pipeline"} <= \
        set(names)


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
