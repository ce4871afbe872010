"""The harness: a cell's files found by name, one run of it, its result line.

``BENCHMARK.json`` names each cell's configuration and traffic. The harness
finds by those names, and adds nothing in code for one cell:
- ``configs/<config>.json``: the sizes, and the ``family`` whose module
  (``families/<family>.py``) makes the weights, builds the program's encoder,
  holds the reference and counts the work;
- ``traffic/<traffic>.json``: the mix, and the ``kind`` of loop that drives it
  (``kinds/<kind>.py``: eval passes or train steps);
- ``cells/<workload>.json``: what the configuration runs in (precision, the
  encoders' paths) and the limits of the comparison that decides ``correct``;
- ``metrics/<metric>.py``: one reader per metric, ``read(reading)``, which
  returns the number or None where it finds nothing to read.
"""

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fitclip_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    spec: dict          # cells/<name>.json
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def family(self):
        return importlib.import_module(f"port_bench.families.{self.config['family']}")

    @property
    def kind(self):
        return importlib.import_module(f"port_bench.kinds.{self.traffic['kind']}")


@dataclasses.dataclass
class Check:
    """One number compared with its limit: a run passes it when value <= limit."""
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Reading:
    """What one run measured; the metric readers take their numbers from it."""
    setup_s: float = 0.0
    units: int = 0                 # units of work (passes, steps) completed in the window
    items_per_unit: int = 0        # clips a unit completes
    window_s: float = 0.0          # from the window's start to the end of its last unit
    attempted: int = 0
    failed: int = 0
    unit_calls: list = dataclasses.field(default_factory=list)   # work.Call of one unit
    span_s: Dict[str, List[float]] = dataclasses.field(default_factory=dict)  # host s a unit
    trace: object = None           # tracing.Trace of the traced units
    traced_units: int = 0
    checks: Dict[str, Check] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    notes: dict = dataclasses.field(default_factory=dict)  # what a comparison found, by name


def load_json(path: Path) -> dict:
    with open(path) as file:
        return json.load(file)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, load_json(ROOT / config["file"]),
                load_json(PACKAGE / "traffic" / f"{entry['traffic']}.json"),
                load_json(PACKAGE / "cells" / f"{name}.json"), int(entry["chips"]),
                end_to_end, per_layer)


def reader(metric: str):
    """The module ``metrics/<metric>.py`` (metric names may hold dots)."""
    path = PACKAGE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metrics(metrics: List[dict], reading: Reading) -> Dict[str, dict]:
    out = {}
    for metric in metrics:
        value = reader(metric["name"]).read(reading)
        if value is not None:
            out[metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX
    package's, compared whole (``fitclip_torch`` is not ``fitclip_tpu``)."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def device_record(chips: int, reading: Reading, trace: bool) -> dict:
    import torch

    record = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(reading.memory_peak_bytes), "power": power_limit()}
    if trace:
        record["busy_s"] = reading.trace.busy_s()
        record["window_s"] = reading.trace.window_s
    return record


def result(cell: Cell, reading: Reading, trace: bool, device: dict) -> Tuple[dict, bool]:
    correct = bool(reading.checks) and all(c.ok for c in reading.checks.values())
    line = {"correct": correct, "attempted": int(reading.attempted),
            "failed": int(reading.failed),
            "metrics": read_metrics(cell.per_layer if trace else cell.end_to_end, reading),
            "device": device}
    if trace:
        line["breakdown"] = {"device_ops": reading.trace.device_ops(),
                             "idle_gaps": reading.trace.idle_gaps()}
    line["checks"] = {name: {"value": c.value, "limit": c.limit}
                      for name, c in reading.checks.items()}
    return line, correct


def run(name: str, seed: int, seconds: float, trace: bool, started: float,
        device: str = "cuda", cell: Optional[Cell] = None, fault=None) -> Tuple[Cell, Reading]:
    """One run of the cell: set-up, the window, the comparison. ``fault`` is
    the tests' hook that breaks the timed path (``kinds/<kind>.py`` says which
    faults it takes)."""
    cell = cell or resolve(name)
    return cell, cell.kind.run(cell, seed, seconds, trace, started, device, fault)
