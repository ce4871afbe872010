"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix, cell file and metric reader loads by its name; names, units and keys
keep to the contract; each per-layer metric moves an end-to-end metric that
each of its cells reports."""

import json
import re

import pytest

from port_bench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    assert not any(word.startswith("/") or ".." in word for word in BENCH["command"])


def test_entry_keys():
    for config in BENCH["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    for metric in BENCH["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in BENCH["per_layer"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                               "moves"}


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in BENCH["configs"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_directions(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_names_are_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [entry["name"] for entry in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.resolve(name)
    assert cell.family and cell.kind
    assert cell.spec["limits"]
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer


def test_every_config_is_used_and_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for config in BENCH["configs"]:
        assert config["name"] in used
        assert config["file"].startswith("port_bench/")
        with open(harness.ROOT / config["file"]) as file:
            data = json.load(file)
        assert data["name"] == config["name"] and data["reduced"] == config["reduced"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric["name"]).read)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_names_an_end_to_end_metric_each_cell_reports(metric):
    assert metric["workloads"], "list the cells whose code the reader reads"
    for name in metric["workloads"]:
        assert name in CELLS
        reported = {m["name"] for m in harness.resolve(name).end_to_end}
        assert metric["moves"] in reported


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"eval loop", "train loop", "encoders", "ops", "kernels", "device"}


def test_at_most_a_quarter_of_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_traffic_and_cell_files_hold_only_keys_their_kind_reads(name):
    import inspect

    cell = harness.resolve(name)
    kind = cell.kind
    assert set(cell.traffic) <= kind.TRAFFIC_KEYS, set(cell.traffic) - kind.TRAFFIC_KEYS
    assert set(cell.spec) <= kind.CELL_KEYS, set(cell.spec) - kind.CELL_KEYS
    source = inspect.getsource(kind)
    for key in (kind.TRAFFIC_KEYS | kind.CELL_KEYS) - {"kind", "about"}:
        assert source.count(f'"{key}"') >= 2, f"{key} is declared but read nowhere"
