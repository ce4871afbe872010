"""The control fails the comparison: the reference at the precisions one step
below what the cell states (``control_bits``: int4 for int8, int8 for bf16)
put in the program's place reads above one of the cell's limits. At a tiny
size on the CPU, and at the cell's own size on the card over three seeds:

    python -m pytest -p no:cacheprovider port_bench/tests -m cuda
"""

import pytest
import torch

from port_bench import harness
from port_bench.tests import tiny

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
SEEDS = (2 ** 31 + 11, 2 ** 32 + 12, 2 ** 33 + 13)


def fails_a_limit(cell, readings) -> bool:
    limits = cell.spec["limits"]
    return any(value > limits[name] for name, value in readings.items())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_tiny_size(name):
    cell = tiny.cell(name)
    assert fails_a_limit(cell, cell.kind.control(cell, SEEDS[0], "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_at_the_cells_size(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    cell = harness.resolve(name)
    assert fails_a_limit(cell, cell.kind.control(cell, seed, "cuda"))
