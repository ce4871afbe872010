"""The harness's comparison sees a broken timed path: each cell's run, with
the chip check skipped and the configuration cut to a tiny size on the CPU,
driven with one of the faults its kind can have, comes out not correct; the
same run without a fault passes the exact checks.

Run a cell at its own size on the card with ``-m cuda`` (the control's test
does); these CPU runs take a few seconds each."""

import pytest

from port_bench import harness
from port_bench.tests import tiny

EVAL = ["clip_b16.msrvtt_zs_int8", "fit_base.msrvtt_zs_int8"]
TRAIN = [w["name"] for w in harness.benchmark()["workloads"]
         if harness.resolve(w["name"]).traffic["kind"] == "train"]


@pytest.mark.parametrize("name", EVAL)
def test_eval_without_fault_passes_the_exact_checks(name):
    _, reading = tiny.run(name)
    assert reading.checks["rows_missing"].ok and reading.checks["ranking_gap"].ok
    assert reading.units >= 1 and reading.failed == 0


@pytest.mark.parametrize("name", EVAL)
@pytest.mark.parametrize("fault", ["altered", "half"])
def test_eval_fault_is_not_correct(name, fault):
    cell, reading = tiny.run(name, fault=fault)
    line, correct = harness.result(cell, reading, False, {})
    assert not correct and not line["correct"]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["frozen", "half"])
def test_train_fault_is_not_correct(name, fault):
    cell, reading = tiny.run(name, fault=fault)
    _, correct = harness.result(cell, reading, False, {})
    assert not correct
    if fault == "frozen":   # no leaf moved: every change reads 1
        assert reading.checks["change_gap"].value == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_train_without_fault_is_correct(name):
    cell, reading = tiny.run(name)
    _, correct = harness.result(cell, reading, False, {})
    assert correct and reading.units >= cell.traffic["checked_steps"]


def test_restore_puts_the_built_state_back_into_the_same_tensors():
    from types import SimpleNamespace

    import torch

    from port_bench.kinds import train

    module = torch.nn.BatchNorm1d(3)
    scale = torch.nn.Parameter(torch.ones(1))
    state = SimpleNamespace(
        params={"encoder": module, "logit_scale": scale}, step=0,
        opt_state={"count": 0, "mu": {"logit_scale": torch.zeros(1)}},
        named_parameters=lambda: {**{f"encoder.{n}": p for n, p in module.named_parameters()},
                                  "logit_scale": scale})
    saved = train._saved(state)
    weight, mean = module.weight, module.running_mean
    with torch.no_grad():
        module.weight.add_(1.0)
        scale.mul_(3.0)
    module(torch.randn(8, 3) + 5.0)   # moves the running statistics
    state.opt_state, state.step = {"count": 1, "mu": {"logit_scale": torch.ones(1)}}, 1
    train._restore(state, saved)
    assert module.weight is weight and module.running_mean is mean
    assert torch.equal(module.weight, torch.ones(3)) and torch.equal(mean, torch.zeros(3))
    assert torch.equal(scale, torch.ones(1)) and state.step == 0
    assert state.opt_state["count"] == 0 and torch.equal(state.opt_state["mu"]["logit_scale"],
                                                         torch.zeros(1))
