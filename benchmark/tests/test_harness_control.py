"""The control, the reference computed in bfloat16 and put in the
program's place, fails the cells' limits: the comparison can tell a
lower precision from the program's."""

import pytest
import torch
from conftest import tiny_cell

from benchmark import harness
from benchmark.calibrate import control_numbers


@pytest.mark.parametrize("name", ["aa-static", "ves-dynamic"])
def test_control_fails_the_limits(name, cache):
    cell = tiny_cell(name)
    run = harness.execute(cell, 23, 0.0, False, device="cpu",
                          cache_dir=cache, log=lambda msg: None)
    control = control_numbers(run, 23, torch.device("cpu"))
    limits = cell.traffic["limits"]
    assert control["order_gap"] > limits["order_gap"]
    assert control["yaml_excess"] > limits["yaml_excess"]
    assert all(run.numbers[k] <= limits[k] for k in limits)
