"""On a card: the cells at tiny sizes through the harness on CUDA, every
kernel the port launches, judged correct, with a traced window that saw
the device busy. Skips without a card (decided inside the test)."""

import pytest
from conftest import tiny_cell

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["aa-static", "ves-dynamic"])
def test_tiny_cell_on_the_card(name, cache):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    run = harness.execute(tiny_cell(name), 29, 0.0, True, device="cuda",
                          cache_dir=cache, log=lambda msg: None)
    line = harness.result(run, True)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert "device_idle_pct" in line["metrics"]
