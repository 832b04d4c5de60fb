"""The result line of a run at a tiny size on the CPU: its keys in order,
the metrics of the cell by name and unit, the checks last."""

import json

import pytest
from conftest import tiny_cell

from benchmark import checks, harness


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace, cache):
    cell = tiny_cell("aa-static")
    run = harness.execute(cell, 41, 0.0, trace, device="cpu",
                          cache_dir=cache, log=lambda msg: None)
    line = json.loads(json.dumps(harness.result(run, trace)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 1
    assert set(line["checks"]) == set(checks.NAMES)
    for item in line["checks"].values():
        assert set(item) == {"value", "limit"}
    entries = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in entries}
    assert set(line["metrics"]) <= set(units)
    for name, metric in line["metrics"].items():
        assert metric["unit"] == units[name]
        assert isinstance(metric["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
        assert "first_batch_ms" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}


def test_gorder_configuration_text():
    cell = tiny_cell("ves-dynamic", n_frames=30)
    cell.traffic["frames"] = 20
    text = harness.gorder_yaml(cell, {"structure": "s.gro",
                                      "bonds": "b.bnd",
                                      "trajectory": "t.xtc"})
    assert 'type: !CGOrder {beads: "resname POPC"}' in text
    assert ('membrane_normal: !Dynamic {heads: "name PO4", radius: 2.0}'
            in text)
    assert "end: 190.0" in text and "n_threads: 8" in text
