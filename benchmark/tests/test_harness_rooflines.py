"""The kernels' least times against hand-reckoned bytes and operations,
and the traced window's union of device intervals."""

import pytest
import torch
from conftest import tiny_cell

from benchmark import cells, harness, peaks, synth
from benchmark.tracing import summarize

H100 = peaks.peaks_of("NVIDIA H100 80GB HBM3")


def test_p2_bound_by_hand():
    rl = cells.roofline("p2")
    state = {"frames": 512, "n_bonds": 1000, "n_atoms": 500, "escapes": 10,
             "n_types": 4, "n_classes": 1, "n_molecules": 50,
             "normals": False, "max_abs": 13000}
    b7 = 512 * ((3000 + 7) // 8 * 7) + 40 + 12000
    s6 = 512 * ((1500 + 3) // 4 * 3 + 51 * 6)
    moved = (min(b7, 512 * 12 * 500, s6, 512 * 3 * 500, 512 * 6 * 500)
             + 512 * 16 + 512 * 4 * 16)
    assert rl.bound_s(state, H100) == pytest.approx(max(
        moved / 3.35e12, 512 * 1000 * 33 / 67e12))
    state.update(normals=True, n_classes=3, max_abs=36000)
    moved = (min(b7, 512 * 12 * 500, s6, 512 * 3 * 500)
             + 512 * 16 + 512 * 50 * 16 + 512 * 4 * 16 * 3)
    assert rl.bound_s(state, H100) == pytest.approx(max(
        moved / 3.35e12, 512 * 1000 * 40 / 67e12))


def test_normal_cloud_bound_by_hand():
    rl = cells.roofline("normal_cloud")
    state = {"frames": 512, "heads": 6650, "pairs": 512 * 6650 * 20}
    assert rl.bound_s(state, H100) == pytest.approx(max(
        512 * (6650 * 40 + 12) / 3.35e12, 512 * 6650 * 20 * 40 / 67e12))


def test_rooflines_observe_the_reference_pass():
    cell = tiny_cell("ves-dynamic")
    system = synth.make_system(cell.config, 5, "cpu")
    run = harness.RunRecord(cell=cell, seed=5)
    harness.reference_values(run, system, 5, 24, torch.device("cpu"), True)
    assert run.work["p2"]["frames"] == 24
    assert run.work["p2"]["n_bonds"] == 100 * 11
    assert run.work["normal_cloud"]["pairs"] >= 24 * 100
    assert all(cells.roofline(k).bound_s(s, H100) > 0
               for k, s in run.work.items())


def test_device_union_and_gaps():
    spans = {"bench.analysis": [(0, 100)], "bench.run": [(10, 90)],
             "bench.first_batch": [(40, 40)], "bench.write": [(90, 100)]}
    device = [(20, 50, "k1"), (30, 60, "k2"), (95, 120, "k1"), (-5, 5, "c")]
    trace = summarize(spans, device)
    assert trace.window_s == pytest.approx(100e-9)
    assert trace.busy_s == pytest.approx((5 + 40 + 5) * 1e-9)
    assert trace.kernel_seconds("k1") == pytest.approx((30 + 5) * 1e-9)
    labels = dict((round(s * 1e9), label) for label, s in trace.gaps)
    assert labels[15].startswith("run: set-up")     # 5 .. 20
    assert labels[35].startswith("run: batch loop")  # 60 .. 95
