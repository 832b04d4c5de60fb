"""The benchmark harness's tests: CPU tests at tiny sizes, and tests
marked `cuda` that need a card (they decide inside the test and skip
without one). Run them with `python -m pytest benchmark/tests -q`; on a
machine with a card, `python -m pytest benchmark/tests -m cuda`."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cells  # noqa: E402

#: the cells cut to sizes a CPU test holds: boxes whose lengths f32
#: holds exactly, as the cells' do
TINY = {
    "aa-static": dict(n_lipids=8, total_atoms=1500, box_nm=[4.0, 4.0, 8.0],
                      n_frames=48),
}

#: a vesicle cell that no configuration of BENCHMARK.json has yet, so that
#: the layers a vesicle's traffic takes (the vesicle layout, the
#: reference's spherical leaflets and dynamic normals, the normal_cloud
#: roofline) are driven at a tiny size: a Martini-like POPC vesicle of two
#: shells in W water, under spherical-clustering leaflets and dynamic
#: normals on PO4
VESICLE_CONFIG = {
    "name": "cg-vesicle-tiny", "source": "tests", "system": "vesicle",
    "template": "popc-cg-martini", "resname": "POPC",
    "n_outer": 60, "r_outer_nm": 3.0, "n_inner": 40, "r_inner_nm": 2.0,
    "step_nm": 0.3, "box_nm": [9.0, 9.0, 9.0],
    "water_free_shell_nm": [1.75, 3.25], "water_resname": "W",
    "water_names": ["W"], "water_spacing_nm": 0.0, "total_atoms": 3000,
    "n_frames": 24, "precision": 1000.0, "dt_ps": 10.0,
    "steps_per_frame": 100, "drift_sigma_nm": 0.015, "drift_decay": 0.995,
    "jitter_sigma_nm": 0.012, "reduced": []}
VESICLE_TRAFFIC = {
    "frames": 24, "n_threads": 8,
    "gorder": {"type": {"!": "CGOrder", "beads": "resname POPC"},
               "membrane_normal": {"!": "Dynamic", "heads": "name PO4",
                                   "radius": 2.0},
               "leaflets": {"!": "SphericalClustering",
                            "heads": "name PO4"}},
    "limits": {"order_gap": 5e-05, "yaml_excess": 5e-05, "frames_short": 0}}
NORMAL_CLOUD_ROOFLINE = {
    "name": "normal_cloud_roofline", "unit": "%", "better": "higher",
    "source": "device_trace", "layer": "kernels", "moves": "frames_per_s"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def tiny_cell(name: str, **more) -> cells.Cell:
    """The cell `name` with its configuration cut to TINY's sizes, or the
    tiny vesicle cell ("ves-dynamic") with aa-static's metrics and the
    normal_cloud roofline."""
    if name == "ves-dynamic":
        base = cells.load_cell("aa-static")
        cell = cells.Cell(name=name, chips=1, config=VESICLE_CONFIG,
                          config_bytes=b"", traffic=VESICLE_TRAFFIC,
                          end_to_end=base.end_to_end,
                          per_layer=base.per_layer + [NORMAL_CLOUD_ROOFLINE])
        cfg = {**VESICLE_CONFIG, **more}
    else:
        cell = cells.load_cell(name)
        cfg = {**cell.config, **TINY[name], **more}
    cell.config = cfg
    cell.config_bytes = json.dumps(cfg).encode()
    cell.traffic = dict(cell.traffic, frames=cfg["n_frames"])
    return cell


@pytest.fixture
def cache(tmp_path):
    return tmp_path / "cache"
