"""BENCHMARK.json and the files it names: every configuration, traffic,
metric reader, roofline and method of the plain reference parses and
names what exists, within the limits the benchmark keeps on names, units
and lengths."""

import json
import re

import pytest

from benchmark import cells

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    data = json.loads((cells.ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and NAME.match(conf["name"])
    assert data["source"] == conf["source"] and len(conf["source"]) <= 200
    assert data["reduced"] == conf["reduced"]
    assert all(key in data for key in conf["reduced"])
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    loaded = cells.load_cell(cell["name"])
    assert loaded.traffic["frames"] <= loaded.config["n_frames"]
    assert set(loaded.traffic["limits"]) == {"order_gap", "yaml_excess",
                                             "frames_short"}
    assert {m["name"] for m in loaded.end_to_end} >= {"setup_s"}
    assert len(loaded.end_to_end) >= 2 and loaded.per_layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(cells.metric_reader(metric["name"]))
    known = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", known)) <= known
    if metric in BENCH["per_layer"]:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    else:
        assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("kernel", sorted(
    p.stem for p in (cells.HERE / "rooflines").glob("*.py")))
def test_roofline_module(kernel):
    rl = cells.roofline(kernel)
    for attr in ("KERNELS", "start", "add", "finish", "bound_s"):
        assert hasattr(rl, attr)


@pytest.mark.parametrize("axis, name", [
    (axis, p.stem) for axis in ("kinds", "normals", "leaflets")
    for p in sorted((cells.REFERENCE / axis).glob("*.py"))],
    ids=lambda v: v)
def test_reference_method(axis, name):
    """Each method on disk is found by the tag it stands for and exposes
    its `build(spec, view)`."""
    tag = "".join(word.capitalize() for word in name.split("_"))
    assert cells.snake_case(tag) == name
    assert callable(cells.reference_part(axis, {"!": tag}).build)
