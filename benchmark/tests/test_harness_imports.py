"""The import boundary, in fresh interpreters: a whole run of the
harness (generators, readers, rooflines, tracing) loads nothing of JAX,
`gorder_tpu`, `bench`, `chip_smoke` or `tools`; the reference and the
lipid templates load nothing of `gorder_tpu_torch` either. Top-level
names are compared whole: `gorder_tpu_torch` is not `gorder_tpu`."""

import json
import subprocess
import sys

from conftest import ROOT

HARNESS_FORBIDDEN = ["jax", "jaxlib", "flax", "gorder_tpu", "bench",
                     "chip_smoke", "tools"]

RUN = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from pathlib import Path
from conftest import tiny_cell
from benchmark import harness
run = harness.execute(tiny_cell("ves-dynamic"), 3, 0.0, True, device="cpu",
                      cache_dir=Path({cache!r}), log=lambda m: None)
harness.result(run, True)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark.reference.order import OrderReference
from benchmark.reference import normals, select, spherical
names = ["C1", "H1"] * 2
ref = OrderReference(names, ["LIP"] * 4, [0, 0, 1, 1], [[0, 1], [2, 3]],
                     [5.0] * 3, 1000.0,
                     {{"type": {{"!": "AAOrder", "heavy_atoms": "name C1",
                                "hydrogens": "name H1"}}}}, "cpu")
ref.add(torch.tensor([[[0, 0, 0], [0, 0, 100], [500, 0, 0],
                       [500, 100, 0]]], dtype=torch.int32))
ref.values()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

METHODS = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import cells
for path in sorted(cells.REFERENCE.glob("*/*.py")):
    tag = "".join(w.capitalize() for w in path.stem.split("_"))
    cells.reference_part(path.parent.name, {{"!": tag}})
for path in sorted(cells.TEMPLATES.glob("*.py")):
    cells.template_part(path.stem.replace("_", "-")).template()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd="/")
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_run_loads_no_forbidden_module(tmp_path):
    loaded = _loaded(RUN.format(root=str(ROOT),
                                tests=str(ROOT / "benchmark" / "tests"),
                                cache=str(tmp_path)))
    assert "gorder_tpu_torch" in loaded
    assert not loaded & set(HARNESS_FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(REFERENCE.format(root=str(ROOT)))
    assert not loaded & set(HARNESS_FORBIDDEN + ["gorder_tpu_torch"])


def test_reference_methods_load_nothing_of_the_program():
    loaded = _loaded(METHODS.format(root=str(ROOT)))
    assert "torch" in loaded
    assert not loaded & set(HARNESS_FORBIDDEN + ["gorder_tpu_torch"])
