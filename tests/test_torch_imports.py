"""The port never imports jax: a fresh interpreter imports each of its
modules and `jax` (and `gorder_tpu`, whose `__init__` imports jax) stays
out of `sys.modules`, and no loaded module's file lies under `gorder_tpu/`
(the port keeps its own copy of the host code). Importing builds nothing
and starts nothing."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("module", [
    "gorder_tpu_torch",
    "gorder_tpu_torch.compat",
    "gorder_tpu_torch.compat.analysis",
    "gorder_tpu_torch.results.pyapi",
    "gorder_tpu_torch.analysis_types",
    "gorder_tpu_torch.__main__",
    "gorder_tpu_torch.cli",
    "gorder_tpu_torch.input.export",
    "gorder_tpu_torch.core.geometry",
    "gorder_tpu_torch.engine.drivers",
    "gorder_tpu_torch.parallel",
    "gorder_tpu_torch.parallel.shard",
    "gorder_tpu_torch.parallel.mesh",
    "gorder_tpu_torch.parallel.context",
    "gorder_tpu_torch.engine.batches",
    "gorder_tpu_torch.engine.channels",
    "gorder_tpu_torch.engine.convert",
    "gorder_tpu_torch.engine.fused",
    "gorder_tpu_torch.engine.wire",
    "gorder_tpu_torch.engine.leaflet_runtime",
    "gorder_tpu_torch.engine.normals_runtime",
    "gorder_tpu_torch.engine.prepare",
    "gorder_tpu_torch.engine.ring",
    "gorder_tpu_torch.core.order",
    "gorder_tpu_torch.core.pbc",
    "gorder_tpu_torch.core.ua",
    "gorder_tpu_torch.core.leaflets",
    "gorder_tpu_torch.core.clustering",
    "gorder_tpu_torch.core.normals",
    "gorder_tpu_torch.core.ordermap",
    "gorder_tpu_torch.core.timewise",
    "gorder_tpu_torch.ops.p2",
    "gorder_tpu_torch.ops.ua",
    "gorder_tpu_torch.ops.neighbors",
    "gorder_tpu_torch.ops.spectral",
    "gorder_tpu_torch.ops.build",
    "gorder_tpu_torch.io.traj",
    "gorder_tpu_torch.io.native",
    "gorder_tpu_torch.io.tpr",
    "gorder_tpu_torch.io.pdb",
    "gorder_tpu_torch.io.pqr",
    "gorder_tpu_torch.io.ndx",
    "gorder_tpu_torch.io.bnd",
    "gorder_tpu_torch.input.config",
    "gorder_tpu_torch.select",
    "gorder_tpu_torch.topology.ua",
    "gorder_tpu_torch.results.model",
    "gorder_tpu_torch.present",
    "gorder_tpu_torch.present.yaml_out",
    "gorder_tpu_torch.present.leaflets_out",
    "gorder_tpu_torch.present.convergence_out",
    "gorder_tpu_torch.present.csv_out",
    "gorder_tpu_torch.present.tab_out",
    "gorder_tpu_torch.present.xvg_out",
    "gorder_tpu_torch.present.ordermaps_out",
    "gorder_tpu_torch.present.normals_out",
    "gorder_tpu_torch.utils.logcolor",
    "gorder_tpu_torch.utils.timers",
    "gorder_tpu_torch.version",
    "gorder_tpu_torch.diagnostics.layout",
    "gorder_tpu_torch.diagnostics.clustering",
    "gorder_tpu_torch.diagnostics.neighbors",
    "gorder_tpu_torch.diagnostics.spans",
    "chip_smoke",
])
def test_import_leaves_jax_out(module):
    code = (
        "import os, sys, threading\n"
        f"import {module}\n"
        "import gorder_tpu_torch.ops.build as b\n"
        "bad = [m for m in ('jax', 'gorder_tpu', 'triton') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n"
        f"jax_pkg = os.path.join({ROOT!r}, 'gorder_tpu') + os.sep\n"
        "shared = [m for m, mod in list(sys.modules.items())\n"
        "          if (getattr(mod, '__file__', None) or '')"
        ".startswith(jax_pkg)]\n"
        "assert not shared, shared\n"
        "assert b._LIB is None, 'a kernel library was loaded at import'\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
