"""The port never imports jax: a fresh interpreter imports each of its
modules and `jax` (and `gorder_tpu`, whose `__init__` imports jax) stays
out of `sys.modules`. Importing builds nothing and starts nothing."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("module", [
    "gorder_tpu_torch",
    "gorder_tpu_torch.__main__",
    "gorder_tpu_torch.engine.drivers",
    "gorder_tpu_torch.engine.batches",
    "gorder_tpu_torch.engine.channels",
    "gorder_tpu_torch.engine.convert",
    "gorder_tpu_torch.engine.fused",
    "gorder_tpu_torch.engine.wire",
    "gorder_tpu_torch.core.order",
    "gorder_tpu_torch.core.pbc",
    "gorder_tpu_torch.core.ua",
    "gorder_tpu_torch.ops.p2",
    "gorder_tpu_torch.ops.ua",
    "gorder_tpu_torch.ops.build",
    "chip_smoke",
])
def test_import_leaves_jax_out(module):
    code = (
        "import sys, threading\n"
        f"import {module}\n"
        "import gorder_tpu_torch.ops.build as b\n"
        "bad = [m for m in ('jax', 'gorder_tpu', 'triton') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert b._LIB is None, 'a kernel library was loaded at import'\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
