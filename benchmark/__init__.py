"""The benchmark of gorder_tpu_torch on NVIDIA GPUs.

One command runs one cell (a configuration under a traffic mix) once,
from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It makes the cell's system and trajectory from the seed, warms up with
one whole analysis, then runs whole analyses back to back for the given
seconds through `gorder_tpu_torch.run(analysis, device="cuda")` and
`results.write()`, checks every one against the plain reference
(`benchmark/reference/`), and prints one JSON line last. `BENCHMARK.json`
at the root names the cells and metrics; each is found by name:

- `benchmark/configs/<config>.json`: a system (`synth.py` makes it);
- `benchmark/templates/<template>.py`: the lipid a configuration lays
  out, its `template` with "-" as "_" (`popc-aa` → `popc_aa.py`);
- `benchmark/workloads/<traffic>.json`: the analysis a cell runs, its
  frames, decoder threads and the limits of its comparison;
- `benchmark/metrics/<metric>.py`: the reader of one metric;
- `benchmark/rooflines/<kernel>.py`: one kernel's operations and bytes;
- `benchmark/reference/<axis>/<method>.py`: one method of the plain
  reference, found from the traffic's `gorder` keys: the order kind
  (`type` → `kinds/`), a tagged membrane normal (`membrane_normal` →
  `normals/`) and the leaflets (`leaflets` → `leaflets/`), each tag in
  snake case (`!SphericalClustering` → `leaflets/spherical_clustering.py`).
  A cell whose analysis names a method with no file there fails its
  reference with NotImplementedError naming the file.

`calibrate.py` reads the compared numbers of the program and of the
control over many seeds; `tests/` holds the harness's CPU tests
(`python -m pytest benchmark/tests -q`).
"""

import os


def use_checkout_caches() -> None:
    """Every kernel and build cache of the program at a fixed path inside
    the checkout (`benchmark/_cache/`), so that only a checkout's first run
    builds; set before torch or the program is imported."""
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
