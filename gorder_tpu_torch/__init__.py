"""gorder_tpu_torch: lipid order parameters with PyTorch on an NVIDIA GPU.

The port of `gorder_tpu` (JAX on a TPU) to PyTorch and a hand-written
Hopper kernels. It reads the same YAML configurations and writes the same
output files; `gorder_tpu` stays the reference it is tested against. It
covers all-atom (AA), coarse-grained (CG) and united-atom (UA) order
parameters with a static, dynamic or manual membrane normal, overall and
per leaflet (global, local, individual, spectral or spherical clustering
and manual assignment), with or without ordermaps and geometry
selection, in one run or in frame shards merged afterwards::

    import gorder_tpu_torch as gorder

    analysis = gorder.Analysis.from_file("analyze.yaml")
    results = gorder.run(analysis)            # on the GPU
    results.write()

`analysis.run()` does the same. `analysis.run_partial(i, n)` runs the
i-th of n contiguous frame shards (one process per GPU) and
`analysis.merge(states)` joins their states into the same results. The
host code (trajectory readers and their C++ codec, selections, topology,
configuration, results and presenters) is this package's own copy of
`gorder_tpu`'s; this package imports neither jax nor `gorder_tpu`.
"""

from .errors import (  # noqa: F401
    AnalysisError,
    ConfigError,
    GorderError,
)
from .input.config import (  # noqa: F401
    Analysis,
    AnalysisType,
    EstimateError,
    MembraneNormal,
)


def run(analysis, device="cuda", on_batch=None):
    """Run `analysis` (this package's `Analysis` or `gorder_tpu`'s: it is
    read by attribute) on `device` and return its AnalysisResults.

    The default device is the GPU; without one this raises rather than
    carrying on on the CPU. Pass `device="cpu"` to run the plain PyTorch
    versions of the kernels. `on_batch`, if given, receives each batch's
    device inputs (`engine.batches.DeviceBatch`) once its step has been
    dispatched."""
    from .engine.drivers import run_analysis

    return run_analysis(analysis, device, on_batch=on_batch)
