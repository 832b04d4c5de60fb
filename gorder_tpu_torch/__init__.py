"""gorder_tpu_torch: lipid order parameters with PyTorch on an NVIDIA GPU.

The port of `gorder_tpu` (JAX on a TPU) to PyTorch and a hand-written
Hopper kernels. It reads the same YAML configurations and writes the same
output files; `gorder_tpu` stays the reference it is tested against. It
covers all-atom (AA), coarse-grained (CG) and united-atom (UA) order
parameters with a static membrane normal, without leaflets, ordermaps or
geometry::

    import gorder_tpu_torch as gorder

    analysis = gorder.Analysis.from_file("analyze.yaml")
    results = gorder.run(analysis)            # on the GPU
    results.write()

The host code that never touched jax (trajectory readers, selections,
topology, configuration, results and presenters) is shared with
`gorder_tpu` through `gorder_tpu_torch._ref`; this package never imports
jax.
"""

from ._ref.errors import (  # noqa: F401
    AnalysisError,
    ConfigError,
    GorderError,
)
from ._ref.input.config import (  # noqa: F401
    Analysis,
    AnalysisType,
    EstimateError,
    MembraneNormal,
)


def run(analysis, device="cuda"):
    """Run `analysis` (this package's `Analysis` or `gorder_tpu`'s: it is
    read by attribute) on `device` and return its AnalysisResults.

    The default device is the GPU; without one this raises rather than
    carrying on on the CPU. Pass `device="cpu"` to run the plain PyTorch
    versions of the kernels."""
    from .engine.drivers import run_analysis

    return run_analysis(analysis, device)
