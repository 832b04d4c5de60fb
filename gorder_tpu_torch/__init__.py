"""gorder_tpu_torch: lipid order parameters with PyTorch on an NVIDIA GPU.

The port of `gorder_tpu` (JAX on a TPU) to PyTorch and hand-written
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
`analysis.merge(states)` joins their states into the same results.

Code written against pygorder, the reference's Python package, runs
unchanged through the drop-in namespace, on the GPU by default::

    import gorder_tpu_torch.compat as gorder   # was: import gorder

    results = gorder.Analysis(
        structure="system.tpr", trajectory="md.xtc",
        analysis_type=gorder.analysis_types.CGOrder("@membrane"),
    ).run()
    print(results.average_order().total().value())

The pygorder namespaces (`analysis_types`, `leaflets`, `geometry`, ...)
are also attributes of this package, as in `gorder_tpu`. The host code
(trajectory readers and their C++ codec, selections, topology,
configuration, results and presenters) is this package's own copy of
`gorder_tpu`'s; this package imports neither jax nor `gorder_tpu`.
"""

from .version import __version__  # noqa: F401
from .errors import (  # noqa: F401
    AnalysisError,
    ConfigError,
    GorderError,
    SelectionError,
    TopologyError,
    WriteError,
)
from .input.config import (  # noqa: F401
    Analysis,
    AnalysisType,
    Collect,
    EstimateError,
    Frequency,
    Geometry,
    GridSpan,
    LeafletClassification,
    MembraneNormal,
    OrderMapParams,
)
from .results.model import (  # noqa: F401
    AnalysisResults,
    AtomResults,
    BondResults,
    MoleculeResults,
    Order,
    OrderCollection,
)

# pygorder-compatible namespaces (gorder.analysis_types.AAOrder, ...)
from .compat import (  # noqa: F401,E402
    analysis_types,
    estimate_error as estimate_error_module,
    exceptions,
    geometry,
    leaflets,
    membrane_normal,
    ordermap,
)

# pygorder spells it `gorder.estimate_error.EstimateError`; the top-level
# EstimateError class import above stays for this package's own API
estimate_error = estimate_error_module

import sys as _sys  # noqa: E402

for _name in ("analysis_types", "estimate_error", "leaflets", "geometry",
              "membrane_normal", "ordermap", "exceptions"):
    _sys.modules[f"{__name__}.{_name}"] = globals()[_name]
del _name


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
