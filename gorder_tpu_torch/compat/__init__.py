"""pygorder drop-in namespace.

The reference's Python package (pygorder/src/lib.rs:172-239) exposes
per-variant constructor classes grouped into submodules
(``gorder.analysis_types.AAOrder``, ``gorder.leaflets.Global
Classification``, …) and method-style results objects
(``results.average_order().total().value()``). This package mirrors that
surface 1:1 — constructors over this package's config types plus the
results views of results/pyapi.py — so code written against pygorder runs
unchanged after swapping the import line::

    import gorder_tpu_torch.compat as gorder   # was: import gorder

    analysis = gorder.Analysis(
        structure="system.tpr",
        trajectory="md.xtc",
        analysis_type=gorder.analysis_types.AAOrder(
            heavy_atoms="@membrane and element name carbon",
            hydrogens="@membrane and element name hydrogen"),
        leaflets=gorder.leaflets.GlobalClassification(
            "@membrane", "name P"),
        ordermap=gorder.ordermap.OrderMap(output_directory="maps"),
    )
    results = analysis.run()             # on the GPU
    print(results.average_order().total().value())

Signatures follow the published pygorder type stubs
(pygorder/python/gorder/*.pyi). This package's own API
(``gorder_tpu_torch.Analysis`` with attribute-style results) also accepts
these constructor objects. ``run`` and ``run_partial`` take a ``device``
keyword, the GPU (``"cuda"``) by default.
"""

from . import (  # noqa: F401
    analysis_types,
    estimate_error,
    exceptions,
    geometry,
    leaflets,
    membrane_normal,
    ordermap,
)
from ..input.config import Frequency  # noqa: F401
from ..results import pyapi as results  # noqa: F401
from ..results.pyapi import AtomType  # noqa: F401
from .analysis import Analysis  # noqa: F401

__all__ = ["Analysis", "AtomType", "Frequency", "analysis_types",
           "estimate_error", "exceptions", "geometry", "leaflets",
           "membrane_normal", "ordermap", "results"]

import sys as _sys

# make `import gorder_tpu_torch.compat.results` and the `gorder.results`
# module path work like pygorder's
_sys.modules[__name__ + ".results"] = results
