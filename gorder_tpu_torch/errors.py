"""Exception taxonomy for gorder-tpu.

Mirrors the error surface of the reference implementation
(src/errors.rs:20-530) as a Python exception hierarchy; every
user-facing failure raises one of these instead of a bare ValueError so the CLI
and Python API can present consistent diagnostics.
"""

from __future__ import annotations

PANIC_MESSAGE = (
    "this should not have happened — please report this bug "
    "(https://github.com/VachaLab/gorder-tpu/issues)"
)


def fnum(value: float) -> str:
    """Format a float the way Rust's f32 Display does (reference error
    messages interpolate numbers with to_string(): 20.0 -> "20",
    1.5 -> "1.5"), so our diagnostics match the reference text
    (src/errors.rs) byte for byte."""
    text = repr(float(value))
    return text[:-2] if text.endswith(".0") else text


class GorderError(Exception):
    """Base class of every error raised by gorder-tpu."""


class ConfigError(GorderError):
    """Invalid analysis configuration (YAML or API parameters)."""


class SelectionError(GorderError):
    """Invalid selection query or a query matching nothing it must match."""


class TopologyError(GorderError):
    """Problems constructing the molecular topology (bonds, classification)."""


class AnalysisError(GorderError):
    """Runtime failure during the analysis itself."""


class TrajectoryError(AnalysisError):
    """Problems reading a trajectory file (XTC/TRR/GRO)."""


class StructureError(GorderError):
    """Problems reading a structure file (TPR/GRO/PDB/PQR)."""


class BondsError(GorderError):
    """Problems parsing a bonds (.bnd) file."""


class NdxError(GorderError):
    """Problems parsing an NDX index file."""


class WriteError(GorderError):
    """Problems writing results to output files."""


class OrderMapError(GorderError):
    """Invalid ordermap parameters or ordermap write failure."""


class ErrorEstimationError(GorderError):
    """Invalid error-estimation parameters."""


class GeometryError(GorderError):
    """Invalid geometry-selection parameters."""


class FrequencyError(GorderError):
    """Invalid frequency specification."""


class NormalError(GorderError):
    """Invalid membrane-normal parameters or runtime normal failure."""


class DynamicNormalError(NormalError):
    """Dynamic membrane-normal estimation failed."""


class ManualNormalError(NormalError):
    """Manual (from-file/from-map) membrane normals invalid."""


class LeafletError(GorderError):
    """Leaflet-classification failure."""


class ManualLeafletError(LeafletError):
    """Manual (from-file/from-map) leaflet assignment invalid."""


class NdxLeafletError(LeafletError):
    """NDX-based leaflet assignment invalid."""


class ClusterError(LeafletError):
    """Clustering-based leaflet assignment failed."""
