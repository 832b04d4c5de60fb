from .config import (  # noqa: F401
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
