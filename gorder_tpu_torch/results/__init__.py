from .model import (  # noqa: F401
    AnalysisResults,
    AtomDesc,
    AtomResults,
    BondResults,
    MoleculeResults,
    Order,
    OrderCollection,
)
