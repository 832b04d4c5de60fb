"""pygorder ``gorder.analysis_types`` (analysis_types.pyi)."""

from __future__ import annotations

from typing import Optional

from ..input.config import AnalysisType


def AAOrder(heavy_atoms: str, hydrogens: str) -> AnalysisType:
    return AnalysisType.aaorder(heavy_atoms, hydrogens)


def CGOrder(beads: str) -> AnalysisType:
    return AnalysisType.cgorder(beads)


def UAOrder(saturated: Optional[str] = None,
            unsaturated: Optional[str] = None,
            ignore: Optional[str] = None) -> AnalysisType:
    return AnalysisType.uaorder(saturated=saturated, unsaturated=unsaturated,
                                ignore=ignore)


__all__ = ["AAOrder", "CGOrder", "UAOrder"]
