"""pygorder ``gorder.membrane_normal`` (membrane_normal.pyi)."""

from __future__ import annotations

from ..input.config import MembraneNormal


def DynamicNormal(heads: str, radius: float = 2.0,
                  collect=None) -> MembraneNormal:
    return MembraneNormal.dynamic(heads, radius, collect)


__all__ = ["DynamicNormal"]
