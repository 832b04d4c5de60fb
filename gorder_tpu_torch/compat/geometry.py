"""pygorder ``gorder.geometry`` (geometry.pyi)."""

from __future__ import annotations

from typing import Sequence, Union

from ..input.config import Geometry

_INF = float("inf")


def Cuboid(xdim: Sequence[float] = (-_INF, _INF),
           ydim: Sequence[float] = (-_INF, _INF),
           zdim: Sequence[float] = (-_INF, _INF),
           reference: Union[Sequence[float], str, None] = None,
           invert: bool = False) -> Geometry:
    return Geometry("cuboid", reference=_ref(reference),
                    xdim=tuple(xdim), ydim=tuple(ydim), zdim=tuple(zdim),
                    invert=invert)


def Cylinder(radius: float, orientation: str,
             span: Sequence[float] = (-_INF, _INF),
             reference: Union[Sequence[float], str, None] = None,
             invert: bool = False) -> Geometry:
    return Geometry("cylinder", reference=_ref(reference), radius=radius,
                    span=tuple(span), orientation=orientation.lower(),
                    invert=invert)


def Sphere(radius: float,
           reference: Union[Sequence[float], str, None] = None,
           invert: bool = False) -> Geometry:
    return Geometry("sphere", reference=_ref(reference), radius=radius,
                    invert=invert)


def _ref(reference):
    if reference is None:
        return None
    if isinstance(reference, str):
        # pygorder: the literal string "center" (any case) means the box
        # center (pygorder/src/geometry.rs:224-225); anything else is a
        # selection query
        return None if reference.lower() == "center" else reference
    return tuple(float(v) for v in reference)


__all__ = ["Cuboid", "Cylinder", "Sphere"]
