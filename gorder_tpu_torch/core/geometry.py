"""Geometric region selection on tensors (port of
`gorder_tpu/core/geometry.py`).

Behavioral reference: src/analysis/geometry.rs — cuboid, cylinder and
sphere shapes anchored at a reference point (fixed, the box center, or the
per-frame center of a selection), with infinite default spans, optional
inversion, and PBC-aware or naive inside tests. A bond whose midpoint lies
outside the shape contributes nothing.

The shape is a hashable spec; the per-frame reference point is a (B, 3)
tensor computed by the caller (`core/order.py geometry_reference`).

Exactness: the JAX package mixes Python floats into f32 arrays. Under
jnp's weak typing `lo`, `hi − lo` and `radius·radius` are computed in f64
and then rounded to f32 (gorder_tpu/core/geometry.py:71-72, :94, :105), so
`ShapeBounds` rounds exactly those f64 values once, on the host, and both
the plain version here and the UA kernel (`csrc/ua.cu`) compare against
them. `floor(shifted / length)` is a correctly rounded division and then a
floor; the minimum image of the cylinder and the sphere rounds half to
even (`torch.round`, `rintf` in the kernel), and the sphere's d² is
(d0² + d1²) + d2², as `jnp.sum` adds a size-3 axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

_AXIS = {"x": 0, "y": 1, "z": 2}
_KIND = {"cuboid": 0, "cylinder": 1, "sphere": 2}


@dataclass(frozen=True)
class GeometrySpec:
    kind: str                      # 'cuboid' | 'cylinder' | 'sphere'
    invert: bool = False
    # cuboid: spans relative to the reference
    xdim: Tuple[float, float] = (-np.inf, np.inf)
    ydim: Tuple[float, float] = (-np.inf, np.inf)
    zdim: Tuple[float, float] = (-np.inf, np.inf)
    # cylinder
    radius: float = np.inf
    span: Tuple[float, float] = (-np.inf, np.inf)
    orientation: int = 2


def build_geometry_spec(geometry) -> Optional[GeometrySpec]:
    if geometry is None:
        return None
    if geometry.kind == "cuboid":
        return GeometrySpec("cuboid", invert=getattr(geometry, "invert", False),
                            xdim=tuple(geometry.xdim),
                            ydim=tuple(geometry.ydim),
                            zdim=tuple(geometry.zdim))
    if geometry.kind == "cylinder":
        return GeometrySpec("cylinder",
                            invert=getattr(geometry, "invert", False),
                            radius=geometry.radius,
                            span=tuple(geometry.span),
                            orientation=_AXIS[geometry.orientation])
    return GeometrySpec("sphere", invert=getattr(geometry, "invert", False),
                        radius=geometry.radius)


@dataclass(frozen=True)
class ShapeBounds:
    """The f32 numbers the inside test compares against, each rounded once
    from its f64 value: per axis (x, y, z) whether the span is bounded
    (`np.isinf(lo) and np.isinf(hi)` is the unbounded case), `lo` and the
    extent `hi − lo`; the squared radius, or None for an infinite one.
    For a cuboid the axes are x, y, z; for a cylinder only its
    orientation's axis carries the span."""

    kind: int                      # 0 cuboid, 1 cylinder, 2 sphere
    invert: bool
    orientation: int
    bounded: Tuple[bool, bool, bool]
    lo: Tuple[float, float, float]
    extent: Tuple[float, float, float]
    radius2: Optional[float]


def shape_bounds(spec: GeometrySpec) -> ShapeBounds:
    spans = [(-np.inf, np.inf)] * 3
    if spec.kind == "cuboid":
        spans = [spec.xdim, spec.ydim, spec.zdim]
    elif spec.kind == "cylinder":
        spans[spec.orientation] = spec.span
    bounded = tuple(not (np.isinf(lo) and np.isinf(hi)) for lo, hi in spans)
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    with np.errstate(invalid="ignore"):
        lo = tuple(f32(lo) for lo, _ in spans)
        extent = tuple(f32(float(hi) - float(lo)) for lo, hi in spans)
    radius2 = (None if spec.kind == "cuboid" or np.isinf(spec.radius)
               else f32(float(spec.radius) * float(spec.radius)))
    return ShapeBounds(_KIND[spec.kind], bool(spec.invert),
                       int(spec.orientation), bounded, lo, extent, radius2)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor of the (already f32) value `x` on `like`'s device:
    never a Python scalar, whose rounding would be torch's choice."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def inside_mask(mid: torch.Tensor, ref: torch.Tensor, box_diag: torch.Tensor,
                spec: GeometrySpec, handle_pbc: bool) -> torch.Tensor:
    """(B, N, 3) midpoints, (B, 3) reference → (B, N) bool inside mask.

    PBC semantics mirror the reference's shape construction
    (geometry.rs construct_shape): each finite span moves the shape corner
    to reference + span_min with extent span_max − span_min; an infinite
    span covers the whole box (PBC) or everything (NoPBC). Inside tests use
    coordinates wrapped relative to the corner."""
    g = shape_bounds(spec)
    rel = mid - ref[:, None, :]                        # (B, N, 3)
    box = box_diag[:, None, :]

    def axis_ok(axis):
        delta = rel[..., axis]
        if not g.bounded[axis]:
            return torch.ones(delta.shape, dtype=torch.bool,
                              device=delta.device)
        shifted = delta - _f32(g.lo[axis], delta)     # corner-relative
        if handle_pbc:
            length = box[..., axis]
            shifted = shifted - length * torch.floor(shifted / length)
        return (shifted >= 0) & (shifted <= _f32(g.extent[axis], delta))

    if spec.kind == "cuboid":
        ok = axis_ok(0) & axis_ok(1) & axis_ok(2)
    elif spec.kind == "cylinder":
        p0, p1 = (a for a in range(3) if a != spec.orientation)
        d0, d1 = rel[..., p0], rel[..., p1]
        if handle_pbc:
            l0, l1 = box[..., p0], box[..., p1]
            d0 = d0 - l0 * torch.round(d0 / l0)
            d1 = d1 - l1 * torch.round(d1 / l1)
        if g.radius2 is None:
            radial_ok = torch.ones(d0.shape, dtype=torch.bool,
                                   device=d0.device)
        else:
            radial_ok = d0 * d0 + d1 * d1 <= _f32(g.radius2, d0)
        ok = radial_ok & axis_ok(spec.orientation)
    else:  # sphere
        d = rel
        if handle_pbc:
            d = d - box * torch.round(d / box)
        if g.radius2 is None:
            ok = torch.ones(d.shape[:-1], dtype=torch.bool, device=d.device)
        else:
            d0, d1, d2 = d.unbind(-1)
            ok = (d0 * d0 + d1 * d1) + d2 * d2 <= _f32(g.radius2, d0)
    if spec.invert:
        ok = ~ok
    return ok
