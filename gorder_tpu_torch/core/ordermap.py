"""2-D ordermaps (port of `gorder_tpu/core/ordermap.py`).

A map is, per bond type, the grid of Σ order / samples over a plane of the
box (src/analysis/ordermap.rs): each sample lands in the tile nearest its
bond midpoint's two plane components; samples outside the grid are
ignored.

The state is one int64 tensor (C, 2, T·n0·n1 + 1) on the device for the
whole run: class (total, or total/upper/lower) × [Σ quantized samples,
count] × (type-major cells, then the dump entry that takes every sample
outside the grid). The cell ids are the JAX package's (`map_cells`). The
JAX package scatters 7-bit f32 limbs with `segment_sum` and adds them up
on the host every batch; integer sums are exact in any order, so here the
samples go straight into the state (`update_maps`, in place) and the
state is copied to the host once, when the run drains.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

_PLANE_AXES = {"xy": (0, 1), "xz": (0, 2), "yz": (1, 2)}
_SCALE = 1.0e-6


@dataclass(frozen=True)
class MapSpec:
    """The grid: plane axes, starts, bin sizes and tile counts."""

    ax0: int
    ax1: int
    start0: float
    start1: float
    bin0: float
    bin1: float
    n0: int
    n1: int
    # requested span ends (before snapping to the bin grid), as the Python
    # API's Map.span_x/span_y report them (pygorder results.pyi:333-350)
    end0: float = 0.0
    end1: float = 0.0

    @property
    def ncells(self) -> int:
        return self.n0 * self.n1

    def tick0(self) -> np.ndarray:
        return self.start0 + np.arange(self.n0) * self.bin0

    def tick1(self) -> np.ndarray:
        return self.start1 + np.arange(self.n1) * self.bin1


def build_map_spec(params, structure_box: Optional[np.ndarray]) -> MapSpec:
    """The grid of OrderMapParams over the structure's box (auto spans are
    (0, box[axis]), ordermap.rs Map::new). `structure_box` is None when
    PBC handling is off (the reference passes simbox: None there,
    ordermap.rs:55-64)."""
    from ..errors import OrderMapError, fnum

    ax0, ax1 = _PLANE_AXES[params.plane]
    spans = []
    for axis, gridspan in zip((ax0, ax1), params.dim):
        if gridspan.auto:
            if structure_box is None or structure_box[axis, axis] <= 0:
                # wording: src/errors.rs:399-401
                # (OrderMapConfigError::InvalidBoxAuto)
                raise OrderMapError(
                    "simulation box and periodic boundary conditions are "
                    "ignored => unable to automatically set ordermap "
                    "dimensions (hint: set ordermap dimensions manually)")
            spans.append((0.0, float(structure_box[axis, axis])))
        else:
            spans.append((gridspan.start, gridspan.end))
    (s0, e0), (s1, e1) = spans
    b0, b1 = params.bin_size
    if b0 > e0 - s0 or b1 > e1 - s1:
        # wording: src/errors.rs:390-397 (OrderMapConfigError::BinTooLarge);
        # the spans reported are the grid maxima, as GridMap::new's check
        raise OrderMapError(
            f"invalid bin size of 'ordermap': bin size of "
            f"'{fnum(b0)}x{fnum(b1)}' is larger than grid span of "
            f"'{fnum(e0)}x{fnum(e1)}'")
    n0 = int(np.floor((e0 - s0) / b0 + 0.5)) + 1
    n1 = int(np.floor((e1 - s1) / b1 + 0.5)) + 1
    return MapSpec(ax0, ax1, s0, s1, b0, b1, n0, n1, e0, e1)


def _tile(p: torch.Tensor, start: float, size: float, n: int):
    """floor((p − start) / size + 0.5) in f32, as the JAX package takes it
    (its Python-float start and size become f32 constants), and whether it
    lies in [0, n). The division is by a tensor on p's device: on the card
    a division by a CPU scalar multiplies by its reciprocal, which is not
    correctly rounded."""
    def const(x):
        return torch.tensor(np.float32(x), device=p.device)

    f = torch.floor((p - const(start)) / const(size) + 0.5)
    ok = (f >= 0) & (f < n)
    return torch.where(ok, f, 0).to(torch.int64), ok


def map_cells(mid: torch.Tensor, spec: MapSpec, bond_type: torch.Tensor,
              n_types: int):
    """(B, N, 3) f32 midpoints and each sample's (N,) bond type → (B, N)
    int64 type-major cell ids, samples outside the grid in the trailing
    dump cell T·n0·n1, and the (B, N) in-grid mask."""
    i0, ok0 = _tile(mid[..., spec.ax0], spec.start0, spec.bin0, spec.n0)
    i1, ok1 = _tile(mid[..., spec.ax1], spec.start1, spec.bin1, spec.n1)
    in_range = ok0 & ok1
    cell = (bond_type.to(torch.int64)[None, :] * spec.n0 + i0) * spec.n1 + i1
    return torch.where(in_range, cell, n_types * spec.ncells), in_range


def init_map_state(n_classes: int, n_types: int, spec: MapSpec,
                   device) -> torch.Tensor:
    """A zeroed (C, 2, T·n0·n1 + 1) int64 state on `device`."""
    return torch.zeros((n_classes, 2, n_types * spec.ncells + 1),
                       dtype=torch.int64, device=device)


def update_maps(state: torch.Tensor, q: torch.Tensor, cells: torch.Tensor,
                masks) -> torch.Tensor:
    """Add (B, N) int64 samples `q` to their `cells` of the (C, 2, S)
    state, in place: for class c, q·masks[c] to the sums and masks[c] to
    the counts; `masks` holds one (B, N) int64 mask of {0, 1} per class.
    Returns the state."""
    flat = cells.reshape(-1)
    for c, m in enumerate(masks):
        state[c, 0].index_add_(0, flat, (q * m).reshape(-1))
        state[c, 1].index_add_(0, flat, m.reshape(-1))
    return state


def finalize_maps(state_host, n_types: int, spec: MapSpec, min_samples: int,
                  sign: float):
    """{class: (2, S) int64 [Σq, count]} → ({class: (T, n0, n1) grids, NaN
    below min_samples}, {class: (sums, counts)} f64 for aggregation),
    with the JAX package's arithmetic (the dump cell dropped, sums back on
    the 1e-6 scale)."""
    grids = {}
    raw = {}
    for cls, arr in state_host.items():
        arr = np.asarray(arr, np.int64)[:, :-1]
        shape = (n_types, spec.n0, spec.n1)
        sums = arr[0].reshape(shape).astype(np.float64) * _SCALE
        counts = arr[1].reshape(shape).astype(np.float64)
        raw[cls] = (sums, counts)
        with np.errstate(invalid="ignore", divide="ignore"):
            values = sign * sums / counts
        grids[cls] = np.where(counts >= max(min_samples, 1), values, np.nan)
    return grids, raw


def aggregate_map(raw_cls, type_indices, spec: MapSpec, min_samples: int,
                  sign: float) -> np.ndarray:
    """The average grid over a set of bond types (an atom, a molecule
    type, the system)."""
    sums, counts = raw_cls
    s = sums[type_indices].sum(axis=0)
    c = counts[type_indices].sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        values = sign * s / c
    return np.where(c >= max(min_samples, 1), values, np.nan)
