"""Plain order parameters from grid integers, in float64.

The semantics are gorder's: for every analyzed bond and frame, the bond
vector under the minimum image, cos²θ with the membrane normal (a fixed
axis, or the molecule's dynamic normal), the sample S = 1.5·cos²θ − 0.5
rounded half away from zero to 1e-6 (the reference's fixed point), and
the sums of those samples and their counts per bond type, overall and per
leaflet (upper = class 0). A value is sign · Σ / count / 1e6, pooled over
the types of a bond, an atom, a molecule type or the system; sign −1 for
all-atom order (S_CH), +1 for coarse-grained order (P2).

It starts from the integers the benchmark made, never from a file the
program read, and takes nothing from the program. `dtype` float64 is the
reference; a lower one (bfloat16) makes it the control, every step of the
chain after the integers in that precision.

The order kind (`type`), a tagged membrane normal and the leaflets are
methods found by name, one module each under `benchmark/reference/`
(`kinds/`, `normals/`, `leaflets/`; see `benchmark/reference/__init__`);
a plain axis string stays here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import cells
from .select import select

SCALE = 1.0e6
CLASSES = ("total", "upper", "lower")


def quantize(s: torch.Tensor) -> torch.Tensor:
    """Samples → int64 fixed point, f64(s)·1e6 rounded half away from 0."""
    x = s.to(torch.float64) * SCALE
    return (torch.sign(x) * torch.floor(torch.abs(x) + 0.5)).to(torch.int64)


class View(NamedTuple):
    """What a method's `build(spec, view)` reads of the analysis: per atom
    its `names`, `resnames` and `molecule` (topology id), the `bonds`, the
    box in grid units (`box`, a (3,) float64 tensor), the XTC `precision`,
    the `device` and the chain's `dtype`; once the kind has chosen its
    bonds, the analyzed molecules' topology ids (`molecules`), in the
    order of a method's per-molecule output."""

    names: list
    resnames: list
    molecule: object
    bonds: object
    box: torch.Tensor
    precision: float
    device: torch.device
    dtype: torch.dtype
    molecules: np.ndarray = None

    def select(self, query: str) -> np.ndarray:
        """Indices (ascending) of the atoms `query` selects."""
        return select(query, self.names, self.resnames)

    def heads_of(self, query: str) -> torch.Tensor:
        """(M,) int64 on the device: each analyzed molecule's atom that
        `query` selects (its last where it has several)."""
        chosen = self.select(query)
        by_mol = {int(self.molecule[i]): i for i in chosen}
        idx = [by_mol.get(int(m), -1) for m in self.molecules]
        if min(idx) < 0:
            raise ValueError(f"a molecule has no atom in '{query}'")
        return torch.as_tensor(np.asarray(idx, np.int64), device=self.device)


class OrderReference:
    """The expected results of one analysis, fed its frames' integers
    chunk by chunk, in frame order (`add`), then read (`values`). `gorder`
    is the analysis as the traffic file states it: gorder's configuration
    keys, a tagged value written {"!": tag, field: value, ...}. `bonds` is
    the kind's module's object, `normal` the tagged normal's (None for a
    plain axis), `leaflets` the classifier (None without leaflets)."""

    def __init__(self, names, resnames, molecule, bonds, box, precision,
                 gorder: dict, device, dtype=torch.float64):
        extra = set(gorder) - {"type", "membrane_normal", "leaflets"}
        if extra:
            raise NotImplementedError(
                f"the reference does not cover {sorted(extra)}")
        self.dtype = dtype
        box_int = torch.tensor(np.asarray(box, np.float64) * precision,
                               dtype=torch.float64, device=device)
        view = View(names, resnames, molecule, bonds, box_int,
                    float(precision), device, dtype)
        kind = gorder["type"]
        self.bonds = cells.reference_part("kinds", kind).build(kind, view)
        view = view._replace(molecules=self.bonds.molecules)
        normal = gorder.get("membrane_normal", "z")
        self.axis = self.normal = None
        if isinstance(normal, str):
            self.axis = torch.zeros(3, dtype=torch.float64, device=device)
            self.axis["xyz".index(normal.lower())] = 1.0
        else:
            self.normal = cells.reference_part("normals", normal).build(
                normal, view)
        leaflets = gorder.get("leaflets")
        self.leaflets = None
        if leaflets is not None:
            self.leaflets = cells.reference_part("leaflets", leaflets).build(
                leaflets, view)
        self.classes = CLASSES if leaflets is not None else CLASSES[:1]
        shape = (len(self.classes), self.bonds.n_types)
        self.sums = torch.zeros(shape, dtype=torch.int64, device=device)
        self.counts = torch.zeros(shape, dtype=torch.int64, device=device)
        self.n_molecules = len(self.bonds.molecules)

    def _cos2(self, d, normal):
        """cos²θ of (F, N, 3) vectors with the (3,) or (F, N, 3) normal;
        d² and n² floored at 1e-18 as gorder's chain floors them, so that
        a bond of zero length (two atoms on one grid point) gives 0."""
        proj = (d * normal).sum(-1)
        n2 = torch.clamp((normal * normal).sum(-1), min=1e-18)
        return proj * proj / (torch.clamp((d * d).sum(-1), min=1e-18) * n2)

    def add(self, ints: torch.Tensor) -> None:
        """Fold in the (F, A, 3) int32 grid integers of the next F frames."""
        bond_mol = self.bonds.bond_mol
        d = self.bonds.vectors(ints).to(self.dtype)
        if self.normal is None:
            normal = self.axis.to(self.dtype)
        else:
            normal = self.normal.normals(ints).index_select(1, bond_mol)
        s = 1.5 * self._cos2(d, normal) - 0.5
        q = quantize(s)                                      # (F, N) int64
        masks = [None]
        if self.leaflets is not None:
            per_bond = self.leaflets.classes(ints).index_select(1, bond_mol)
            masks += [per_bond == 0, per_bond == 1]
        ones = torch.ones_like(q)
        for c, mask in enumerate(masks):
            qc, nc = (q, ones) if mask is None else (q * mask, ones * mask)
            self.sums[c].index_add_(0, self.bonds.bond_type, qc.sum(0))
            self.counts[c].index_add_(0, self.bonds.bond_type, nc.sum(0))

    def values(self) -> dict:
        return self.bonds.values(self.sums.cpu().numpy(),
                                 self.counts.cpu().numpy(), self.classes)
