"""Results data model (mirrors src/presentation results structures).

One generic tree covers the three analysis modes:
- CG: molecule → bonds (bead pairs)
- AA: molecule → heavy atoms → C-H bonds
- UA: molecule → atoms → virtual C-H bonds (numbered, no real H atom)

Every node carries an OrderCollection (total/upper/lower `Order` values with
optional errors) and optionally convergence/ordermap data attached by the
converter.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Order:
    value: float
    error: Optional[float] = None


@dataclass
class OrderCollection:
    total: Optional[Order] = None
    upper: Optional[Order] = None
    lower: Optional[Order] = None

    def present(self) -> bool:
        return any(x is not None for x in (self.total, self.upper, self.lower))


@dataclass
class AtomDesc:
    """Atom identity: residue name, atom name, relative index."""

    resname: str
    name: str
    rel_index: int

    def label(self) -> str:
        return f"{self.resname} {self.name} ({self.rel_index})"

    def compact(self) -> str:
        return f"{self.resname}-{self.name}-{self.rel_index}"


@dataclass
class BondResults:
    atom1: AtomDesc
    atom2: Optional[AtomDesc]      # None for UA virtual hydrogens
    virtual_index: Optional[int] = None  # UA: ordinal of the virtual bond
    order: OrderCollection = field(default_factory=OrderCollection)
    # ordermaps: dict class -> (nx, ny) float arrays, attached when requested
    maps: Optional[Dict[str, np.ndarray]] = None


@dataclass
class AtomResults:
    """AA heavy atom / UA carbon with its bonds."""

    atom: AtomDesc
    order: OrderCollection = field(default_factory=OrderCollection)
    bonds: List[BondResults] = field(default_factory=list)
    maps: Optional[Dict[str, np.ndarray]] = None

    def get_bond(self, relative_index: int) -> "BondResults":
        """Bond to the partner atom with this relative index
        (pygorder AtomResults.get_bond)."""
        for b in self.bonds:
            if b.atom2 is not None and b.atom2.rel_index == relative_index:
                return b
        raise KeyError(
            f"no bond between atom {self.atom.rel_index} and atom "
            f"{relative_index}")


@dataclass
class MoleculeResults:
    name: str
    average_order: OrderCollection = field(default_factory=OrderCollection)
    # CG: bonds at molecule level; AA/UA: atoms with nested bonds
    bonds: List[BondResults] = field(default_factory=list)
    atoms: List[AtomResults] = field(default_factory=list)
    convergence: Optional[Dict[str, np.ndarray]] = None  # class -> prefix avgs
    average_maps: Optional[Dict[str, np.ndarray]] = None

    def get_atom(self, relative_index: int) -> AtomResults:
        """Heavy atom by relative index (pygorder
        MoleculeResults.get_atom)."""
        for a in self.atoms:
            if a.atom.rel_index == relative_index:
                return a
        raise KeyError(f"no analyzed atom with relative index "
                       f"{relative_index} in molecule '{self.name}'")

    def get_bond(self, relative_index_1: int,
                 relative_index_2: int) -> BondResults:
        """Bond by its two relative indices, order-insensitive (pygorder
        MoleculeResults.get_bond)."""
        want = {relative_index_1, relative_index_2}
        for b in self.bonds + [b for a in self.atoms for b in a.bonds]:
            if b.atom2 is not None and \
                    {b.atom1.rel_index, b.atom2.rel_index} == want:
                return b
        raise KeyError(
            f"no bond between atoms {relative_index_1} and "
            f"{relative_index_2} in molecule '{self.name}'")


@dataclass
class AnalysisResults:
    mode: str                      # 'aa' | 'cg' | 'ua'
    average_order: OrderCollection
    molecules: List[MoleculeResults]
    n_analyzed_frames: int
    structure_path: str = ""
    trajectory_paths: List[str] = field(default_factory=list)
    frame_numbers: Optional[np.ndarray] = None  # analyzed trajectory frames
    average_maps: Optional[Dict[str, np.ndarray]] = None
    map_params: Optional[object] = None         # OrderMapParams + grid info
    leaflets_data: Optional[Dict] = None        # collected leaflet assignment
    normals_data: Optional[Dict] = None         # collected membrane normals
    analysis: Optional[object] = None           # the Analysis request

    def get_molecule(self, name: str) -> MoleculeResults:
        for m in self.molecules:
            if m.name == name:
                return m
        raise KeyError(f"molecule '{name}' not found in results")

    def molecule_names(self) -> List[str]:
        return [m.name for m in self.molecules]

    def leaflets_for_molecule(self, name: str) -> Optional[np.ndarray]:
        """Collected per-frame leaflet assignment for one molecule type as a
        (n_assignment_frames, n_molecules) uint8 array, 1 = upper / 0 = lower
        (pygorder LeafletsData.get_molecule numpy export)."""
        if self.leaflets_data is None:
            return None
        for kind, lo, hi in self.leaflets_data["kinds"]:
            if kind == name:
                frames = self.leaflets_data["frames"]
                return np.stack([1 - np.asarray(f[lo:hi], np.uint8)
                                 for f in frames])
        return None

    def normals_for_molecule(self, name: str) -> Optional[np.ndarray]:
        """Collected per-frame dynamic/manual membrane normals for one
        molecule type as a (n_frames, n_molecules, 3) float32 array
        (pygorder NormalsData.get_molecule numpy export)."""
        if self.normals_data is None:
            return None
        for kind, lo, hi in self.normals_data["kinds"]:
            if kind == name:
                return np.asarray(self.normals_data["frames"][:, lo:hi],
                                  np.float32)
        return None

    def write(self) -> None:
        from ..present import write_all_results

        write_all_results(self)
