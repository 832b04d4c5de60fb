"""pygorder-compatible method-style results API (the port's copy of
`gorder_tpu/results/pyapi.py`).

pygorder, the reference's Python package, returns results objects with
*methods* (`results.n_analyzed_frames()`,
`molecule.average_order().total().value()`, `map.extract()`, …;
signatures in pygorder's results.pyi and __init__.pyi AtomType). This
module wraps this package's attribute-style results tree (results/model.py)
in views with exactly that surface, the reference's APIError messages
included, so code written against pygorder runs unchanged through
``gorder_tpu_torch.compat``::

    import gorder_tpu_torch.compat as gorder   # drop-in for `import gorder`

    results = gorder.Analysis(...).run()       # on the GPU
    results.average_order().total().value()
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import GorderError as APIError
from . import model as _m


class AtomType:
    """Atom identity within a molecule type (pygorder __init__.pyi:113)."""

    def __init__(self, desc: _m.AtomDesc):
        self._desc = desc

    def atom_name(self) -> str:
        return self._desc.name

    def relative_index(self) -> int:
        return self._desc.rel_index

    def residue_name(self) -> str:
        return self._desc.resname

    def __repr__(self) -> str:
        return (f"AtomType({self._desc.resname} {self._desc.name} "
                f"({self._desc.rel_index}))")


class Order:
    """Order parameter value with optional error (results.pyi:539-560)."""

    def __init__(self, order: _m.Order):
        self._order = order

    def value(self) -> float:
        return float(self._order.value)

    def error(self) -> Optional[float]:
        return None if self._order.error is None else float(self._order.error)

    def __repr__(self) -> str:
        return f"Order(value={self._order.value}, error={self._order.error})"


class OrderCollection:
    """total/upper/lower order parameters (results.pyi:563-594)."""

    def __init__(self, col: _m.OrderCollection):
        self._col = col

    def total(self) -> Optional[Order]:
        return None if self._col.total is None else Order(self._col.total)

    def upper(self) -> Optional[Order]:
        return None if self._col.upper is None else Order(self._col.upper)

    def lower(self) -> Optional[Order]:
        return None if self._col.lower is None else Order(self._col.lower)


class Map:
    """2-D order parameter map (results.pyi:329-387)."""

    def __init__(self, values: np.ndarray, spec):
        self._values = np.asarray(values, np.float32)  # (n0, n1)
        self._spec = spec

    def span_x(self) -> Tuple[float, float]:
        return (float(self._spec.start0), float(self._spec.end0))

    def span_y(self) -> Tuple[float, float]:
        return (float(self._spec.start1), float(self._spec.end1))

    def tile_dim(self) -> Tuple[float, float]:
        return (float(self._spec.bin0), float(self._spec.bin1))

    def get_at(self, x: float, y: float) -> Optional[float]:
        """Order parameter of the tile nearest to (x, y); None out of
        bounds (nearest-tile binning like ordermap.rs Map::add_order)."""
        s = self._spec
        i0 = math.floor((x - s.start0) / s.bin0 + 0.5)
        i1 = math.floor((y - s.start1) / s.bin1 + 0.5)
        if i0 < 0 or i0 >= s.n0 or i1 < 0 or i1 >= s.n1:
            return None
        return float(self._values[i0, i1])

    def extract(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(x tile positions (n0,), y tile positions (n1,), values
        (n0, n1)) as float32 NumPy arrays."""
        return (self._spec.tick0().astype(np.float32),
                self._spec.tick1().astype(np.float32),
                self._values.copy())


class OrderMapsCollection:
    """total/upper/lower maps (results.pyi:597-628)."""

    def __init__(self, maps: Optional[Dict[str, np.ndarray]], spec):
        self._maps = maps
        self._spec = spec

    def _get(self, cls: str) -> Optional[Map]:
        if self._maps is None or cls not in self._maps:
            return None
        return Map(self._maps[cls], self._spec)

    def total(self) -> Optional[Map]:
        return self._get("total")

    def upper(self) -> Optional[Map]:
        return self._get("upper")

    def lower(self) -> Optional[Map]:
        return self._get("lower")


class Convergence:
    """Cumulative averages over analyzed frames (results.pyi:236-284)."""

    def __init__(self, conv: Dict[str, np.ndarray], step: int):
        self._conv = conv
        self._step = max(int(step), 1)

    def frames(self) -> List[int]:
        n = len(next(iter(self._conv.values())))
        return [1 + i * self._step for i in range(n)]

    def _get(self, cls: str) -> Optional[List[float]]:
        if cls not in self._conv:
            return None
        return [float(v) for v in self._conv[cls]]

    def total(self) -> Optional[List[float]]:
        return self._get("total")

    def upper(self) -> Optional[List[float]]:
        return self._get("upper")

    def lower(self) -> Optional[List[float]]:
        return self._get("lower")


class LeafletsData:
    """Collected leaflet classification (results.pyi:288-326)."""

    def __init__(self, raw: _m.AnalysisResults):
        self._raw = raw

    def get_molecule(self, molecule: str) -> Optional[np.ndarray]:
        """(n_frames, n_molecules) uint8; 1 = upper, 0 = lower."""
        return self._raw.leaflets_for_molecule(molecule)

    def frames(self) -> List[int]:
        data = self._raw.leaflets_data
        stride = data["frequency_n"] * max(int(data["step"]), 1)
        return [1 + i * stride for i in range(len(data["frames"]))]


class NormalsData:
    """Collected membrane normals (results.pyi:497-536)."""

    def __init__(self, raw: _m.AnalysisResults):
        self._raw = raw

    def get_molecule(self, molecule: str) -> Optional[np.ndarray]:
        """(n_frames, n_molecules, 3) float32; NaN where uncomputed."""
        return self._raw.normals_for_molecule(molecule)

    def frames(self) -> List[int]:
        data = self._raw.normals_data
        step = max(int(data["step"]), 1)
        return [1 + i * step for i in range(len(data["frames"]))]


class BondResults:
    """Per-bond-type results (results.pyi:186-233)."""

    def __init__(self, bond: _m.BondResults, molecule_name: str, spec):
        self._bond = bond
        self._molecule = molecule_name
        self._spec = spec

    def molecule(self) -> str:
        return self._molecule

    def atoms(self) -> Tuple[AtomType, AtomType]:
        if self._bond.atom2 is None:
            raise APIError(
                "united-atom bond types involve only one real atom type")
        return (AtomType(self._bond.atom1), AtomType(self._bond.atom2))

    def order(self) -> OrderCollection:
        return OrderCollection(self._bond.order)

    def ordermaps(self) -> OrderMapsCollection:
        return OrderMapsCollection(self._bond.maps, self._spec)


class AtomResults:
    """Per-heavy-atom results (results.pyi:113-183)."""

    def __init__(self, atom: _m.AtomResults, molecule_name: str, mode: str,
                 spec):
        self._atom = atom
        self._molecule = molecule_name
        self._mode = mode
        self._spec = spec

    def atom(self) -> AtomType:
        return AtomType(self._atom.atom)

    def molecule(self) -> str:
        return self._molecule

    def bonds(self) -> List[BondResults]:
        return [BondResults(b, self._molecule, self._spec)
                for b in self._atom.bonds]

    def get_bond(self, relative_index: int) -> BondResults:
        for b in self._atom.bonds:
            partner = (b.atom2.rel_index if b.atom2 is not None
                       else b.virtual_index)
            if partner == relative_index:
                return BondResults(b, self._molecule, self._spec)
        raise APIError(
            "bond between the atom type and the specified (virtual) "
            "hydrogen type does not exist")

    def order(self) -> OrderCollection:
        return OrderCollection(self._atom.order)

    def ordermaps(self) -> OrderMapsCollection:
        return OrderMapsCollection(self._atom.maps, self._spec)


class MoleculeResults:
    """Per-molecule-type results (results.pyi:390-494)."""

    def __init__(self, mol: _m.MoleculeResults, mode: str, step: int, spec):
        self._mol = mol
        self._mode = mode
        self._step = step
        self._spec = spec

    def molecule(self) -> str:
        return self._mol.name

    def average_order(self) -> OrderCollection:
        return OrderCollection(self._mol.average_order)

    def average_ordermaps(self) -> OrderMapsCollection:
        return OrderMapsCollection(self._mol.average_maps, self._spec)

    def atoms(self) -> List[AtomResults]:
        if self._mode == "cg":
            raise APIError(
                "results for individual atoms are not available for "
                "coarse-grained order parameters")
        return [AtomResults(a, self._mol.name, self._mode, self._spec)
                for a in self._mol.atoms]

    def bonds(self) -> List[BondResults]:
        if self._mode == "cg":
            bonds = self._mol.bonds
        else:
            bonds = [b for a in self._mol.atoms for b in a.bonds]
        return [BondResults(b, self._mol.name, self._spec) for b in bonds]

    def get_atom(self, relative_index: int) -> AtomResults:
        if self._mode == "cg":
            raise APIError(
                "results for individual atoms are not available for "
                "coarse-grained order parameters")
        for a in self._mol.atoms:
            if a.atom.rel_index == relative_index:
                return AtomResults(a, self._mol.name, self._mode, self._spec)
        raise APIError(
            "atom with the given relative index does not exist or was not "
            "analyzed")

    def get_bond(self, relative_index_1: int,
                 relative_index_2: int) -> BondResults:
        if self._mode == "ua":
            # reference message verbatim (pygorder/src/results.rs)
            raise APIError(
                "united-atom results for individual bonds cannot be accesed "
                "by using relative indices")
        want = {relative_index_1, relative_index_2}
        bonds = self._mol.bonds + [b for a in self._mol.atoms
                                   for b in a.bonds]
        for b in bonds:
            if b.atom2 is not None and \
                    {b.atom1.rel_index, b.atom2.rel_index} == want:
                return BondResults(b, self._mol.name, self._spec)
        raise APIError(
            "bond specified by the given relative indices does not exist")

    def convergence(self) -> Optional[Convergence]:
        if self._mol.convergence is None:
            return None
        return Convergence(self._mol.convergence, self._step)


class AnalysisResults:
    """Top-level results container (results.pyi:11-110)."""

    def __init__(self, raw: _m.AnalysisResults):
        self._raw = raw
        self._spec = (raw.map_params[1] if raw.map_params is not None
                      else None)
        self._step = (getattr(raw.analysis, "step", 1)
                      if raw.analysis is not None else 1)

    @property
    def raw(self) -> _m.AnalysisResults:
        """The underlying native (attribute-style) results tree."""
        return self._raw

    def write(self) -> None:
        self._raw.write()

    def n_analyzed_frames(self) -> int:
        return int(self._raw.n_analyzed_frames)

    def molecules(self) -> List[MoleculeResults]:
        return [MoleculeResults(m, self._raw.mode, self._step, self._spec)
                for m in self._raw.molecules]

    def get_molecule(self, name: str) -> MoleculeResults:
        for m in self._raw.molecules:
            if m.name == name:
                return MoleculeResults(m, self._raw.mode, self._step,
                                       self._spec)
        raise APIError("molecule with the given name does not exist")

    def average_order(self) -> OrderCollection:
        return OrderCollection(self._raw.average_order)

    def average_ordermaps(self) -> OrderMapsCollection:
        return OrderMapsCollection(self._raw.average_maps, self._spec)

    def leaflets_data(self) -> Optional[LeafletsData]:
        if self._raw.leaflets_data is None:
            return None
        return LeafletsData(self._raw)

    def normals_data(self) -> Optional[NormalsData]:
        if self._raw.normals_data is None:
            return None
        return NormalsData(self._raw)
