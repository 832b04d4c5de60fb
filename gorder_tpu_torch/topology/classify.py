"""Molecule classification: bond graph → molecule types → index tensors.

Behavioral reference: src/analysis/topology/classify.rs (BFS from each atom of
the order group, relative-index topology fingerprint, identical molecules
merged into one type, residue-name naming with conflict suffixes) — re-built
array-first: connected components by label propagation, fingerprints as
blocks of integer rows, and per-type *index tensors* instead of an object
graph, so the analysis engine receives flat gather indices (SURVEY.md §7
step 2).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import TopologyError
from ..select import connected_components
from ..system import System, distinct_strings

# deterministic iteration & hashing of molecule fingerprints


@dataclass(frozen=True)
class BondTypeKey:
    """Identity of one analyzed bond type inside a molecule type."""

    rel_a: int
    name_a: str
    resname_a: str
    rel_b: int
    name_b: str
    resname_b: str

    def label(self) -> str:
        return (
            f"{self.resname_a} {self.name_a} ({self.rel_a}) - "
            f"{self.resname_b} {self.name_b} ({self.rel_b})"
        )


@dataclass
class MoleculeKind:
    """One molecule type with all its instances and analyzed bond types."""

    name: str
    # absolute atom index of the molecule's first atom, per instance
    min_indices: List[int]
    # analyzed bond types, sorted by (rel_a, rel_b)
    bond_types: List[BondTypeKey]
    # all atoms of one molecule as relative indices (for diagnostics)
    n_atoms_per_molecule: int
    # selected "order atoms" (heavy atoms for AA, beads for CG) as relative
    # indices with names, sorted
    order_atoms: List[Tuple[int, str, str]] = field(default_factory=list)
    # per bond type: heavy-atom rel index it belongs to (AA grouping);
    # equals rel_a for AA, meaningless for CG
    # head/methyl indices etc. are attached later by the leaflet/normal setup
    extra: Dict[str, object] = field(default_factory=dict)

    @property
    def n_molecules(self) -> int:
        return len(self.min_indices)

    @property
    def n_bond_types(self) -> int:
        return len(self.bond_types)

    def instance_atom(self, rel: int) -> np.ndarray:
        """Absolute atom indices of `rel` across instances."""
        return np.asarray(self.min_indices, dtype=np.int64) + rel


def _molecule_name(system: System, atom_indices: np.ndarray) -> str:
    """Unique residue names in order of appearance, joined by '-'
    (classify.rs:602-604)."""
    seen = []
    for i in np.sort(atom_indices):
        rn = str(system.resnames[i])
        if rn not in seen:
            seen.append(rn)
    return "-".join(seen)


def _resolve_name_conflicts(kinds: List[MoleculeKind]) -> None:
    """Suffix duplicate names with decreasing counts in reverse order
    (classify.rs solve_name_conflicts): with two POPC types the first
    becomes POPC1 and the second POPC2."""
    counts: Dict[str, int] = {}
    for kind in kinds:
        counts[kind.name] = counts.get(kind.name, 0) + 1
    counts = {k: v for k, v in counts.items() if v > 1}
    for kind in reversed(kinds):
        if kind.name in counts:
            counts[kind.name] -= 1
            suffix = counts[kind.name] + 1
            kind.name = f"{kind.name}{suffix}"


def classify_molecules(
    system: System,
    order_mask_1: np.ndarray,
    order_mask_2: Optional[np.ndarray] = None,
    *,
    mode: str,
) -> List[MoleculeKind]:
    """Classify molecules containing atoms of the order group(s).

    mode 'bonds': analyzed bond types are bonds with one end in group 1 and
    the other in group 2 (AA: heavy/hydrogen; CG: beads/beads).
    mode 'atoms': no bonds analyzed here; order atoms = group 1 (UA) and the
    per-atom structure is attached later.
    """
    if not system.has_bonds():
        raise TopologyError(
            "no bonds between atoms: bonds are required for the analysis "
            "(use a TPR or PDB structure, or supply a bonds file)"
        )
    if order_mask_2 is None:
        order_mask_2 = order_mask_1

    labels = connected_components(system.n_atoms, system.bonds)
    bonds = system.bonds
    n_mols = int(labels.max()) + 1 if labels.size else 0
    mol_range = np.arange(n_mols)

    # atoms by molecule, in index order; bonds by molecule, sorted
    by_label = np.argsort(labels, kind="stable")
    starts = np.searchsorted(labels[by_label], mol_range)
    ends = np.searchsorted(labels[by_label], mol_range, side="right")
    first_atom = by_label[starts]
    bond_labels = labels[bonds[:, 0]]
    bond_order = np.lexsort((bonds[:, 1], bonds[:, 0], bond_labels))
    sorted_bonds = bonds[bond_order]
    bond_starts = np.searchsorted(bond_labels[bond_order], mol_range)
    bond_ends = np.searchsorted(bond_labels[bond_order], mol_range,
                                side="right")

    # topology fingerprints as rows: (relative index, atom name code,
    # residue name code) an atom and (relative a, relative b) a bond; two
    # molecules are one type exactly when both their blocks are equal
    _, name_codes = distinct_strings(system.atom_names)
    _, resname_codes = distinct_strings(system.resnames)
    rel = np.arange(system.n_atoms, dtype=np.int64) - first_atom[labels]
    atom_rows = np.stack([rel, name_codes, resname_codes], axis=1)[by_label]
    bond_rows = (sorted_bonds.astype(np.int64)
                 - first_atom[bond_labels[bond_order]][:, None])

    starts, ends = starts.tolist(), ends.tolist()
    bond_starts, bond_ends = bond_starts.tolist(), bond_ends.tolist()
    kinds: List[MoleculeKind] = []
    kind_by_fingerprint: Dict[object, MoleculeKind] = {}

    # molecules in the order their first group-1 atom comes
    visits = labels[np.nonzero(order_mask_1)[0]]
    _, first_visit = np.unique(visits, return_index=True)
    for label in visits[np.sort(first_visit)].tolist():
        min_index = int(first_atom[label])
        fingerprint = (
            atom_rows[starts[label]:ends[label]].tobytes(),
            bond_rows[bond_starts[label]:bond_ends[label]].tobytes(),
        )
        existing = kind_by_fingerprint.get(fingerprint)
        if existing is not None:
            existing.min_indices.append(min_index)
            continue

        mol_atoms = by_label[starts[label]:ends[label]]
        mol_bonds = sorted_bonds[bond_starts[label]:bond_ends[label]]

        # analyzed bond types for this new molecule type
        bond_types: List[BondTypeKey] = []
        if mode == "bonds":
            for a, b in mol_bonds:
                a, b = int(a), int(b)
                in_12 = order_mask_1[a] and order_mask_2[b]
                in_21 = order_mask_2[a] and order_mask_1[b]
                if not (in_12 or in_21):
                    continue
                # orient: group-1 atom first (heavy atom for AA); for CG both
                # are beads and the lower index stays first
                if in_12:
                    first, second = a, b
                else:
                    first, second = b, a
                bond_types.append(BondTypeKey(
                    rel_a=first - min_index,
                    name_a=str(system.atom_names[first]),
                    resname_a=str(system.resnames[first]),
                    rel_b=second - min_index,
                    name_b=str(system.atom_names[second]),
                    resname_b=str(system.resnames[second]),
                ))
            bond_types.sort(key=lambda t: (t.rel_a, t.rel_b))

        order_atoms = sorted(
            (int(i) - min_index, str(system.atom_names[i]), str(system.resnames[i]))
            for i in mol_atoms
            if order_mask_1[i]
        )

        kind = MoleculeKind(
            name=_molecule_name(system, mol_atoms),
            min_indices=[min_index],
            bond_types=bond_types,
            n_atoms_per_molecule=len(mol_atoms),
            order_atoms=order_atoms,
        )
        kinds.append(kind)
        kind_by_fingerprint[fingerprint] = kind

    if mode == "bonds":
        kinds = [k for k in kinds if k.bond_types]

    _resolve_name_conflicts(kinds)
    return kinds


@dataclass
class CompiledBonds:
    """Flat per-bond-instance gather arrays for the device kernel.

    N = total bond instances over all molecule types. Bond types are numbered
    globally: type t of kind k has id `type_offsets[k] + t`.
    """

    atom_a: np.ndarray        # (N,) int32 absolute atom index (group-1 atom)
    atom_b: np.ndarray        # (N,) int32
    bond_type: np.ndarray     # (N,) int32 global bond type id
    molecule: np.ndarray      # (N,) int32 global molecule instance id
    type_offsets: np.ndarray  # (n_kinds + 1,) int64
    mol_offsets: np.ndarray   # (n_kinds + 1,) int64
    n_types: int
    n_molecules: int

    @property
    def n_bonds(self) -> int:
        return len(self.atom_a)


def compile_bonds(kinds: List[MoleculeKind]) -> CompiledBonds:
    atom_a, atom_b, bond_type, molecule = [], [], [], []
    type_offsets = [0]
    mol_offsets = [0]
    for kind in kinds:
        mins = np.asarray(kind.min_indices, dtype=np.int64)
        t0 = type_offsets[-1]
        m0 = mol_offsets[-1]
        for t, bt in enumerate(kind.bond_types):
            atom_a.append(mins + bt.rel_a)
            atom_b.append(mins + bt.rel_b)
            bond_type.append(np.full(len(mins), t0 + t, np.int64))
            molecule.append(m0 + np.arange(len(mins), dtype=np.int64))
        type_offsets.append(t0 + kind.n_bond_types)
        mol_offsets.append(m0 + kind.n_molecules)

    if atom_a:
        atom_a_arr = np.concatenate(atom_a).astype(np.int32)
        atom_b_arr = np.concatenate(atom_b).astype(np.int32)
        bond_type_arr = np.concatenate(bond_type).astype(np.int32)
        molecule_arr = np.concatenate(molecule).astype(np.int32)
    else:
        atom_a_arr = np.zeros(0, np.int32)
        atom_b_arr = np.zeros(0, np.int32)
        bond_type_arr = np.zeros(0, np.int32)
        molecule_arr = np.zeros(0, np.int32)

    return CompiledBonds(
        atom_a=atom_a_arr,
        atom_b=atom_b_arr,
        bond_type=bond_type_arr,
        molecule=molecule_arr,
        type_offsets=np.array(type_offsets, np.int64),
        mol_offsets=np.array(mol_offsets, np.int64),
        n_types=int(type_offsets[-1]),
        n_molecules=int(mol_offsets[-1]),
    )
