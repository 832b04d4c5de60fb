"""United-atom topology compilation.

Behavioral reference: uaorder.rs get_atom_type (:578-664) — each selected
carbon is classified by its saturation group and missing-hydrogen count into
CH3 / CH2 / CH1-unsaturated / CH1-saturated, with helper atoms taken from its
bonded neighbours (Ignore-group atoms excluded; helpers in ascending index
order; CH3's second helper is the first neighbour of helper1 that is not the
target). The object graph becomes flat per-category index arrays.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import TopologyError
from ..system import System
from .classify import MoleculeKind

log = logging.getLogger("gorder")

_CATEGORY_HYDROGENS = {"ch3": 3, "ch2": 2, "ch1u": 1, "ch1s": 1}


@dataclass
class UAAtomSpec:
    """One analyzable UA atom within a molecule type."""

    rel_index: int
    name: str
    resname: str
    category: str                  # 'ch3' | 'ch2' | 'ch1u' | 'ch1s'
    helpers_rel: Tuple[int, ...]   # 2 or 3 helper atoms, relative indices

    @property
    def n_hydrogens(self) -> int:
        return _CATEGORY_HYDROGENS[self.category]


@dataclass
class CompiledUA:
    """Flat device arrays for the UA kernel + result bookkeeping."""

    # per category: target/h1/h2[/h3]/mol arrays over all instances
    categories: Dict[str, Dict[str, np.ndarray]]
    # per virtual-bond sample (concatenated in kernel layout order):
    bond_type: np.ndarray
    bond_mol: np.ndarray
    n_types: int
    n_molecules: int
    # per kind: list of UAAtomSpec (ascending rel index) and the global type
    # id of each atom's first hydrogen
    atom_specs: List[List[UAAtomSpec]]
    atom_type_base: List[List[int]]
    type_offsets: np.ndarray       # per kind
    max_atom_index: int


def _classify_atom(system: System, adjacency, abs_idx: int,
                   sat_mask, unsat_mask, ignore_mask
                   ) -> Optional[Tuple[str, Tuple[int, ...]]]:
    bonded_all = adjacency[abs_idx]
    bonded = [int(b) for b in bonded_all if not ignore_mask[b]]
    if len(bonded) > 4:
        log.warning(
            "atom number %d is bonded to %d atoms (expected at most 4)",
            abs_idx + 1, len(bonded))
    missing_h = max(0, 4 - len(bonded))
    saturated = bool(sat_mask[abs_idx])
    unsaturated = bool(unsat_mask[abs_idx])
    if saturated and unsaturated:
        raise TopologyError(
            f"atom {abs_idx + 1} is classified as both saturated and "
            f"unsaturated")
    if missing_h == 0 or (unsaturated and missing_h == 1):
        return None
    if saturated:
        if missing_h == 1:
            return ("ch1s", (bonded[0], bonded[1], bonded[2]))
        if missing_h == 2:
            return ("ch2", (bonded[0], bonded[1]))
        if missing_h == 3:
            helper1 = bonded[0]
            helper2 = next(
                (int(n) for n in adjacency[helper1] if int(n) != abs_idx),
                None)
            if helper2 is None:
                log.warning(
                    "atom %s was identified as a methyl carbon but is in an "
                    "isolated two-atom chain; ignoring",
                    system.atom_names[abs_idx])
                return None
            return ("ch3", (helper1, helper2))
        log.warning(
            "atom %s of residue %s is a saturated carbon with %d missing "
            "hydrogens; unsupported, ignoring",
            system.atom_names[abs_idx], system.resnames[abs_idx], missing_h)
        return None
    if unsaturated:
        if missing_h == 2:
            return ("ch1u", (bonded[0], bonded[1]))
        log.warning(
            "atom %s of residue %s is an unsaturated carbon with %d missing "
            "hydrogens; unsupported, ignoring",
            system.atom_names[abs_idx], system.resnames[abs_idx],
            missing_h - 1)
        return None
    return None


def compile_ua(system: System, kinds: List[MoleculeKind],
               sat_mask: np.ndarray, unsat_mask: np.ndarray,
               ignore_mask: np.ndarray) -> CompiledUA:
    adjacency = system.adjacency()

    atom_specs: List[List[UAAtomSpec]] = []
    atom_type_base: List[List[int]] = []
    type_offsets = [0]
    next_type = 0

    # classify every order atom of every kind (using the first instance)
    for kind in kinds:
        specs: List[UAAtomSpec] = []
        bases: List[int] = []
        min0 = kind.min_indices[0]
        for rel, name, resname in kind.order_atoms:
            result = _classify_atom(system, adjacency, min0 + rel,
                                    sat_mask, unsat_mask, ignore_mask)
            if result is None:
                continue
            category, helpers_abs = result
            helpers_rel = tuple(h - min0 for h in helpers_abs)
            spec = UAAtomSpec(rel, name, resname, category, helpers_rel)
            specs.append(spec)
            bases.append(next_type)
            next_type += spec.n_hydrogens
        atom_specs.append(specs)
        atom_type_base.append(bases)
        type_offsets.append(next_type)

    # flat per-category arrays + per-sample type/mol ids in kernel layout
    # order (category-major: all ch3 atoms, then ch2, ch1u, ch1s; within a
    # category: kinds in order, atoms in order, instances in order;
    # per instance: hydrogens consecutive)
    categories: Dict[str, Dict[str, list]] = {}
    sample_types: Dict[str, list] = {}
    sample_mols: Dict[str, list] = {}

    mol_offsets = [0]
    for kind in kinds:
        mol_offsets.append(mol_offsets[-1] + kind.n_molecules)

    max_atom = 0
    for k, kind in enumerate(kinds):
        mins = np.asarray(kind.min_indices, np.int64)
        m0 = mol_offsets[k]
        for spec, base in zip(atom_specs[k], atom_type_base[k]):
            cat = categories.setdefault(
                spec.category,
                {"target": [], "h1": [], "h2": [], "h3": [], "mol": []})
            targets = mins + spec.rel_index
            cat["target"].append(targets)
            cat["h1"].append(mins + spec.helpers_rel[0])
            cat["h2"].append(mins + spec.helpers_rel[1])
            if spec.category == "ch1s":
                cat["h3"].append(mins + spec.helpers_rel[2])
            cat["mol"].append(m0 + np.arange(len(mins), dtype=np.int64))
            max_atom = max(max_atom, int(targets.max()),
                           int((mins + max(spec.helpers_rel)).max()))
            k_h = spec.n_hydrogens
            types = np.repeat(np.arange(base, base + k_h, dtype=np.int64)
                              [None, :], len(mins), axis=0).ravel()
            mols = np.repeat(m0 + np.arange(len(mins), dtype=np.int64), k_h)
            sample_types.setdefault(spec.category, []).append(types)
            sample_mols.setdefault(spec.category, []).append(mols)

    final_categories: Dict[str, Dict[str, np.ndarray]] = {}
    bond_type_parts, bond_mol_parts = [], []
    for cat in ("ch3", "ch2", "ch1u", "ch1s"):
        if cat not in categories:
            continue
        data = categories[cat]
        final = {
            "target": np.concatenate(data["target"]).astype(np.int32),
            "h1": np.concatenate(data["h1"]).astype(np.int32),
            "h2": np.concatenate(data["h2"]).astype(np.int32),
            "mol": np.concatenate(data["mol"]).astype(np.int32),
        }
        if data["h3"]:
            final["h3"] = np.concatenate(data["h3"]).astype(np.int32)
        final_categories[cat] = final
        bond_type_parts.append(np.concatenate(sample_types[cat]))
        bond_mol_parts.append(np.concatenate(sample_mols[cat]))

    if not bond_type_parts:
        # no predictable carbons: the caller finishes with empty results
        # (the reference succeeds and writes nothing,
        # tests_ua.rs test_ua_order_nothing_to_analyze)
        return None

    return CompiledUA(
        categories=final_categories,
        bond_type=np.concatenate(bond_type_parts).astype(np.int32),
        bond_mol=np.concatenate(bond_mol_parts).astype(np.int32),
        n_types=next_type,
        n_molecules=mol_offsets[-1],
        atom_specs=atom_specs,
        atom_type_base=atom_type_base,
        type_offsets=np.asarray(type_offsets, np.int64),
        max_atom_index=max_atom,
    )
