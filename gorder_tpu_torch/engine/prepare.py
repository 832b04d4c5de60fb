"""Run preparation: structure ingest, atom-space/wire-subset construction,
group selection errors and molecule-kind compilation.

Reference parity notes cite src/analysis/common.rs and src/errors.rs per
function."""

from __future__ import annotations

import logging
import os
from typing import List, Tuple

import numpy as np

from ..errors import ConfigError, TopologyError
from ..input.config import Analysis
from ..io import read_bnd, read_gro, read_ndx, read_pdb, read_pqr
from ..io.tpr import read_tpr
from ..io.traj import AtomSubset
from ..results.model import AnalysisResults, OrderCollection
from ..select import ensure_elements, query_uses_elements, select_mask
from ..system import System
from ..topology.classify import (
    CompiledBonds,
    MoleculeKind,
    classify_molecules,
    compile_bonds,
)

log = logging.getLogger("gorder")

_AXIS_INDEX = {"x": 0, "y": 1, "z": 2}

# ---------------------------------------------------------------- preparation


def load_structure(analysis: Analysis) -> System:
    path = analysis.structure
    ext = os.path.splitext(path)[1].lower()
    if ext == ".tpr":
        system = read_tpr(path)
    elif ext == ".gro":
        system = read_gro(path)
    elif ext == ".pdb":
        system = read_pdb(path)
    elif ext == ".pqr":
        system = read_pqr(path)
    else:
        # wording: src/errors.rs:338-339 (ConfigError::InvalidStructureFormat)
        raise ConfigError(
            f"the provided structure file '{path}' has an unknown, "
            f"invalid, or unsupported format")

    if analysis.bonds is not None:
        read_bnd(analysis.bonds, system)
    elif not system.has_bonds() and ext not in (".tpr",):
        # wording: src/errors.rs:331-332 (ConfigError::NoTopology);
        # raised at structure load like structure.rs:54-88 — a PDB without
        # CONECT or a GRO/PQR without a bonds file has no topology
        raise ConfigError(
            f"the input structure file '{path}' does not contain topology "
            f"information (hint: provide a `bonds` file)")

    if analysis.index is not None:
        read_ndx(analysis.index, system)

    # element guessing only when a query requests it and the structure did
    # not provide elements (structure.rs:202-246)
    queries = [
        q for q in (
            analysis.analysis_type.heavy_atoms,
            analysis.analysis_type.hydrogens,
            analysis.analysis_type.beads,
            analysis.analysis_type.saturated,
            analysis.analysis_type.unsaturated,
            analysis.analysis_type.ignore,
            analysis.leaflets.membrane if analysis.leaflets else None,
            analysis.leaflets.heads if analysis.leaflets else None,
            analysis.leaflets.methyls if analysis.leaflets else None,
            analysis.membrane_normal.heads,
            analysis.geometry.reference
            if analysis.geometry is not None
            and isinstance(analysis.geometry.reference, str) else None,
        ) if q
    ]
    if any(query_uses_elements(q) for q in queries):
        ensure_elements(system)
    return system

def _build_atom_space(system: System, analysis: Analysis, index_arrays):
    """Union of every atom the device pipeline gathers → compact wire
    subset + index remap.

    The TPU equivalent of the reference's Master group ("only the necessary
    atoms are read from XTC", src/analysis/common.rs:62-105, 283-304): the
    decoder ships exactly these atoms, in compact slot order, and every
    device-side index tensor is remapped into slot space."""
    n = system.n_atoms
    mask = np.zeros(n, bool)
    for arr in index_arrays:
        a = np.asarray(arr, np.int64).reshape(-1)
        if len(a):
            mask[a] = True
    queries = []
    lf = analysis.leaflets
    if lf is not None:
        if lf.kind in ("global", "local"):
            queries += [lf.membrane, lf.heads]
        elif lf.kind == "individual":
            queries += [lf.heads, lf.methyls]
        elif lf.kind in ("clustering", "spherical"):
            queries.append(lf.heads)
    mn = analysis.membrane_normal
    if mn.kind == "dynamic":
        queries.append(mn.heads)
    g = analysis.geometry
    if g is not None and isinstance(g.reference, str):
        queries.append(g.reference)
    for q in queries:
        if q:
            mask |= select_mask(system, q)
    sel = np.nonzero(mask)[0]
    # pad the wire width so near-identical configs share compiled shapes
    n_out = min(n, ((len(sel) + 255) // 256) * 256)
    subset = AtomSubset.from_indices(sel, n_out=max(n_out, len(sel)))
    slots = np.full(n, -1, np.int64)
    slots[sel] = np.arange(len(sel))

    def remap(idx):
        idx = np.asarray(idx)
        out = slots[idx.reshape(-1)].reshape(idx.shape)
        if (out < 0).any():  # pragma: no cover - internal invariant
            raise AssertionError(
                "internal error: device index outside the wire atom subset")
        return out.astype(np.int32)

    return subset, remap
# yaml field + section for each reference group name — common.rs:36-58
# get_hint; drives the EmptyGroup diagnostic below
_GROUP_HINTS = {
    "HeavyAtoms": ("heavy_atoms", "analysis_type"),
    "Hydrogens": ("hydrogens", "analysis_type"),
    "Beads": ("beads", "analysis_type"),
    "Membrane": ("membrane", "leaflets"),
    "Heads": ("heads", "leaflets"),
    "NormalHeads": ("heads", "membrane_normal"),
    "ClusterHeads": ("heads", "leaflets"),
    "Methyls": ("methyls", "leaflets"),
    "GeomReference": ("reference", "geometry"),
    "Saturated": ("saturated", "analysis_type"),
    "Unsaturated": ("unsaturated", "analysis_type"),
    "Ignore": ("ignore", "analysis_type"),
}


def _empty_group_error(group: str) -> TopologyError:
    """wording: src/errors.rs:65-66 (TopologyError::EmptyGroup) with the
    hint table of common.rs:36-58 get_hint."""
    if group in _GROUP_HINTS:
        yaml_name, yaml_type = _GROUP_HINTS[group]
        hint = (f"the query specified for '{yaml_name}' inside "
                f"'{yaml_type}' selects no atoms; is the query correct?")
    else:
        hint = "a query specifying the group selects no atoms"
    return TopologyError(f"group '{group}' is empty (hint: {hint})")


def _overlap_error(n: int, name1: str, query1: str, name2: str,
                   query2: str) -> TopologyError:
    """wording: src/errors.rs:68-76 (TopologyError::AtomsOverlap)."""
    return TopologyError(
        f"{n} atoms are part of both '{name1}' (query: '{query1}') and "
        f"'{name2}' (query: '{query2}')")


def _single_atom_per_molecule(system: System, kinds: List[MoleculeKind],
                              query: str, what: str) -> np.ndarray:
    """One atom index per molecule instance (e.g. leaflet head), ordered by
    global molecule id. Errors when a molecule has 0 or >1 matches."""
    mask = select_mask(system, query)
    heads = []
    for kind in kinds:
        rel = [r for r in range(kind.n_atoms_per_molecule)
               if mask[kind.min_indices[0] + r]]
        if len(rel) > 1:
            # wording: src/errors.rs:78-80 (TopologyError::MultipleHeads);
            # the index is the molecule's first atom (leaflets.rs
            # get_reference_head)
            raise TopologyError(
                f"molecule starting with atom index "
                f"'{kind.min_indices[0]}' contains multiple head group "
                f"atoms")
        if len(rel) == 0:
            # wording: src/errors.rs:82-84 (TopologyError::NoHead)
            raise TopologyError(
                f"molecule starting with atom index "
                f"'{kind.min_indices[0]}' contains no head group atom")
        heads.append(np.asarray(kind.min_indices, np.int64) + rel[0])
    return np.concatenate(heads) if heads else np.zeros(0, np.int64)


def _atoms_per_molecule(system: System, kinds: List[MoleculeKind],
                        query: str, what: str
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(atom_indices, molecule_ids) for ≥1-per-molecule selections
    (e.g. methyls)."""
    mask = select_mask(system, query)
    atoms, mols = [], []
    mol_offset = 0
    for kind in kinds:
        rel = [r for r in range(kind.n_atoms_per_molecule)
               if mask[kind.min_indices[0] + r]]
        if len(rel) == 0:
            # wording: src/errors.rs:86-88 (TopologyError::NoMethyl)
            raise TopologyError(
                f"molecule starting with atom index "
                f"'{kind.min_indices[0]}' contains no methyl group atom")
        for m, min_idx in enumerate(kind.min_indices):
            for r in rel:
                atoms.append(min_idx + r)
                mols.append(mol_offset + m)
        mol_offset += kind.n_molecules
    return np.asarray(atoms, np.int64), np.asarray(mols, np.int64)

def _prepare_bond_kinds(system: System, analysis: Analysis
                        ) -> Tuple[List[MoleculeKind], CompiledBonds]:
    at = analysis.analysis_type
    if at.kind == "cg":
        beads = select_mask(system, at.beads)
        if not beads.any():
            raise _empty_group_error("Beads")
        kinds = classify_molecules(system, beads, mode="bonds")
    else:
        heavy = select_mask(system, at.heavy_atoms)
        hydrogens = select_mask(system, at.hydrogens)
        if not heavy.any():
            raise _empty_group_error("HeavyAtoms")
        if not hydrogens.any():
            raise _empty_group_error("Hydrogens")
        overlap = heavy & hydrogens
        if overlap.any():
            raise _overlap_error(int(overlap.sum()), "HeavyAtoms",
                                 at.heavy_atoms, "Hydrogens", at.hydrogens)
        kinds = classify_molecules(system, heavy, hydrogens, mode="bonds")

    for kind in kinds:
        log.info("molecule type %s: %d molecules, %d bond types",
                 kind.name, kind.n_molecules, kind.n_bond_types)
    return kinds, (compile_bonds(kinds) if kinds else None)


def _empty_results(analysis: Analysis, system: System) -> AnalysisResults:
    """Atoms matched but nothing is analyzable: the reference finishes
    successfully with empty results and writes no output files
    (tests_cg.rs test_cg_order_no_molecules,
    tests_ua.rs test_ua_order_nothing_to_analyze)."""
    log.warning("no molecules to analyze — writing no output")
    return AnalysisResults(
        mode=analysis.analysis_type.kind,
        average_order=OrderCollection(),
        molecules=[],
        n_analyzed_frames=0,
        structure_path=str(analysis.structure),
        trajectory_paths=[str(t) for t in analysis.trajectory],
        analysis=analysis,
    )

def _prepare_geometry(system: System, analysis: Analysis):
    """(GeometrySpec, mode, payload) or (None, None, None).
    payload: the (3,) point for 'point', None for the box 'center' (taken
    per batch), or the atom indices of a selection whose center is the
    reference of each frame (gorder_tpu/engine/prepare.py:268-292)."""
    from ..core.geometry import build_geometry_spec

    spec = build_geometry_spec(analysis.geometry)
    if spec is None:
        return None, None, None
    ref = analysis.geometry.reference
    if ref is None:
        if not analysis.handle_pbc:
            # wording: src/errors.rs:42-43
            # (GeometryConfigError::InvalidBoxCenter)
            raise ConfigError(
                "cannot use dynamic center of simulation box as the "
                "reference position since periodic boundary conditions are "
                "ignored")
        return spec, "center", None
    if isinstance(ref, str):
        mask = select_mask(system, ref)
        if not mask.any():
            raise _empty_group_error("GeomReference")
        return spec, "selection", np.nonzero(mask)[0].astype(np.int32)
    return spec, "point", np.asarray(ref, np.float32)


def _prepare_ua_kinds(system: System, analysis: Analysis):
    """→ (kinds, CompiledUA or None): selections + classification +
    virtual-bond compilation shared by the run and merge paths."""
    from ..topology.ua import compile_ua
    from ..utils.timers import timers

    at = analysis.analysis_type
    n = system.n_atoms
    sat = select_mask(system, at.saturated) if at.saturated \
        else np.zeros(n, bool)
    unsat = select_mask(system, at.unsaturated) if at.unsaturated \
        else np.zeros(n, bool)
    ignore = select_mask(system, at.ignore) if at.ignore \
        else np.zeros(n, bool)
    if at.saturated and not sat.any():
        raise _empty_group_error("Saturated")
    if at.unsaturated and not unsat.any():
        raise _empty_group_error("Unsaturated")
    if (sat & unsat).any():
        raise _overlap_error(int((sat & unsat).sum()), "Saturated",
                             at.saturated, "Unsaturated", at.unsaturated)
    if at.ignore:
        if (sat & ignore).any():
            raise _overlap_error(int((sat & ignore).sum()), "Saturated",
                                 at.saturated, "Ignore", at.ignore)
        if (unsat & ignore).any():
            raise _overlap_error(int((unsat & ignore).sum()), "Unsaturated",
                                 at.unsaturated, "Ignore", at.ignore)
    satunsat = (sat | unsat) & ~ignore
    if not satunsat.any():
        # wording: src/errors.rs:104-105 (TopologyError::NoUACarbons)
        raise TopologyError(
            "no carbons for the calculation of united-atom order "
            "parameters were specified")

    with timers.phase("topology"):
        kinds = classify_molecules(system, satunsat, mode="atoms")
        if not kinds:
            return [], None
        compiled = compile_ua(system, kinds, sat, unsat, ignore)
    return kinds, compiled

