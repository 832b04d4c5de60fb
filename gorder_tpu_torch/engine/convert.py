"""Results conversion: exact integer sums → the results tree (port of
`gorder_tpu/engine/convert.py:34-261` for bond-based and UA runs, with
their ordermaps). The numpy arithmetic is the JAX package's own; only the
accumulator and the int64 map state are this port's, and the result
classes are the shared ones.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from ..core.ordermap import aggregate_map, finalize_maps
from ..core.timewise import estimate_error, prefix_average
from ..errors import ErrorEstimationError
from ..results.model import (
    AnalysisResults,
    AtomDesc,
    AtomResults,
    BondResults,
    MoleculeResults,
    Order,
    OrderCollection,
)

log = logging.getLogger("gorder")

_SCALE = 1.0e6


def _fixed_order(sums: np.ndarray, counts: np.ndarray, min_samples: int,
                 sign: float) -> float:
    total_count = counts.sum()
    if total_count < max(min_samples, 1):
        return float("nan")
    return sign * float(sums.sum() / _SCALE / total_count)


class _Collector:
    """Order collections with optional errors and convergence, over
    global bond-type slices."""

    def __init__(self, analysis, accum, sign: float):
        self.accum = accum
        self.sign = sign
        self.min_samples = analysis.min_samples
        self.classes = accum.classes
        self.with_errors = analysis.estimate_error is not None
        self.n_blocks = (analysis.estimate_error.n_blocks
                         if self.with_errors else 0)
        self.timewise = {}
        if self.with_errors:
            if accum.n_frames < self.n_blocks:
                raise ErrorEstimationError(
                    f"read '{accum.n_frames}' trajectory frame(s) which is "
                    f"fewer than the number of blocks ('{self.n_blocks}')")
            for cls in self.classes:
                self.timewise[cls] = accum.timewise(cls)
            log.info(
                "error estimation: %d blocks of %d frames",
                self.n_blocks, accum.n_frames // max(self.n_blocks, 1))

    def collection(self, type_slice, *, for_average=False) -> OrderCollection:
        col = OrderCollection()
        ms = 1 if for_average else self.min_samples
        for cls in self.classes:
            value = _fixed_order(self.accum.sums[cls][type_slice],
                                 self.accum.counts[cls][type_slice],
                                 ms, self.sign)
            error = None
            if self.with_errors:
                if value != value:  # below min_samples → error is NaN too
                    error = float("nan")
                else:
                    fsums, fcounts = self.timewise[cls]
                    error = estimate_error(
                        fsums[:, type_slice].sum(axis=1),
                        fcounts[:, type_slice].sum(axis=1), self.n_blocks)
            setattr(col, cls, Order(value, error))
        return col

    def convergence(self, type_slice):
        if not self.with_errors:
            return None
        out = {}
        for cls in self.classes:
            fsums, fcounts = self.timewise[cls]
            out[cls] = self.sign * prefix_average(
                fsums[:, type_slice].sum(axis=1),
                fcounts[:, type_slice].sum(axis=1))
        return out


class _MapCollector:
    """Per-slice ordermap aggregation over the run's map
    (gorder_tpu/engine/convert.py:105-130): the drained {class: (2, S)
    int64} state."""

    def __init__(self, analysis, map_spec, map_state, n_types, sign):
        self.spec = map_spec
        self.enabled = map_spec is not None and map_state is not None
        if self.enabled:
            self.min_samples = analysis.map.min_samples
            self.sign = sign
            self.grids, self.raw = finalize_maps(
                map_state, n_types, map_spec, self.min_samples, sign)

    def for_types(self, type_indices) -> Optional[Dict[str, np.ndarray]]:
        if not self.enabled:
            return None
        idx = np.asarray(type_indices, np.int64).reshape(-1)
        return {cls: aggregate_map(self.raw[cls], idx, self.spec,
                                   self.min_samples, self.sign)
                for cls in self.raw}


def convert_results(analysis, system, kinds, compiled, accum, traj,
                    frame_indices: np.ndarray, map_spec=None,
                    map_state=None) -> AnalysisResults:
    mode = analysis.analysis_type.kind
    sign = -1.0 if mode in ("aa", "ua") else 1.0
    collector = _Collector(analysis, accum, sign)
    collection = collector.collection
    maps = _MapCollector(analysis, map_spec, map_state, compiled.n_types,
                         sign)

    molecules: List[MoleculeResults] = []
    for k, kind in enumerate(kinds):
        t0 = int(compiled.type_offsets[k])
        t1 = int(compiled.type_offsets[k + 1])
        mol = MoleculeResults(
            name=kind.name,
            average_order=collection(slice(t0, t1), for_average=True),
        )
        if collector.with_errors:
            mol.convergence = collector.convergence(slice(t0, t1))
        mol.average_maps = maps.for_types(np.arange(t0, t1))
        if mode == "cg":
            for t, bt in enumerate(kind.bond_types):
                mol.bonds.append(BondResults(
                    atom1=AtomDesc(bt.resname_a, bt.name_a, bt.rel_a),
                    atom2=AtomDesc(bt.resname_b, bt.name_b, bt.rel_b),
                    order=collection(slice(t0 + t, t0 + t + 1)),
                    maps=maps.for_types([t0 + t]),
                ))
        else:  # aa: group bond types by heavy atom (rel_a)
            by_heavy: Dict[int, List[int]] = {}
            for t, bt in enumerate(kind.bond_types):
                by_heavy.setdefault(bt.rel_a, []).append(t)
            for rel_a in sorted(by_heavy):
                ts = by_heavy[rel_a]
                bt0 = kind.bond_types[ts[0]]
                atom = AtomResults(
                    atom=AtomDesc(bt0.resname_a, bt0.name_a, rel_a),
                    order=collection(
                        np.asarray([t0 + t for t in ts], np.int64)),
                    maps=maps.for_types([t0 + t for t in ts]),
                )
                for t in ts:
                    bt = kind.bond_types[t]
                    atom.bonds.append(BondResults(
                        atom1=AtomDesc(bt.resname_a, bt.name_a, bt.rel_a),
                        atom2=AtomDesc(bt.resname_b, bt.name_b, bt.rel_b),
                        order=collection(slice(t0 + t, t0 + t + 1)),
                        maps=maps.for_types([t0 + t]),
                    ))
                mol.atoms.append(atom)
        molecules.append(mol)

    return _attach_maps(AnalysisResults(
        mode=mode,
        average_order=collection(slice(None), for_average=True),
        molecules=molecules,
        n_analyzed_frames=accum.n_frames,
        structure_path=analysis.structure,
        trajectory_paths=list(analysis.trajectory),
        frame_numbers=frame_indices,
        analysis=analysis,
    ), maps, analysis, compiled.n_types)


def _attach_maps(results, maps, analysis, n_types: int):
    """The system-wide maps and the map parameters, for the presenter."""
    if maps.enabled:
        results.average_maps = maps.for_types(np.arange(n_types))
        results.map_params = (analysis.map, maps.spec)
    return results


def convert_results_ua(analysis, system, kinds, compiled, accum, traj,
                       frame_indices: np.ndarray, map_spec=None,
                       map_state=None) -> AnalysisResults:
    """gorder_tpu/engine/convert.py:208-261: one entry per UA carbon, one
    bond per virtual hydrogen."""
    collector = _Collector(analysis, accum, sign=-1.0)
    collection = collector.collection
    maps = _MapCollector(analysis, map_spec, map_state, compiled.n_types,
                         -1.0)

    molecules: List[MoleculeResults] = []
    for k, kind in enumerate(kinds):
        t0 = int(compiled.type_offsets[k])
        t1 = int(compiled.type_offsets[k + 1])
        mol = MoleculeResults(
            name=kind.name,
            average_order=collection(slice(t0, t1), for_average=True),
        )
        if collector.with_errors:
            mol.convergence = collector.convergence(slice(t0, t1))
        mol.average_maps = maps.for_types(np.arange(t0, t1))
        for spec, base in zip(compiled.atom_specs[k],
                              compiled.atom_type_base[k]):
            atom = AtomResults(
                atom=AtomDesc(spec.resname, spec.name, spec.rel_index),
                order=collection(slice(base, base + spec.n_hydrogens)),
                maps=maps.for_types(
                    np.arange(base, base + spec.n_hydrogens)),
            )
            for h in range(spec.n_hydrogens):
                atom.bonds.append(BondResults(
                    atom1=AtomDesc(spec.resname, spec.name, spec.rel_index),
                    atom2=None,
                    virtual_index=h,
                    order=collection(slice(base + h, base + h + 1)),
                    maps=maps.for_types([base + h]),
                ))
            mol.atoms.append(atom)
        molecules.append(mol)

    return _attach_maps(AnalysisResults(
        mode="ua",
        average_order=collection(slice(None), for_average=True),
        molecules=molecules,
        n_analyzed_frames=accum.n_frames,
        structure_path=analysis.structure,
        trajectory_paths=list(analysis.trajectory),
        frame_numbers=frame_indices,
        analysis=analysis,
    ), maps, analysis, compiled.n_types)
