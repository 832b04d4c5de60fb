"""The per-mode drivers (port of `gorder_tpu/engine/drivers.py:38-207`):
AA, CG and UA order parameters with a static, dynamic or manual membrane
normal (with or without normals export), overall and per leaflet (global,
local, individual and manual assignment), with or without ordermaps and
geometry selection. The clustering leaflet methods raise `AnalysisError`
naming what is not ported yet; nothing falls back to the JAX package.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..engine.prepare import (
    _build_atom_space,
    _empty_results,
    _prepare_bond_kinds,
    _prepare_geometry,
    _prepare_ua_kinds,
    load_structure,
)
from ..errors import AnalysisError
from ..utils.timers import timers
from ..core.order import make_order_step
from ..core.ordermap import build_map_spec
from ..core.ua import make_ua_step
from .batches import DEFAULT_BATCH_SIZE, run_batches
from .convert import convert_results, convert_results_ua
from .leaflet_runtime import CLUSTERING_METHODS, build_leaflet_runtime
from .normals_runtime import _build_normals, _make_molecule_inside

log = logging.getLogger("gorder")


def _not_ported(analysis) -> list:
    """What this configuration needs that the port does not have yet."""
    missing = []
    if analysis.leaflets is not None \
            and analysis.leaflets.kind in CLUSTERING_METHODS:
        missing.append("leaflet classification by "
                       + CLUSTERING_METHODS[analysis.leaflets.kind])
    return missing


def run_analysis(analysis, device, batch_size: int = DEFAULT_BATCH_SIZE,
                 on_batch=None):
    """Run `analysis` on `device` → AnalysisResults. `on_batch` receives
    each batch's `batches.DeviceBatch` (see `run_batches`)."""
    missing = _not_ported(analysis)
    if missing:
        raise AnalysisError(
            "not yet ported to gorder_tpu_torch: " + ", ".join(missing))
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise AnalysisError("device 'cuda' requested but no CUDA device is "
                            "available")
    if analysis.analysis_type.kind in ("aa", "cg"):
        results = _run_bond_based(analysis, device, batch_size, on_batch)
    else:
        results = _run_ua(analysis, device, batch_size, on_batch)
    log.info("phase times: %s", timers.summary())
    return results


def _runtimes(system, analysis, kinds, n_molecules, remap, device):
    """→ (static (3,) normal or zeros, NormalsRuntime or None,
    LeafletRuntime or None, MapSpec or None, geometry): the membrane
    normals, the leaflets on the axis `_build_normals` gives them, the
    ordermap's grid over the structure's box, and the geometry's
    `run_batches` keywords, a selection's atoms remapped into slot space
    (gorder_tpu/engine/drivers.py:70-80)."""
    axis, normal_vec, normals = _build_normals(system, analysis, kinds,
                                               n_molecules, remap, device)
    leaflets = build_leaflet_runtime(system, analysis, kinds, n_molecules,
                                     axis, remap, device=device)
    if normal_vec is None:
        normal_vec = np.zeros(3, np.float32)
    map_spec = (build_map_spec(analysis.map,
                               system.box if analysis.handle_pbc else None)
                if analysis.map is not None else None)
    geom_spec, geom_mode, geom_payload = _prepare_geometry(system, analysis)
    if geom_mode == "selection":
        geom_payload = remap(geom_payload)
    geometry = dict(geom_spec=geom_spec, geom_mode=geom_mode,
                    geom_payload=geom_payload)
    return normal_vec, normals, leaflets, map_spec, geometry


def _bounds(kinds):
    """(name, first molecule, end) of each molecule kind."""
    bounds = []
    offset = 0
    for kind in kinds:
        bounds.append((kind.name, offset, offset + kind.n_molecules))
        offset += kind.n_molecules
    return bounds


def _attach_leaflet_data(results, analysis, kinds, leaflets) -> None:
    """The collected classes of an export run (gorder_tpu/engine/
    drivers.py:131-148): one row per assignment frame, 0 = upper."""
    if leaflets is None or leaflets.collect_frames is None:
        return
    frames = leaflets.collect_frames
    if leaflets.manual_table is not None and not frames:
        frames = list(leaflets.manual_table)
    results.leaflets_data = {
        "frames": frames,
        "kinds": _bounds(kinds),
        "step": analysis.step,
        "frequency_n": (leaflets.frequency.n
                        if leaflets.frequency.kind == "every" else 1),
    }


def _attach_normals_data(results, analysis, kinds, normals) -> None:
    """The normals an export run used, (frames, M, 3) in frame order
    (gorder_tpu/engine/drivers.py:116-128)."""
    if normals is None or normals.collected is None:
        return
    results.normals_data = {
        "frames": np.concatenate(normals.collected, axis=0),
        "kinds": _bounds(kinds),
        "step": analysis.step,
    }


def _run_bond_based(analysis, device, batch_size: int, on_batch):
    with timers.phase("structure"):
        system = load_structure(analysis)
    with timers.phase("topology"):
        kinds, compiled = _prepare_bond_kinds(system, analysis)
    if not kinds:
        return _empty_results(analysis, system)
    space, remap = _build_atom_space(system, analysis,
                                     [compiled.atom_a, compiled.atom_b])
    normal_vec, normals, leaflets, map_spec, geometry = _runtimes(
        system, analysis, kinds, compiled.n_molecules, remap, device)

    atom_a, atom_b = remap(compiled.atom_a), remap(compiled.atom_b)
    geom_spec = geometry["geom_spec"]
    if (normals is not None and normals.collected is not None
            and geom_spec is not None):
        normals.molecule_inside = _make_molecule_inside(
            atom_a, atom_b, compiled.molecule, compiled.n_molecules,
            geom_spec, analysis.handle_pbc, device)
    step = make_order_step(atom_a, atom_b, compiled.bond_type,
                           compiled.molecule, compiled.n_types,
                           compiled.n_molecules,
                           handle_pbc=analysis.handle_pbc, device=device,
                           with_leaflets=leaflets is not None,
                           normal_mode=("per_molecule" if normals is not None
                                        else "static"),
                           map_spec=map_spec, geom_spec=geom_spec)
    with timers.phase("trajectory"):
        accum, traj, frame_indices, map_state = run_batches(
            analysis, system, step, normal_vec, compiled.n_types, space,
            (atom_a, atom_b), leaflets, compiled.n_molecules, device=device,
            normals=normals, map_spec=map_spec, batch_size=batch_size,
            on_batch=on_batch, **geometry)
    with timers.phase("convert"):
        results = convert_results(analysis, system, kinds, compiled, accum,
                                  traj, frame_indices, map_spec, map_state)
    _attach_leaflet_data(results, analysis, kinds, leaflets)
    _attach_normals_data(results, analysis, kinds, normals)
    return results


def _run_ua(analysis, device, batch_size: int, on_batch):
    with timers.phase("structure"):
        system = load_structure(analysis)
    kinds, compiled = _prepare_ua_kinds(system, analysis)
    if not kinds or compiled is None:
        return _empty_results(analysis, system)
    for k, kind in enumerate(kinds):
        log.info("molecule type %s: %d molecules, %d analyzable atoms",
                 kind.name, kind.n_molecules, len(compiled.atom_specs[k]))
    atom_keys = ("target", "h1", "h2", "h3")
    space, remap = _build_atom_space(
        system, analysis, [d[k] for d in compiled.categories.values()
                           for k in atom_keys if k in d])
    categories = {
        cat: {k: (remap(v) if k in atom_keys else v) for k, v in d.items()}
        for cat, d in compiled.categories.items()}
    normal_vec, normals, leaflets, map_spec, geometry = _runtimes(
        system, analysis, kinds, compiled.n_molecules, remap, device)
    step = make_ua_step(categories, compiled.bond_type, compiled.bond_mol,
                        compiled.n_types, handle_pbc=analysis.handle_pbc,
                        device=device, with_leaflets=leaflets is not None,
                        normal_mode=("per_molecule" if normals is not None
                                     else "static"),
                        map_spec=map_spec, geom_spec=geometry["geom_spec"])
    with timers.phase("trajectory"):
        accum, traj, frame_indices, map_state = run_batches(
            analysis, system, step, normal_vec, compiled.n_types, space,
            None, leaflets, compiled.n_molecules, device=device,
            normals=normals, map_spec=map_spec, batch_size=batch_size,
            on_batch=on_batch, **geometry)
    with timers.phase("convert"):
        results = convert_results_ua(analysis, system, kinds, compiled,
                                     accum, traj, frame_indices, map_spec,
                                     map_state)
    _attach_leaflet_data(results, analysis, kinds, leaflets)
    _attach_normals_data(results, analysis, kinds, normals)
    return results
