"""The per-mode drivers and the sharded entry points (port of
`gorder_tpu/engine/drivers.py`): AA, CG and UA order parameters with a
static, dynamic or manual membrane normal (with or without normals
export), overall and per leaflet (global, local, individual, clustering,
spherical and manual assignment), with or without ordermaps and geometry
selection; and a run split into contiguous frame shards, each run on its
own (`run_analysis_partial`, one process per GPU) and merged on the host
(`merge_partial_states`) into the single run's output, byte for byte.

Within one process a run splits each batch over every visible device by
frames (`parallel/context.py`, `GORDER_TPU_MESH`): `run_analysis` and
`run_analysis_partial` bracket the run with the frame mesh, and each
device of the mesh gets its own order or UA step
(gorder_tpu/engine/drivers.py:38-54, :258-283).

A partial state is the dict `gorder_tpu` writes: the same fingerprint,
the same keys and the same arrays, so that the states of the two packages
merge with each other. An ordermap's state is stored in `gorder_tpu`'s
four rows [l2, l1, l0, count], whose Σq = l2·16384 + l1·128 + l0: the
port writes [0, 0, Σq, count].
"""

from __future__ import annotations

import json
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
from ..io.traj import Trajectory
from ..parallel import context as mesh_context
from ..parallel.mesh import frame_mesh
from ..utils.timers import profiled_run, timers
from ..core.order import OrderAccumulator, make_order_step
from ..core.ordermap import build_map_spec
from ..core.ua import make_ua_step
from .batches import default_batch_size, run_batches
from .convert import convert_results, convert_results_ua
from .leaflet_runtime import build_leaflet_runtime
from .normals_runtime import _build_normals, _make_molecule_inside

log = logging.getLogger("gorder")


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise AnalysisError("device 'cuda' requested but no CUDA device is "
                            "available")
    return device


def _run(analysis, device, batch_size, on_batch, shard=None,
         as_partial=False):
    if analysis.analysis_type.kind in ("aa", "cg"):
        return _run_bond_based(analysis, device, batch_size, on_batch,
                               shard, as_partial)
    return _run_ua(analysis, device, batch_size, on_batch, shard,
                   as_partial)


def _meshed(device, batch_size, run):
    """`run(batch size)` with the run's frame mesh active."""
    if batch_size is None:
        batch_size = default_batch_size(device)
    mesh = mesh_context.activate(batch_size, device)
    if mesh is not None:
        log.info("data-parallel over %d devices ('frames' mesh)", mesh.size)
    try:
        with profiled_run():
            return run(batch_size)
    finally:
        mesh_context.deactivate()


def _mesh(device):
    """The active frame mesh, or a mesh of `device` alone."""
    return mesh_context.active_mesh() or frame_mesh([device])


def run_analysis(analysis, device, batch_size=None, on_batch=None):
    """Run `analysis` on `device` → AnalysisResults, in batches of
    `batch_size` frames (`batches.default_batch_size` by default).
    `on_batch` receives each batch's `batches.DeviceBatch`, one a device
    of the frame mesh (see `run_batches`)."""
    device = _check_device(device)
    results = _meshed(device, batch_size, lambda size: _run(
        analysis, device, size, on_batch))
    log.info("phase times: %s", timers.summary())
    return results


def run_analysis_partial(analysis, shard_index: int, shard_count: int,
                         device) -> dict:
    """Run shard `shard_index` of `shard_count`, a contiguous block of the
    analyzed frames, on `device` → its raw partial state, to be merged by
    `merge_partial_states` (gorder_tpu/engine/drivers.py:258-284)."""
    if not (0 <= shard_index < shard_count):
        raise AnalysisError(
            f"invalid shard {shard_index}/{shard_count}")
    device = _check_device(device)
    state = _meshed(device, None, lambda size: _run(
        analysis, device, size, None, shard=(shard_index, shard_count),
        as_partial=True))
    log.info("phase times: %s", timers.summary())
    return state


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


def _run_bond_based(analysis, device, batch_size: int, on_batch,
                    shard=None, as_partial=False):
    with timers.phase("prepare"):
        with timers.phase("structure"):
            system = load_structure(analysis)
        with timers.phase("topology"):
            kinds, compiled = _prepare_bond_kinds(system, analysis)
        if not kinds:
            return _empty_results(analysis, system)
        with timers.phase("atom_space"):
            space, remap = _build_atom_space(
                system, analysis, [compiled.atom_a, compiled.atom_b])
        with timers.phase("runtimes"):
            normal_vec, normals, leaflets, map_spec, geometry = _runtimes(
                system, analysis, kinds, compiled.n_molecules, remap, device)

        with timers.phase("steps"):
            atom_a, atom_b = remap(compiled.atom_a), remap(compiled.atom_b)
            geom_spec = geometry["geom_spec"]
            if (normals is not None and normals.collected is not None
                    and geom_spec is not None):
                normals.molecule_inside = _make_molecule_inside(
                    atom_a, atom_b, compiled.molecule, compiled.n_molecules,
                    geom_spec, analysis.handle_pbc, device)
            mesh = _mesh(device)
            steps = [make_order_step(atom_a, atom_b, compiled.bond_type,
                                     compiled.molecule, compiled.n_types,
                                     compiled.n_molecules,
                                     handle_pbc=analysis.handle_pbc,
                                     device=d,
                                     with_leaflets=leaflets is not None,
                                     normal_mode=("per_molecule" if normals
                                                  is not None else "static"),
                                     map_spec=map_spec, geom_spec=geom_spec)
                     for d in mesh.devices]
    with timers.phase("trajectory"):
        accum, traj, frame_indices, map_state, shard_start = run_batches(
            analysis, system, steps, normal_vec, compiled.n_types, space,
            (atom_a, atom_b), leaflets, compiled.n_molecules, mesh=mesh,
            normals=normals, map_spec=map_spec, batch_size=batch_size,
            on_batch=on_batch, shard=shard, **geometry)
    if as_partial:
        return _assemble_partial(analysis, kinds, compiled, accum,
                                 map_state, leaflets, normals, shard_start,
                                 len(frame_indices))
    with timers.phase("convert"):
        results = convert_results(analysis, system, kinds, compiled, accum,
                                  traj, frame_indices, map_spec, map_state)
    _attach_leaflet_data(results, analysis, kinds, leaflets)
    _attach_normals_data(results, analysis, kinds, normals)
    return results


def _run_ua(analysis, device, batch_size: int, on_batch, shard=None,
            as_partial=False):
    with timers.phase("prepare"):
        with timers.phase("structure"):
            system = load_structure(analysis)
        kinds, compiled = _prepare_ua_kinds(system, analysis)
        if not kinds or compiled is None:
            return _empty_results(analysis, system)
        for k, kind in enumerate(kinds):
            log.info("molecule type %s: %d molecules, %d analyzable atoms",
                     kind.name, kind.n_molecules, len(compiled.atom_specs[k]))
        atom_keys = ("target", "h1", "h2", "h3")
        with timers.phase("atom_space"):
            space, remap = _build_atom_space(
                system, analysis, [d[k] for d in compiled.categories.values()
                                   for k in atom_keys if k in d])
        with timers.phase("runtimes"):
            normal_vec, normals, leaflets, map_spec, geometry = _runtimes(
                system, analysis, kinds, compiled.n_molecules, remap, device)
        with timers.phase("steps"):
            categories = {
                cat: {k: (remap(v) if k in atom_keys else v)
                      for k, v in d.items()}
                for cat, d in compiled.categories.items()}
            mesh = _mesh(device)
            steps = [make_ua_step(categories, compiled.bond_type,
                                  compiled.bond_mol, compiled.n_types,
                                  handle_pbc=analysis.handle_pbc, device=d,
                                  with_leaflets=leaflets is not None,
                                  normal_mode=("per_molecule" if normals
                                               is not None else "static"),
                                  map_spec=map_spec,
                                  geom_spec=geometry["geom_spec"])
                     for d in mesh.devices]
    with timers.phase("trajectory"):
        accum, traj, frame_indices, map_state, shard_start = run_batches(
            analysis, system, steps, normal_vec, compiled.n_types, space,
            None, leaflets, compiled.n_molecules, mesh=mesh,
            normals=normals, map_spec=map_spec, batch_size=batch_size,
            on_batch=on_batch, shard=shard, **geometry)
    if as_partial:
        return _assemble_partial(analysis, kinds, compiled, accum,
                                 map_state, leaflets, normals, shard_start,
                                 len(frame_indices))
    with timers.phase("convert"):
        results = convert_results_ua(analysis, system, kinds, compiled,
                                     accum, traj, frame_indices, map_spec,
                                     map_state)
    _attach_leaflet_data(results, analysis, kinds, leaflets)
    _attach_normals_data(results, analysis, kinds, normals)
    return results


def _fingerprint(analysis, kinds, compiled, n_total: int) -> str:
    """The topology and request a partial state must share to merge, as
    `gorder_tpu` writes it (the same JSON)."""
    return json.dumps({
        "mode": analysis.analysis_type.kind,
        "kinds": [(k.name, int(k.n_molecules)) for k in kinds],
        "n_types": int(compiled.n_types),
        "type_offsets": [int(v) for v in compiled.type_offsets],
        "n_total_frames": int(n_total),
        "step": int(analysis.step),
        "with_leaflets": analysis.leaflets is not None,
        "with_errors": analysis.estimate_error is not None,
        "with_map": analysis.map is not None,
    }, sort_keys=True)


def _assemble_partial(analysis, kinds, compiled, accum, map_state, leaflets,
                      normals, shard_start: int, n_total: int) -> dict:
    """A shard's raw state: exact int64 sums, and every per-frame series
    of its block in frame order (gorder_tpu/engine/drivers.py:225-255)."""
    state = {
        "fingerprint": _fingerprint(analysis, kinds, compiled, n_total),
        "shard_start": int(shard_start),
        "n_shard_frames": int(accum.n_frames),
        "classes": list(accum.classes),
    }
    for cls in accum.classes:
        state[f"sums_{cls}"] = accum.sums[cls]
        state[f"counts_{cls}"] = accum.counts[cls]
        if accum.keep_timewise and accum.n_frames:
            tw_sums, tw_counts = accum.timewise(cls)
            state[f"tw_sums_{cls}"] = tw_sums
            state[f"tw_counts_{cls}"] = tw_counts
    if map_state is not None:
        for cls, arr in map_state.items():
            zero = np.zeros_like(arr[0])
            state[f"map_{cls}"] = np.stack([zero, zero, arr[0], arr[1]])
    if leaflets is not None and leaflets.collect_frames is not None:
        frames = leaflets.collect_frames
        if leaflets.manual_table is not None and not frames \
                and shard_start == 0:
            frames = list(leaflets.manual_table)
        if frames:
            state["leaflet_rows"] = np.stack(
                [np.asarray(f) for f in frames])
    if normals is not None and normals.collected:
        state["normals_rows"] = np.concatenate(normals.collected, axis=0)
    return state


def merge_partial_states(analysis, states):
    """Merge shard states (of this package or of `gorder_tpu`) into the
    AnalysisResults of the whole run, equal to a single run's: the int64
    sums add up exactly, and the per-frame series join in global frame
    order (gorder_tpu/engine/drivers.py:287-388). Host work only."""
    with timers.phase("structure"):
        system = load_structure(analysis)
    ua_mode = analysis.analysis_type.kind not in ("cg", "aa")
    if ua_mode:
        kinds, compiled = _prepare_ua_kinds(system, analysis)
    else:
        with timers.phase("topology"):
            kinds, compiled = _prepare_bond_kinds(system, analysis)
    if not kinds or compiled is None:
        return _empty_results(analysis, system)

    traj = Trajectory(analysis.trajectory, expected_atoms=system.n_atoms)
    frame_indices = traj.select_frames(
        analysis.begin if np.isfinite(analysis.begin) else None,
        analysis.end if np.isfinite(analysis.end) else None,
        analysis.step,
    )
    expected_fp = _fingerprint(analysis, kinds, compiled,
                               len(frame_indices))
    states = sorted(states, key=lambda s: int(s["shard_start"]))
    for s in states:
        if str(s["fingerprint"]) != expected_fp:
            raise AnalysisError(
                "partial state does not match this analysis (different "
                "topology, trajectory window, or request)")
    total = sum(int(s["n_shard_frames"]) for s in states)
    if total != len(frame_indices):
        raise AnalysisError(
            f"partial states cover {total} frames but the analysis "
            f"visits {len(frame_indices)} — shards missing or duplicated")

    classes = tuple(states[0]["classes"])
    keep_tw = analysis.estimate_error is not None
    accum = OrderAccumulator(compiled.n_types, classes,
                             keep_timewise=keep_tw)
    accum.n_frames = total
    for s in states:
        for cls in classes:
            accum.sums[cls] += np.asarray(s[f"sums_{cls}"], np.int64)
            accum.counts[cls] += np.asarray(s[f"counts_{cls}"], np.int64)
            if keep_tw and f"tw_sums_{cls}" in s:
                accum.timewise_sums[cls].append(
                    np.asarray(s[f"tw_sums_{cls}"], np.int64))
                accum.timewise_counts[cls].append(
                    np.asarray(s[f"tw_counts_{cls}"], np.int64))

    map_spec = (build_map_spec(analysis.map,
                               system.box if analysis.handle_pbc else None)
                if analysis.map is not None else None)
    map_state = None
    if map_spec is not None:
        n_seg = compiled.n_types * map_spec.ncells + 1
        map_state = {cls: np.zeros((2, n_seg), np.int64) for cls in classes}
        for s in states:
            for cls in classes:
                if f"map_{cls}" in s:
                    l2, l1, l0, counts = np.asarray(s[f"map_{cls}"],
                                                    np.int64)
                    map_state[cls] += np.stack(
                        [l2 * 16384 + l1 * 128 + l0, counts])

    with timers.phase("convert"):
        convert = convert_results_ua if ua_mode else convert_results
        results = convert(analysis, system, kinds, compiled, accum, traj,
                          frame_indices, map_spec, map_state)

    leaflet_rows = [row for s in states if "leaflet_rows" in s
                    for row in np.asarray(s["leaflet_rows"])]
    if leaflet_rows and analysis.leaflets is not None:
        results.leaflets_data = {
            "frames": leaflet_rows,
            "kinds": _bounds(kinds),
            "step": analysis.step,
            "frequency_n": (analysis.leaflets.frequency.n
                            if analysis.leaflets.frequency.kind == "every"
                            else 1),
        }
    normals_rows = [np.asarray(s["normals_rows"]) for s in states
                    if "normals_rows" in s]
    if normals_rows:
        results.normals_data = {
            "frames": np.concatenate(normals_rows, axis=0),
            "kinds": _bounds(kinds),
            "step": analysis.step,
        }
    return results
