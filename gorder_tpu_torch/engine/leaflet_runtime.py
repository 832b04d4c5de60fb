"""Leaflet assignment at run time (port of
`gorder_tpu/engine/leaflet_runtime.py`): per-batch classification with
frequency gating and carried state, the manual tables (file, map, NDX),
flip, collection for export, and the predicates that decide which decoder
side channel a run can ride (`engine/channels.py`).

Reference behavior: src/analysis/leaflets.rs, src/input/frequency.rs:13-55
and the error wordings of src/errors.rs cited per function. The
clustering methods (spectral and spherical, `core/clustering.py`) classify
every atom that matches the heads query, and `cloud_to_mol` picks each
analyzed molecule's head from that cloud; spectral cluster labels are
oriented into leaflets frame after frame on the host (`SpectralOrienter`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..core.clustering import (
    SpectralOrienter,
    make_spectral_labels,
    make_spherical_classifier,
)
from ..core.leaflets import (
    GlobalClassifier,
    IndividualClassifier,
    LocalClassifier,
)
from ..errors import (
    AnalysisError,
    ManualLeafletError,
    NdxLeafletError,
    TopologyError,
)
from ..parallel.mesh import Replicas
from ..select import select_mask
from ..topology.classify import MoleculeKind
from .prepare import (
    _AXIS_INDEX,
    _atoms_per_molecule,
    _empty_group_error,
    _single_atom_per_molecule,
)

log = logging.getLogger("gorder")


def _flipped(fn):
    """`fn` with upper and lower swapped (the `flip` option)."""
    def flipped(*args):
        return 1 - fn(*args)

    return flipped


@dataclass
class LeafletRuntime:
    """Per-batch leaflet assignment with frequency gating. `classify` is a
    classifier of `core/leaflets.py`, or None for a manual table."""

    classify: object = None
    frequency: object = None
    manual_table: Optional[np.ndarray] = None   # (n_assignment_frames, M)
    manual_source: str = "manual"               # 'manual' | 'ndx'
    carried: Optional[np.ndarray] = None        # (M,) last assignment
    n_molecules: int = 0
    collect_frames: Optional[List[np.ndarray]] = None  # per assignment frame
    kinds: Optional[List[MoleculeKind]] = None
    flip: bool = False
    # spectral clustering: raw cluster labels → leaflets, frame by frame
    orienter: Optional[SpectralOrienter] = None
    # clustering methods classify every atom matching the heads query (the
    # reference's ClusterHeads group spans the whole system, not just the
    # analyzed molecules); the cloud position of each analyzed molecule
    cloud_to_mol: Optional[np.ndarray] = None
    device: object = "cpu"                      # where `classify` runs
    _logged_stats: bool = False

    def log_first_stats(self, classes: np.ndarray) -> None:
        """First-assignment-frame leaflet populations
        (reference: topology/mod.rs:178-225)."""
        if self._logged_stats or self.kinds is None:
            return
        self._logged_stats = True
        offset = 0
        for kind in self.kinds:
            chunk = classes[offset:offset + kind.n_molecules]
            log.info(
                "leaflet assignment (first frame): %s: %d upper, %d lower",
                kind.name, int((chunk == 0).sum()), int((chunk == 1).sum()))
            offset += kind.n_molecules

    def assignment_source(self, analyzed_idx: np.ndarray) -> np.ndarray:
        """The analyzed frame whose assignment each analyzed frame uses."""
        if self.frequency.kind == "once":
            return np.zeros_like(analyzed_idx)
        n = self.frequency.n
        return (analyzed_idx // n) * n

    def validate(self, n_analyzed: int) -> None:
        """Manual assignments must cover every assignment frame
        (reference: validate_run, topology/mod.rs:148-155)."""
        if self.manual_table is None:
            return
        if self.frequency.kind == "once":
            expected = 1
        else:
            expected = (n_analyzed + self.frequency.n - 1) // self.frequency.n
        if len(self.manual_table) != expected:
            n = len(self.manual_table)
            freq = self.frequency.describe()
            if self.manual_source == "ndx":
                # wording: src/errors.rs:471-480
                # (NdxLeafletClassificationError::UnexpectedNumberOfNdxFiles)
                raise NdxLeafletError(
                    f"number of ndx files provided ('{n}') is not "
                    f"consistent with the number of analyzed frames "
                    f"('{n_analyzed}')\n(leaflet assignment was supposed to "
                    f"be performed {freq}, therefore there should be "
                    f"exactly '{expected}' ndx file(s) provided)")
            # wording: src/errors.rs:512-521
            # (ManualLeafletClassificationError::UnexpectedNumberOfFrames)
            raise ManualLeafletError(
                f"number of frames specified in the leaflet assignment "
                f"structure ('{n}') is not consistent with the number of "
                f"analyzed frames ('{n_analyzed}')\n(leaflet assignment was "
                f"supposed to be performed {freq}, therefore there should "
                f"be exactly '{expected}' frame(s) specified in the leaflet "
                f"assignment structure)")

    def _every_frame(self) -> bool:
        return self.frequency.kind == "every" and self.frequency.n == 1

    def fused_classify(self):
        """(coords f32, box) → (B, M) classes, flip applied, when the
        classes are a pure function of each batch (global, local,
        individual or spherical at every-frame frequency) and so are
        computed with the order step on the device; else None
        (frequency-gated methods carry state, spectral labels are oriented
        frame after frame and manual tables are host data:
        `classes_for_batch`)."""
        if (self.classify is None or self.orienter is not None
                or not self._every_frame()):
            return None
        classify = self.classify
        if self.cloud_to_mol is not None:
            cloud = classify
            pick = Replicas(torch.as_tensor(
                np.asarray(self.cloud_to_mol, np.int64), device=self.device))

            def classify(coords, box_diag):
                return cloud(coords, box_diag).index_select(
                    1, pick.on(coords.device))
        return _flipped(classify) if self.flip else classify

    def fused_channel(self):
        """((heads f32, cog, box) → classes, (membrane slots, head slots,
        axis)) when this run's classes can ride the b7 wire's decoder side
        channels — global method, every-frame frequency, PBC on — else
        None. Collection does not disqualify: the run collects the classes
        it computed."""
        if self.fused_classify() is None:
            return None
        if not isinstance(self.classify, GlobalClassifier):
            return None
        membrane, heads, axis, handle_pbc = self.classify.channel_info
        if not handle_pbc:
            return None
        ch = self.classify.channel
        return (_flipped(ch) if self.flip else ch,
                (np.asarray(membrane, np.int32), np.asarray(heads, np.int32),
                 int(axis)))

    def plane_eligible(self) -> bool:
        """True when this run's classes can ride the b7 wire as a host
        (B, M) class plane: manual tables (pure host data) or
        frequency-gated classification (`!once` / `!every N`: classes are
        computed on assignment frames only, whose coordinates are read
        sparsely, and carried between them; src/input/frequency.rs:13-55)."""
        if self.manual_table is not None:
            return True
        return self.classify is not None and not self._every_frame()

    def channel_coords_info(self):
        """((coords f32, cog, box) → classes, flip applied, (membrane slots,
        axis)) when this run's classification compares against the
        decoder's per-frame membrane center — global method, every-frame
        frequency, PBC on — else None. Every wire of such a run classifies
        against the same center, so output is identical across wires."""
        if (self.manual_table is not None or not self._every_frame()
                or not isinstance(self.classify, GlobalClassifier)):
            return None
        membrane, _heads, axis, handle_pbc = self.classify.channel_info
        if not handle_pbc:
            return None
        ch = self.classify.channel_coords
        return (_flipped(ch) if self.flip else ch,
                (np.asarray(membrane, np.int32), int(axis)))

    def classes_for_batch(self, coords, box, analyzed_idx: np.ndarray,
                          rows=None) -> np.ndarray:
        """(n, M) int32 classes for the n analyzed frames of a batch, with
        carried state, flip and collection.

        coords: (B, A, 3) f32 tensor of the batch, or with `rows` only
        those rows of it (the sparse assignment-frame read of the b7 class
        plane), or None when no frame of the batch assigns. box: the
        batch's (B, 3) tensor. (The decoder-COG channel class classifies
        every frame, so its classes never come through here.)"""
        src = self.assignment_source(analyzed_idx)
        is_assign = src == analyzed_idx
        if self.manual_table is not None:
            if self.frequency.kind == "once":
                table_idx = np.zeros_like(src)
            else:
                table_idx = src // self.frequency.n
            classes = self.manual_table[table_idx]
        elif coords is None and not is_assign.any() \
                and self.carried is not None:
            # a class-plane batch with no assignment frame (frequency
            # block longer than the batch): every row inherits the carried
            # assignment
            classes = np.tile(self.carried[None, :], (len(analyzed_idx), 1))
        else:
            batch_start = analyzed_idx[0]
            if rows is not None:
                got = self.classify(coords, box[torch.as_tensor(
                    rows, device=box.device)]).cpu().numpy()
                assigned = np.zeros((len(analyzed_idx), got.shape[1]),
                                    np.int32)
                assigned[rows] = got
            else:
                assigned = self.classify(coords, box).cpu().numpy()
            if self.orienter is not None:
                # cluster identities are resolved frame after frame
                # (clustering.rs classify_by_match)
                for i in np.nonzero(is_assign)[0]:
                    assigned[i] = self.orienter.orient(assigned[i])
            in_batch = src >= batch_start
            local = np.clip(src - batch_start, 0, len(analyzed_idx) - 1)
            classes = np.where(
                in_batch[:, None], assigned[local],
                (self.carried if self.carried is not None
                 else assigned[0])[None, :],
            )
            # carry the last assignment frame <= batch end
            if is_assign.any():
                last = np.nonzero(is_assign)[0][-1]
                self.carried = assigned[last]
        if self.cloud_to_mol is not None:
            classes = classes[:, self.cloud_to_mol]
        if self.flip:
            classes = 1 - classes
        if self.collect_frames is not None:
            for i in np.nonzero(is_assign)[0]:
                self.collect_frames.append(classes[i].astype(np.int32))
        if len(classes):
            self.log_first_stats(np.asarray(classes[0]))
        return classes.astype(np.int32)


def _require_cluster_atoms(n_atoms: int) -> None:
    """Clustering needs at least two head atoms
    (leaflets.rs:103-113 NotEnoughAtomsToCluster)."""
    if n_atoms < 2:
        raise TopologyError(
            f"clustering leaflet classification has been requested but "
            f"only '{n_atoms}' headgroup atom has been provided; need at "
            f"least '2' atoms")


def _cluster_head_cloud(system, kinds: List[MoleculeKind], query: str):
    """Clustering operates on every atom matching the heads query (the
    reference's ClusterHeads group spans the whole system: clustering.rs
    create_similarity_matrix iterates the raw group), while each analyzed
    molecule takes the cluster of its own head. → (cloud atom indices, the
    cloud position of each analyzed molecule's head)."""
    cloud = np.nonzero(select_mask(system, query))[0].astype(np.int64)
    heads = _single_atom_per_molecule(system, kinds, query, "cluster heads")
    mol_pos = np.searchsorted(cloud, heads)
    if not np.array_equal(cloud[mol_pos], heads):  # pragma: no cover
        raise TopologyError(
            "internal error: analyzed molecule heads missing from the "
            "cluster head cloud")
    return cloud, mol_pos


def build_leaflet_runtime(system, analysis, kinds: List[MoleculeKind],
                          n_molecules: int, normal_axis: int, remap=None,
                          device="cpu") -> Optional[LeafletRuntime]:
    """The run's LeafletRuntime (None without leaflets), its classifier's
    index arrays remapped into the decoded atom space and placed on
    `device`."""
    params = analysis.leaflets
    if params is None:
        return None
    if remap is None:
        remap = lambda idx: idx  # noqa: E731 - identity for direct tests
    axis = normal_axis
    if params.membrane_normal is not None:
        axis = _AXIS_INDEX[params.membrane_normal]

    runtime = LeafletRuntime(device=device)
    runtime.frequency = params.frequency
    runtime.n_molecules = n_molecules
    runtime.kinds = kinds
    runtime.flip = params.flip
    if params.collect.enabled:
        runtime.collect_frames = []

    if params.kind in ("global", "local"):
        membrane_mask = select_mask(system, params.membrane)
        if not membrane_mask.any():
            raise _empty_group_error("Membrane")
        membrane_idx = np.nonzero(membrane_mask)[0]
        heads = _single_atom_per_molecule(system, kinds, params.heads,
                                          "leaflet heads")
        if params.kind == "global":
            runtime.classify = GlobalClassifier(
                remap(membrane_idx), remap(heads), axis, analysis.handle_pbc,
                device=device)
        else:
            runtime.classify = LocalClassifier(
                remap(membrane_idx), remap(heads), axis, params.radius,
                analysis.handle_pbc, device=device)
    elif params.kind == "individual":
        heads = _single_atom_per_molecule(system, kinds, params.heads,
                                          "leaflet heads")
        methyls, methyl_mols = _atoms_per_molecule(system, kinds,
                                                   params.methyls, "methyls")
        runtime.classify = IndividualClassifier(
            remap(heads), remap(methyls), methyl_mols, n_molecules, axis,
            analysis.handle_pbc, device=device)
    elif params.kind in ("from_file", "from_map"):
        if params.kind == "from_file":
            import yaml as _yaml

            try:
                with open(params.file) as fh:
                    assignment = _yaml.safe_load(fh)
            except OSError:
                # wording: src/errors.rs:486-487
                # (ManualLeafletClassificationError::FileNotFound)
                raise ManualLeafletError(
                    f"could not open the leaflet assignment file "
                    f"'{params.file}'") from None
            except _yaml.YAMLError as e:
                # wording: src/errors.rs:489-490
                # (ManualLeafletClassificationError::CouldNotParse)
                raise ManualLeafletError(
                    f"could not understand the contents of the leaflet "
                    f"assignment file '{params.file}' ({e})") from None
        else:
            assignment = params.assignment
        runtime.manual_table = _manual_leaflet_table(assignment, kinds)
    elif params.kind == "from_ndx":
        runtime.manual_table = _ndx_leaflet_table(system, kinds, params)
        runtime.manual_source = "ndx"
    elif params.kind in ("clustering", "spherical"):
        cloud, mol_pos = _cluster_head_cloud(system, kinds, params.heads)
        _require_cluster_atoms(len(cloud))
        if params.kind == "clustering":
            runtime.classify = make_spectral_labels(
                remap(cloud), analysis.handle_pbc, device=device)
            runtime.orienter = SpectralOrienter(cloud)
        else:
            runtime.classify = make_spherical_classifier(
                remap(cloud), analysis.handle_pbc, device=device)
        runtime.cloud_to_mol = mol_pos
    else:
        raise AnalysisError(
            f"leaflet classification method '{params.kind}' is not yet "
            f"supported")
    return runtime


def _manual_leaflet_table(assignment, kinds: List[MoleculeKind]) -> np.ndarray:
    """{moltype: [per-assignment-frame [1/0 or Upper/Lower per molecule]]}
    → (n_assignment_frames, M) classes (0 = upper, 1 = lower)."""
    if not isinstance(assignment, dict):
        raise ManualLeafletError(
            "manual leaflet assignment must map molecule types to per-frame "
            "assignments")

    def to_class(value):
        if value in (1, "1", "Upper", "upper"):
            return 0
        if value in (0, "0", "Lower", "lower"):
            return 1
        raise ManualLeafletError(
            f"invalid leaflet value '{value}' in the manual assignment")

    known = {kind.name for kind in kinds}
    extra = [name for name in assignment if name not in known]
    if extra:
        # wording: src/errors.rs:523-525
        # (ManualLeafletClassificationError::UnknownMoleculeType)
        detected = " ".join(kind.name for kind in kinds)
        raise ManualLeafletError(
            f"molecule type '{extra[0]}' specified in the leaflet "
            f"assignment structure not found in the system (detected "
            f"molecule types are: '{detected}')")

    n_frames = None
    per_kind = []
    for kind in kinds:
        if kind.name not in assignment:
            # wording: src/errors.rs:492-493
            # (ManualLeafletClassificationError::MoleculeTypeNotFound)
            raise ManualLeafletError(
                f"molecule type '{kind.name}' not found in the leaflet "
                f"assignment structure")
        frames = assignment[kind.name]
        if not frames:  # `NAME:` with no value parses as None
            # wording: src/errors.rs:509-510
            # (ManualLeafletClassificationError::EmptyAssignment)
            raise ManualLeafletError(
                f"no leaflet assignment data provided for molecule type "
                f"'{kind.name}'")
        if n_frames is None:
            n_frames = len(frames)
        elif len(frames) != n_frames:
            raise ManualLeafletError(
                "inconsistent number of assignment frames between molecule "
                "types in the manual leaflet assignment")
        rows = []
        for fidx, frame in enumerate(frames):
            if len(frame) != kind.n_molecules:
                # wording: src/errors.rs:500-507
                # (ManualLeafletClassificationError::
                #  InconsistentNumberOfMolecules)
                raise ManualLeafletError(
                    f"inconsistent number of molecules specified in the "
                    f"leaflet assignment: expected '{kind.n_molecules}' "
                    f"molecules of type '{kind.name}', got '{len(frame)}' "
                    f"molecules in assignment frame '{fidx}'")
            rows.append([to_class(v) for v in frame])
        per_kind.append(np.asarray(rows, np.int32))
    if n_frames is None or n_frames == 0:
        raise ManualLeafletError("the manual leaflet assignment is empty")
    return np.concatenate(per_kind, axis=1)


def _ndx_leaflet_table(system, kinds: List[MoleculeKind],
                       params) -> np.ndarray:
    """One NDX file per assignment frame; heads in the upper/lower groups
    decide each molecule's leaflet (leaflets.rs FromNdx)."""
    from ..errors import NdxError
    from ..io.ndx import parse_ndx

    heads = _single_atom_per_molecule(system, kinds, params.heads,
                                      "leaflet heads")
    rows = []
    for path in params.ndx:
        try:
            with open(path) as fh:
                groups = parse_ndx(fh.read(), system.n_atoms, path,
                                   protected=(params.upper_leaflet,
                                              params.lower_leaflet))
        except OSError as e:
            raise NdxLeafletError(
                f"could not read leaflet ndx file '{path}': {e}") from None
        except NdxError as e:
            raise NdxLeafletError(str(e)) from None
        # wording: src/errors.rs:461-463
        # (NdxLeafletClassificationError::GroupNotFound)
        if params.upper_leaflet not in groups:
            raise NdxLeafletError(
                f"group '{params.upper_leaflet}' for selecting "
                f"upper-leaflet molecules was not found in the ndx file "
                f"'{path}'")
        if params.lower_leaflet not in groups:
            raise NdxLeafletError(
                f"group '{params.lower_leaflet}' for selecting "
                f"lower-leaflet molecules was not found in the ndx file "
                f"'{path}'")
        upper = set(groups[params.upper_leaflet].tolist())
        lower = set(groups[params.lower_leaflet].tolist())
        row = np.zeros(len(heads), np.int32)
        for m, head in enumerate(heads):
            # upper is checked first and wins on overlap
            # (leaflets.rs:1152-1170 assign_molecule)
            if int(head) in upper:
                row[m] = 0
            elif int(head) in lower:
                row[m] = 1
            else:
                # wording: src/errors.rs:465-469
                # (NdxLeafletClassificationError::AssignmentNotFound)
                raise NdxLeafletError(
                    f"could not find leaflet assignment for molecule index "
                    f"'{m}' (head index '{int(head)}')\n(hint: head "
                    f"identifier index '{int(head)}' is missing from both "
                    f"specified ndx groups)")
        rows.append(row)
    if not rows:
        raise NdxLeafletError("no ndx files given for leaflet assignment")
    return np.stack(rows)
