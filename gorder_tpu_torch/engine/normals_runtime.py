"""Membrane normals at run time (port of
`gorder_tpu/engine/normals_runtime.py:25-266`): dynamic (per-molecule PCA)
normals, manual normal tables (from a file or an inline map), the axis
leaflet classification takes when the normal is not static, the
collection of the normals each batch used, for export, and the
molecule-inside mask that restricts that export to a geometry
(`_make_molecule_inside`). Reference parity notes cite
src/analysis/normal.rs and src/errors.rs per function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.geometry import inside_mask
from ..core.normals import DynamicNormals
from ..core.order import geometry_reference
from ..core.pbc import min_image
from ..errors import ConfigError, DynamicNormalError, ManualNormalError
from ..parallel.mesh import Replicas
from ..select import select_mask
from ..topology.classify import MoleculeKind
from .prepare import _AXIS_INDEX, _single_atom_per_molecule


@dataclass
class NormalsRuntime:
    """Per-batch membrane normals: dynamic PCA (`compute`) or a manual
    (F, M, 3) table. `collected` holds, for an export run, the (n, M, 3)
    normals each batch used, in frame order."""

    mode: str                             # 'dynamic' | 'manual'
    compute: Optional[DynamicNormals] = None
    table: Optional[np.ndarray] = None    # (F, M, 3) manual normals
    collected: Optional[List[np.ndarray]] = None
    # an export restricted to a geometry: (coords f32, box, geom_ref) →
    # (B, M) bool, True where the molecule has a bond inside the region.
    # The reference computes normals lazily per requesting bond
    # (normal.rs OnceCell), so a molecule with no analyzed bond exports
    # NaN.
    molecule_inside: Optional[Callable] = None

    def validate(self, n_analyzed: int) -> None:
        if self.mode == "manual" and len(self.table) != n_analyzed:
            # wording: src/errors.rs:226-228
            # (ManualNormalError::UnexpectedNumberOfFrames)
            raise ManualNormalError(
                f"number of frames specified in the normals structure "
                f"('{len(self.table)}') is not consistent with the number "
                f"of analyzed frames ('{n_analyzed}')")

    def fused(self) -> Optional[DynamicNormals]:
        """The dynamic computation, run with the step on the device where
        the batch carries what it reads; None for manual tables."""
        return self.compute if self.mode == "dynamic" else None

    def manual_for_batch(self, start: int, n_valid: int,
                         batch_size: int) -> np.ndarray:
        """The (B, M, 3) f32 table rows of analyzed frames start..start +
        n_valid, shipped beside the wire; padding rows are zero
        (gorder_tpu `normals_for_batch`)."""
        out = np.zeros((batch_size,) + self.table.shape[1:], np.float32)
        out[:n_valid] = self.table[start:start + n_valid]
        return out


def check_normal_guard(guard) -> None:
    """The ≥3-points check of dynamic normals, on the minimum cloud count
    over a batch's valid frames (a device scalar, read when the batch
    drains; wording: src/errors.rs:173-176, DynamicNormalError::
    NotEnoughPoints, as gorder_tpu/engine/fused.py:19-35 words it)."""
    got = float(guard)
    if got < 3:
        raise DynamicNormalError(
            f"not enough points for dynamic local membrane normal "
            f"calculation: got '{int(got)}', need at least '3' points \n"
            f"(hint: try increasing the 'radius' in the "
            f"'membrane_normal' section of your input configuration "
            f"file)")


def _make_molecule_inside(atom_a, atom_b, bond_mol, n_molecules: int,
                          geom_spec, handle_pbc: bool, device="cpu"):
    """(coords, box_diag, geom_ref) → (B, M) bool: the molecule has ≥ 1 bond
    midpoint inside the geometry (port of gorder_tpu/engine/
    normals_runtime.py:111-142). Like the JAX package, it takes the pair
    difference p_b − p_a of the f32 positions, not the order step's single
    rounding, and the reference of `core/order.py geometry_reference`."""
    def idx(a):
        return Replicas(torch.as_tensor(np.asarray(a, np.int32),
                                        device=device))

    aa, ab, mol = idx(atom_a), idx(atom_b), idx(bond_mol)

    def fn(coords, box_diag, geom_ref):
        here = coords.device
        pa = coords.index_select(1, aa.on(here))
        d = coords.index_select(1, ab.on(here)) - pa
        if handle_pbc:
            d = min_image(d, box_diag[:, None, :])
        ref = geometry_reference(coords, box_diag, geom_ref, handle_pbc)
        geo = inside_mask(pa + d * 0.5, ref, box_diag, geom_spec,
                          handle_pbc)
        out = torch.zeros((coords.shape[0], n_molecules), dtype=torch.int32,
                          device=coords.device)
        return out.index_add_(1, mol.on(here), geo.to(torch.int32)) > 0

    return fn


def _build_normals(system, analysis, kinds: List[MoleculeKind],
                   n_molecules: int, remap=None, device="cpu"):
    """→ (leaflet axis, static (3,) normal or None, NormalsRuntime or
    None)."""
    if remap is None:
        remap = lambda idx: idx  # noqa: E731 - identity for direct tests
    mn = analysis.membrane_normal
    if mn.kind == "static":
        axis = _AXIS_INDEX[mn.axis]
        normal_vec = np.zeros(3, np.float32)
        normal_vec[axis] = 1.0
        return axis, normal_vec, None

    # non-static normals: leaflet methods need their own axis
    axis = 2
    if analysis.leaflets is not None and analysis.leaflets.kind in (
            "global", "local", "individual"):
        if analysis.leaflets.membrane_normal is None:
            # wording: src/errors.rs:353-356
            # (ConfigError::MissingMembraneNormal)
            raise ConfigError(
                "static global membrane normal is not used but leaflet "
                "classification requires it\n(hint: add 'membrane_normal' "
                "to the 'leaflets' section of your input configuration "
                "file or, if analyzing a vesicle, \n assign the lipids into "
                "leaflets using the clustering method or manually)")
        axis = _AXIS_INDEX[analysis.leaflets.membrane_normal]

    runtime = NormalsRuntime(mode="dynamic" if mn.kind == "dynamic"
                             else "manual")
    if mn.collect.enabled:
        runtime.collected = []

    if mn.kind == "dynamic":
        heads = _single_atom_per_molecule(system, kinds, mn.heads,
                                          "dynamic membrane normal heads")
        cloud = np.nonzero(select_mask(system, mn.heads))[0]
        runtime.compute = DynamicNormals(remap(heads), remap(cloud),
                                         mn.radius, analysis.handle_pbc,
                                         device=device)
        return axis, None, runtime

    # manual normals (from file or inline map)
    if mn.kind == "from_file":
        import yaml as _yaml

        try:
            with open(mn.file) as fh:
                mapping = _yaml.safe_load(fh)
        except OSError:
            # wording: src/errors.rs:201-202 (ManualNormalError::FileNotFound)
            raise ManualNormalError(
                f"could not open the normals file '{mn.file}'") from None
        except _yaml.YAMLError as e:
            # wording: src/errors.rs:204-205
            # (ManualNormalError::CouldNotParse)
            raise ManualNormalError(
                f"could not understand the contents of the normals file "
                f"'{mn.file}' ({e})") from None
    else:
        mapping = mn.normals_map
    runtime.table = _manual_normals_table(mapping, kinds)
    return axis, None, runtime


def _manual_normals_table(mapping, kinds: List[MoleculeKind]) -> np.ndarray:
    if not isinstance(mapping, dict):
        raise ManualNormalError(
            "manual membrane normals must map molecule types to per-frame "
            "per-molecule vectors")
    known = {kind.name for kind in kinds}
    extra = [name for name in mapping if name not in known]
    if extra:
        # wording: src/errors.rs:222-224
        # (ManualNormalError::UnknownMoleculeType)
        detected = " ".join(kind.name for kind in kinds)
        raise ManualNormalError(
            f"molecule type '{extra[0]}' specified in the normals "
            f"structure not found in the system (detected molecule types "
            f"are: '{detected}')")
    n_frames = None
    per_kind = []
    for kind in kinds:
        if kind.name not in mapping:
            # wording: src/errors.rs:207-208
            # (ManualNormalError::MoleculeTypeNotFound)
            raise ManualNormalError(
                f"molecule type '{kind.name}' not found in the manual "
                f"normals structure")
        frames = mapping[kind.name]
        if not frames:  # `NAME:` with no value parses as None
            # wording: src/errors.rs:210-211 (ManualNormalError::NoNormals)
            raise ManualNormalError(
                f"no membrane normals provided for molecule type "
                f"'{kind.name}'")
        if n_frames is None:
            n_frames = len(frames)
        elif len(frames) != n_frames:
            raise ManualNormalError(
                "inconsistent frame counts between molecule types in the "
                "manual membrane normals")
        rows = []
        for fidx, frame in enumerate(frames):
            if len(frame) != kind.n_molecules:
                # wording: src/errors.rs:213-220
                # (ManualNormalError::InconsistentNumberOfMolecules)
                raise ManualNormalError(
                    f"inconsistent number of molecules specified in the "
                    f"normals structure: expected '{kind.n_molecules}' "
                    f"molecules of type '{kind.name}', got '{len(frame)}' "
                    f"molecules in frame '{fidx}'")
            rows.append(np.asarray(frame, np.float32))
        per_kind.append(np.stack(rows))
    if not n_frames:
        raise ManualNormalError("the manual membrane normals are empty")
    return np.concatenate(per_kind, axis=1)
