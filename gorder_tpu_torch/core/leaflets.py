"""Leaflet classifiers on tensors (port of `gorder_tpu/core/leaflets.py`).

Behavioral reference: src/analysis/leaflets.rs. The device-side methods
(global, local, individual) are per-frame functions over a batch of
coordinates on whatever device the tensors lie on; the manual methods
(from file, map or NDX) are host tables (`engine/leaflet_runtime.py`).
The clustering methods are not ported yet.

Classes are int32: 0 = upper, 1 = lower (the reference's Leaflet enum).
Frequency gating (`once`, `every N`) is the caller's: a classifier
returns classes for every frame it is given.

Each classifier holds its index arrays on `device`, and a replica on any
other device it is called on (`parallel/mesh.py Replicas`, for a run
split over several devices), and is called with (B, A, 3) f32
coordinates and (B, 3) box lengths → (B, M) int32 classes.
The sums the local and global centers take reduce in another order than
XLA's, so centers agree with the JAX package to float noise and the
classes agree wherever a head is not within that noise of its center.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.neighbors import MAX_ELEMENTS, local_sums, local_sums_plain
from ..parallel.mesh import Replicas
from .pbc import circular_mean_cog, naive_cog


def _idx(a, device) -> Replicas:
    return Replicas(torch.as_tensor(np.ascontiguousarray(a, np.int64),
                                    device=device))


def _sidedness(delta: torch.Tensor, length, handle_pbc: bool):
    """0 where the min-imaged `delta` ≥ 0 (upper), else 1 (lower)."""
    if handle_pbc:
        delta = delta - length * torch.round(delta / length)
    return torch.where(delta >= 0, 0, 1).to(torch.int32)


class GlobalClassifier:
    """Global method: each head above or below the whole membrane's center
    of geometry along the normal axis."""

    def __init__(self, membrane_indices, head_indices, normal_axis: int,
                 handle_pbc: bool = True, device="cpu"):
        self.membrane = _idx(membrane_indices, device)
        self.heads = _idx(head_indices, device)
        self.axis = int(normal_axis)
        self.handle_pbc = bool(handle_pbc)
        # (membrane slots, head slots, axis, pbc) for the decoder channels
        self.channel_info = (np.asarray(membrane_indices, np.int64),
                             np.asarray(head_indices, np.int64),
                             self.axis, self.handle_pbc)

    def _length(self, box_diag):
        return box_diag[:, None, self.axis]

    def __call__(self, coords, box_diag):
        """Against a center computed here (gorder_tpu `impl`)."""
        membrane = coords.index_select(
            1, self.membrane.on(coords.device))                # (B, Nm, 3)
        ones = torch.ones(membrane.shape[:-1], dtype=coords.dtype,
                          device=coords.device)
        if self.handle_pbc:
            center = circular_mean_cog(membrane, ones, box_diag)
        else:
            center = naive_cog(membrane, ones)
        heads = coords.index_select(
            1, self.heads.on(coords.device))                   # (B, M, 3)
        delta = heads[..., self.axis] - center[:, None, self.axis]
        return _sidedness(delta, self._length(box_diag), self.handle_pbc)

    def channel(self, heads, cog, box_diag):
        """From the b7 wire's side channels (gorder_tpu `channel_impl`):
        heads (B, M, 3) f32 absolute positions, bit-identical to a
        coordinate gather, and cog (B,) f32, the decoder's refined
        Bai-Breen membrane center along the axis (native/xdr.cpp
        bai_breen_axis)."""
        delta = heads[..., self.axis] - cog[:, None]
        return _sidedness(delta, self._length(box_diag), self.handle_pbc)

    def channel_coords(self, coords, cog, box_diag):
        """Full coordinates + the decoder's COG channel (gorder_tpu
        `channel_coords_impl`): every wire classifies against the same
        per-frame center, so the output is identical across wires."""
        return self.channel(
            coords.index_select(1, self.heads.on(coords.device)), cog,
            box_diag)


class LocalClassifier:
    """Local method: each head against the center of geometry of the
    membrane atoms within an in-plane cylinder of `radius` around it.

    The weighted sums the center comes from are `ops/neighbors.py
    local_sums`: on the card one launch of its kernel a call, which writes
    no (frames, M, Nm) pair; on the CPU its plain version, whose working
    set is (frames, M, Nm) per chunk, so frames go in chunks of at most
    `max_elements` pairs, as the JAX package maps over single frames to
    bound it."""

    def __init__(self, membrane_indices, head_indices, normal_axis: int,
                 radius: float, handle_pbc: bool = True, device="cpu",
                 max_elements: int = MAX_ELEMENTS):
        self.membrane = _idx(membrane_indices, device)
        self.heads = _idx(head_indices, device)
        self.axis = int(normal_axis)
        self.radius = float(np.float32(radius))
        self.handle_pbc = bool(handle_pbc)
        self.max_elements = int(max_elements)

    def _classify(self, coords, box_diag, sums_of):
        """The classes from the sums `sums_of` gives (the wrapper or the
        plain version): the circular or plain mean along the axis, against
        each head."""
        here = coords.device
        sums = sums_of(coords, box_diag, self.membrane.on(here),
                       self.heads.on(here), self.axis, self.radius,
                       self.handle_pbc, self.max_elements)    # (B, M, 2)
        heads = coords.index_select(1, self.heads.on(here))[..., self.axis]
        length = box_diag[:, self.axis]                       # (B,)
        if self.handle_pbc:
            xi, zeta = sums[..., 0], sums[..., 1]
            mean_theta = torch.atan2(-zeta, -xi) + math.pi
            center = mean_theta / (2.0 * math.pi) * length[:, None]
            return _sidedness(heads - center, length[:, None], True)
        count = torch.clamp(sums[..., 1], min=1e-30)
        return _sidedness(heads - sums[..., 0] / count, None, False)

    def plain(self, coords, box_diag):
        """The classes from the plain sums on any device: what the card's
        kernel is held against."""
        return self._classify(coords, box_diag, local_sums_plain)

    def __call__(self, coords, box_diag):
        return self._classify(coords, box_diag, local_sums)


class IndividualClassifier:
    """Individual method: the sign of the summed min-imaged (head − methyl)
    distances of each molecule along the normal (leaflets.rs
    Individual)."""

    def __init__(self, head_indices, methyl_indices, methyl_mol,
                 n_molecules: int, normal_axis: int, handle_pbc: bool = True,
                 device="cpu"):
        self.head_indices = np.asarray(head_indices, np.int64)
        self.methyl_indices = np.asarray(methyl_indices, np.int64)
        self.methyl_mol_np = np.asarray(methyl_mol, np.int64)
        self.n_molecules = int(n_molecules)
        self.axis = int(normal_axis)
        self.handle_pbc = bool(handle_pbc)
        self.device = device
        self.heads = _idx(head_indices, device)
        self.methyls = _idx(methyl_indices, device)
        self.methyl_mol = _idx(methyl_mol, device)
        # the atoms classification reads: a b7 run ships only these, as
        # the decoder's aux side channel
        self.aux_atoms = np.unique(np.concatenate([self.head_indices,
                                                   self.methyl_indices]))

    def rebuild(self, pos_of) -> "IndividualClassifier":
        """The same classifier over another atom numbering (`pos_of` maps
        this one's indices into it), e.g. the aux channel's."""
        return IndividualClassifier(
            pos_of(self.head_indices), pos_of(self.methyl_indices),
            self.methyl_mol_np, self.n_molecules, self.axis,
            self.handle_pbc, self.device)

    def __call__(self, coords, box_diag):
        ax = self.axis
        here = coords.device
        heads = coords.index_select(1, self.heads.on(here))   # (B, M, 3)
        methyls = coords.index_select(1, self.methyls.on(here))  # (B, K, 3)
        head_of_methyl = heads.index_select(1, self.methyl_mol.on(here))
        delta = head_of_methyl[..., ax] - methyls[..., ax]    # (B, K)
        if self.handle_pbc:
            length = box_diag[:, None, ax]
            delta = delta - length * torch.round(delta / length)
        # per-molecule sums; exact in any order for the usual two methyls
        total = torch.zeros((delta.shape[0], self.n_molecules),
                            dtype=delta.dtype, device=delta.device)
        total.index_add_(1, self.methyl_mol.on(here), delta)  # (B, M)
        return torch.where(total >= 0, 0, 1).to(torch.int32)
