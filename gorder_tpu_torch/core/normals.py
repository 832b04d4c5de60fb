"""Dynamic membrane normals on tensors (port of `gorder_tpu/core/normals.py`).

Behavioral reference: src/analysis/normal.rs — per molecule and frame, the
smallest principal axis of the local head-group cloud
(membrane_normal_from_cloud :421-458). The cloud of a molecule is every
atom of the normal-heads selection within `radius` of the molecule's head
(min-image offsets); its masked, centred covariance goes through a batched
3×3 symmetric eigendecomposition, `torch.linalg.eigh` (eigenvalues
ascending, as `jnp.linalg.eigh` returns them), and the normal is the
eigenvector of the smallest eigenvalue. Its sign is the eigensolver's:
every consumer squares the projection on it.

This is no port of a Pallas kernel: the JAX package computes it with XLA
ops. The counts and covariances come from `ops/neighbors.py
normal_cloud`: on the CPU torch ops over (F, M, C) intermediates, as
XLA's, on the card a hand-written kernel that keeps the cloud in shared
memory (`csrc/neighbors.cu`); the eigensolve stays `torch.linalg.eigh`, as XLA's `eigh` sits outside
any kernel in the JAX package. The weighted sums are products and sums
written out, never matmuls, so TF32 cannot enter on the card. The sums
reduce in another order than XLA's, and two eigensolvers (LAPACK on the
CPU, cuSOLVER on the card) differ in the last bits, so normals agree with
the JAX package's to float noise and up to sign; the cloud counts are
comparisons of elementwise d², equal.

The JAX package maps over frames one at a time; the plain version takes
frames in chunks sized so that no (F, M, C, 3) intermediate exceeds
`max_bytes` (`ops/neighbors.py MAX_BYTES`), and the kernel takes a whole
batch in one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.neighbors import (MAX_BYTES, normal_cloud, normal_cloud_plain,
                             symmetric_3x3)
from ..parallel.mesh import Replicas

#: matrices per batched eigensolve: on the H100, torch's batched 3×3
#: cuSOLVER call (cusolverDnXsyevBatched) refused a batch of 87,296 with
#: CUSOLVER_STATUS_INVALID_VALUE; batches of 16,384 pass
EIGH_BATCH = 16384


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device)


def smallest_eigvec_3x3(cov: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric → (..., 3) unit eigenvector of the smallest
    eigenvalue (gorder_tpu/core/normals.py `_smallest_eigvec_3x3`), in
    batches of EIGH_BATCH matrices."""
    flat = cov.reshape(-1, 3, 3)
    vecs = [torch.linalg.eigh(part)[1][:, :, 0]
            for part in flat.split(EIGH_BATCH)]
    return torch.cat(vecs).reshape(cov.shape[:-1])


def dynamic_normals(coords, box_diag, head_idx, cloud_idx, radius: float,
                    handle_pbc: bool, max_bytes: int = MAX_BYTES):
    """(B, A, 3) f32 coordinates and (B, 3) box lengths → (B, M, 3) f32 unit
    normals and (B, M) f32 cloud counts, as `_dynamic_normals_impl`
    (gorder_tpu/core/normals.py:34-55) gives them: the counts and
    covariances of `ops/neighbors.py normal_cloud` (its plain version on
    the CPU, frames in chunks of at most `max_bytes` an intermediate; one
    launch of its kernel on the card), then the eigensolve. `head_idx`
    (M,) and `cloud_idx` (C,) are int64 tensors on the coordinates'
    device."""
    counts, cov = normal_cloud(coords, box_diag, head_idx, cloud_idx, radius,
                               handle_pbc, max_bytes)
    return smallest_eigvec_3x3(symmetric_3x3(cov)), counts


def dynamic_normals_plain(coords, box_diag, head_idx, cloud_idx,
                          radius: float, handle_pbc: bool):
    """`dynamic_normals` over the plain counts and covariances on any
    device: what the card's kernel is held against."""
    counts, cov = normal_cloud_plain(coords, box_diag, head_idx, cloud_idx,
                                     radius, handle_pbc)
    return smallest_eigvec_3x3(symmetric_3x3(cov)), counts


class DynamicNormals:
    """The dynamic-normal computation of one run (gorder_tpu
    `make_dynamic_normals`): its head and cloud indices live on `device`,
    with a replica on any other device it is called on; called with (B, A, 3) f32 coordinates and (B, 3) box lengths →
    ((B, M, 3) normals, (B, M) cloud counts).

    `aux_atoms` are the atoms it reads, and `rebuild(pos_of)` gives the
    same computation over another atom numbering: the b7 wire's aux side
    channel ships only those atoms (engine/channels.py), as for the
    individual leaflet classifier."""

    def __init__(self, head_indices, cloud_indices, radius: float,
                 handle_pbc: bool = True, device="cpu"):
        self.head_indices = np.asarray(head_indices, np.int64)
        self.cloud_indices = np.asarray(cloud_indices, np.int64)
        self.radius = float(radius)
        self.handle_pbc = bool(handle_pbc)
        self.device = device
        self.heads = _idx(head_indices, device)
        self.cloud = _idx(cloud_indices, device)
        self._replicas = (Replicas(self.heads), Replicas(self.cloud))
        self.aux_atoms = np.unique(np.concatenate([self.head_indices,
                                                   self.cloud_indices]))

    def rebuild(self, pos_of) -> "DynamicNormals":
        """The same computation over another atom numbering (`pos_of` maps
        this one's indices into it), e.g. the aux channel's."""
        return DynamicNormals(pos_of(self.head_indices),
                              pos_of(self.cloud_indices), self.radius,
                              self.handle_pbc, self.device)

    def __call__(self, coords, box_diag):
        heads, cloud = (r.on(coords.device) for r in self._replicas)
        return dynamic_normals(coords, box_diag, heads, cloud, self.radius,
                               self.handle_pbc)
