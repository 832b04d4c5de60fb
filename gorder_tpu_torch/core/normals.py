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
ops, and so does this module with torch ops. The weighted sums are
products and sums written out, never matmuls, so TF32 cannot enter on the
card: every f32 product runs in full f32 whatever
`torch.backends.cuda.matmul.allow_tf32` says (False by default, with
matmul precision "highest"). The sums reduce in another order than XLA's,
and two eigensolvers (LAPACK on the CPU, cuSOLVER on the card) differ in
the last bits, so normals agree with the JAX package's to float noise and
up to sign; the cloud counts are comparisons of elementwise d², equal.

The JAX package maps over frames one at a time; here frames go in chunks
sized so that no (F, M, C, 3) intermediate exceeds `max_bytes`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import Replicas
from .pbc import min_image

#: bytes one (F, M, C, 3) f32 intermediate may take (frames are chunked)
MAX_BYTES = 256 << 20
#: matrices per batched eigensolve: on the H100, torch's batched 3×3
#: cuSOLVER call (cusolverDnXsyevBatched) refused a batch of 87,296 with
#: CUSOLVER_STATUS_INVALID_VALUE; batches of 16,384 pass
EIGH_BATCH = 16384


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


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
    normals and (B, M) f32 cloud counts, step by step as
    `_dynamic_normals_impl` (gorder_tpu/core/normals.py:34-55) takes them:
    min-image head→cloud offsets, the mask d² ≤ f32(radius)², the count,
    the weights mask / max(count, 1), the centroid, and the masked centred
    covariance. `head_idx` (M,) and `cloud_idx` (C,) are int64 tensors on
    the coordinates' device."""
    n_heads, n_cloud = head_idx.shape[0], cloud_idx.shape[0]
    per_frame = max(1, n_heads * n_cloud * 3 * coords.element_size())
    step = max(1, max_bytes // per_frame)
    r = torch.tensor(np.float32(radius), device=coords.device)
    r2 = r * r
    normals, counts = [], []
    for i in range(0, coords.shape[0], step):
        frames, box = coords[i:i + step], box_diag[i:i + step]
        heads = frames.index_select(1, head_idx)            # (F, M, 3)
        cloud = frames.index_select(1, cloud_idx)           # (F, C, 3)
        rel = []
        for c in range(3):
            d = cloud[:, None, :, c] - heads[:, :, None, c]  # (F, M, C)
            if handle_pbc:
                d = min_image(d, box[:, None, None, c])
            rel.append(d)
        d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2]
        mask = (d2 <= r2).to(coords.dtype)
        count = mask.sum(dim=-1)                            # (F, M)
        weights = mask / torch.clamp(count, min=1.0)[..., None]
        centered = [(d - (weights * d).sum(dim=-1)[..., None]) * mask
                    for d in rel]
        cov = torch.empty(frames.shape[0], n_heads, 3, 3, dtype=coords.dtype,
                          device=coords.device)
        for a in range(3):
            for b in range(a, 3):
                s = (centered[a] * centered[b]).sum(dim=-1)
                cov[..., a, b] = s
                cov[..., b, a] = s
        normals.append(smallest_eigvec_3x3(cov))
        counts.append(count)
    return torch.cat(normals), torch.cat(counts)


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
