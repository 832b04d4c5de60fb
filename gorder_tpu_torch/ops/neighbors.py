"""The dense neighbour kernels' wrappers and their plain PyTorch versions:
the masked reductions over every (head, neighbour) pair of a frame that
dynamic membrane normals (`core/normals.py`) and the local leaflet
classifier (`core/leaflets.py LocalClassifier`) take.

`normal_cloud` gives, per frame and head, the count of cloud atoms within
the radius and their masked, centred covariance, as
`gorder_tpu/core/normals.py _dynamic_normals_impl` (:34-55) computes them
before its eigensolve. `local_sums` gives, per frame and head, the
weighted sums of the membrane atoms within an in-plane radius that
`gorder_tpu/core/leaflets.py _local_classify_impl` (:107-141) takes its
center from: (Σ w·cos θ, Σ w·sin θ) with PBC, (Σ w·z, Σ w) without.
Neither is a Pallas kernel in gorder_tpu: there both are XLA ops.

For tensors on the CPU the wrappers run the plain versions, op by op the
JAX package's, frames in chunks that bound their pair intermediates (the
JAX package maps over single frames to bound them); for CUDA tensors
they launch the hand-written kernels (`csrc/neighbors.cu`) on the current
stream, or raise. The wrappers alone choose between the two, and there
is no fallback from a kernel to its plain version. Both check their arguments
on either device. The kernels keep the neighbours in shared memory and
write no pair to device memory; their mask is the plain version's bit for
bit (the counts are equal), and their sums run in f64 in another order
than torch's f32 `.sum`, so the sums agree to a few f32 ulps. The
wrappers hand the kernels the margin of their minimum image
(`MIN_IMAGE_MARGIN`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.pbc import min_image
from .build import call, check_tensor, device_of

#: cloud atoms a normal_cloud block loads into shared memory at a time
#: (16 bytes an atom)
NORMAL_TILE = 2048
#: membrane atoms a local_sums block loads into shared memory at a time
#: (24 bytes an atom: the plane position in f32, the two values in f64)
LOCAL_TILE = 1024
#: the kernels' minimum image takes t = d · fl(1/L) and rounds it, and
#: divides d / L only where t lies within MIN_IMAGE_MARGIN · MIN_IMAGE_SPAN
#: of a half-integer: t is within 3 · 2^-24 · |t| of fl(d / L), so beyond
#: that margin both round to the same integer while |t| ≤ MIN_IMAGE_SPAN,
#: as it is for every pair of a tile whose coordinates lie in [-L, 2L];
#: the kernels divide every pair of any other tile. They refuse a
#: narrower margin; the span is theirs (csrc/neighbors.cu kSpan).
#: tests/test_torch_neighbors.py holds the rule against rint(d / L) and
#: shows a margin of 0 failing
MIN_IMAGE_SPAN = 4.0
MIN_IMAGE_MARGIN = 2.0 ** -22

#: bytes one (F, M, C, 3) f32 intermediate of normal_cloud_plain may take
MAX_BYTES = 256 << 20
#: (frames × heads × membrane atoms) pairs one chunk of local_sums_plain
#: may hold
MAX_ELEMENTS = 1 << 26

#: launches of each kernel since the last reset; the plain versions count
#: in neither
normals_launches = 0
local_launches = 0


#: the (.., 6) covariance entries xx xy xz yy yz zz of each of the nine
#: entries of a symmetric 3×3 matrix, row by row
_SYM = [0, 1, 2, 1, 3, 4, 2, 4, 5]


def symmetric_3x3(cov6: torch.Tensor) -> torch.Tensor:
    """(..., 6) entries xx xy xz yy yz zz → (..., 3, 3) symmetric."""
    return cov6[..., _SYM].reshape(cov6.shape[:-1] + (3, 3))


def radius_squared(radius: float, device) -> torch.Tensor:
    """f32(radius)², as the plain versions compare d² against it."""
    r = torch.tensor(np.float32(radius), device=device)
    return r * r


def _check(coords, box_diag, indices, device):
    """Check the arguments both wrappers take: (B, A, 3) f32 coordinates,
    (B, 3) f32 box lengths and 1-D int64 atom indices, all on `device`."""
    if coords.dim() != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coords has shape {tuple(coords.shape)}, "
                         f"expected (n_frames, n_atoms, 3)")
    check_tensor("coords", coords, torch.float32, tuple(coords.shape),
                 device)
    check_tensor("box_diag", box_diag, torch.float32,
                 (coords.shape[0], 3), device)
    for name, idx in indices.items():
        if idx.dim() != 1:
            raise ValueError(f"{name} has shape {tuple(idx.shape)}, "
                             f"expected (n,)")
        check_tensor(name, idx, torch.int64, tuple(idx.shape), device)


def _frame_chunks(fn, n_frames: int, per_frame: int, limit: int, coords,
                  box_diag, *rest):
    """`fn` over frames in chunks of at most `limit` // `per_frame` (at
    least one), its tensor results joined along the frames."""
    step = max(1, limit // max(1, per_frame))
    parts = [fn(coords[i:i + step], box_diag[i:i + step], *rest)
             for i in range(0, max(n_frames, 1), step)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def normal_cloud_plain(coords, box_diag, head_idx, cloud_idx, radius: float,
                       handle_pbc: bool, max_bytes: int = MAX_BYTES):
    """(F, A, 3) f32 coordinates → ((F, M) f32 cloud counts, (F, M, 6) f32
    covariances), step by step as `_dynamic_normals_impl` takes them:
    min-image head→cloud offsets, the mask d² ≤ f32(radius)², the count,
    the weights mask / max(count, 1), the centroid, and the masked centred
    covariance, every pair an element of an (F, M, C) intermediate; frames
    in chunks so that no (F, M, C, 3) intermediate exceeds `max_bytes`."""
    per_frame = (head_idx.shape[0] * cloud_idx.shape[0] * 3
                 * coords.element_size())
    return _frame_chunks(_normal_cloud_chunk, coords.shape[0], per_frame,
                         max_bytes, coords, box_diag, head_idx, cloud_idx,
                         radius, handle_pbc)


def _normal_cloud_chunk(coords, box_diag, head_idx, cloud_idx,
                        radius: float, handle_pbc: bool):
    heads = coords.index_select(1, head_idx)                 # (F, M, 3)
    cloud = coords.index_select(1, cloud_idx)                # (F, C, 3)
    rel = []
    for c in range(3):
        d = cloud[:, None, :, c] - heads[:, :, None, c]      # (F, M, C)
        if handle_pbc:
            d = min_image(d, box_diag[:, None, None, c])
        rel.append(d)
    d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2]
    mask = (d2 <= radius_squared(radius, coords.device)).to(coords.dtype)
    count = mask.sum(dim=-1)                                 # (F, M)
    weights = mask / torch.clamp(count, min=1.0)[..., None]
    centered = [(d - (weights * d).sum(dim=-1)[..., None]) * mask
                for d in rel]
    cov = torch.stack([(centered[a] * centered[b]).sum(dim=-1)
                       for a in range(3) for b in range(a, 3)], dim=-1)
    return count, cov


def normal_cloud(coords, box_diag, head_idx, cloud_idx, radius: float,
                 handle_pbc: bool, max_bytes: int = MAX_BYTES):
    """(B, A, 3) f32 coordinates, (B, 3) f32 box lengths, (M,) int64 head
    and (C,) int64 cloud atom indices → ((B, M) f32 cloud counts, (B, M, 6)
    f32 masked centred covariances, entries xx xy xz yy yz zz). On the CPU
    `max_bytes` bounds the plain version's intermediates; the kernel
    writes none. On the card the heads' and the cloud's coordinates are
    gathered (torch `index_select`) before the launch, so that the kernel
    reads its tiles of the cloud contiguously."""
    global normals_launches
    device = device_of(coords)
    _check(coords, box_diag, {"head_idx": head_idx, "cloud_idx": cloud_idx},
           device)
    if device.type == "cpu":
        return normal_cloud_plain(coords, box_diag, head_idx, cloud_idx,
                                  radius, handle_pbc, max_bytes)
    n_frames = coords.shape[0]
    n_heads, n_cloud = head_idx.shape[0], cloud_idx.shape[0]
    counts = torch.empty((n_frames, n_heads), dtype=torch.float32,
                         device=device)
    cov = torch.empty((n_frames, n_heads, 6), dtype=torch.float32,
                      device=device)
    if not counts.numel():
        return counts, cov
    heads = coords.index_select(1, head_idx)                 # (B, M, 3)
    cloud = coords.index_select(1, cloud_idx)                # (B, C, 3)
    tile = max(1, min(n_cloud, NORMAL_TILE))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        call("normal_cloud", heads.data_ptr(), cloud.data_ptr(),
             box_diag.data_ptr(), counts.data_ptr(), cov.data_ptr(),
             n_frames, n_heads, n_cloud,
             float(np.float32(radius) * np.float32(radius)),
             MIN_IMAGE_MARGIN, int(handle_pbc), tile, stream)
    normals_launches += 1
    return counts, cov


def plane_axes(axis: int) -> tuple:
    """The two axes of the membrane plane, normal along `axis`."""
    return tuple(a for a in range(3) if a != axis)


def _member_values(membrane, box_diag, axis: int, handle_pbc: bool):
    """The two values of each membrane atom that the local sums weigh:
    cos θ and sin θ of θ = 2π·z / L with PBC (the circular mean), z and 1
    without (the plain mean and the count). → two (F, Nm) tensors."""
    z = membrane[..., axis]
    if not handle_pbc:
        return z, torch.ones_like(z)
    theta = z / box_diag[:, None, axis] * (2.0 * math.pi)
    return torch.cos(theta), torch.sin(theta)


def local_sums_plain(coords, box_diag, membrane_idx, head_idx, axis: int,
                     radius: float, handle_pbc: bool,
                     max_elements: int = MAX_ELEMENTS):
    """(F, A, 3) f32 coordinates → (F, M, 2) f32 weighted sums, as
    `_local_classify_impl` takes them: only the in-plane components of
    membrane − head, each min-imaged under PBC, enter the weights
    d_plane² ≤ f32(radius)², over (F, M, Nm) intermediates of frames in
    chunks of at most `max_elements` pairs; the sums are products and
    sums, not matmuls (a matmul on the card may run in TF32,
    `torch.backends.cuda.matmul.allow_tf32`)."""
    per_frame = head_idx.shape[0] * membrane_idx.shape[0]
    return _frame_chunks(_local_sums_chunk, coords.shape[0], per_frame,
                         max_elements, coords, box_diag, membrane_idx,
                         head_idx, axis, radius, handle_pbc)


def _local_sums_chunk(coords, box_diag, membrane_idx, head_idx, axis: int,
                      radius: float, handle_pbc: bool):
    membrane = coords.index_select(1, membrane_idx)          # (F, Nm, 3)
    heads = coords.index_select(1, head_idx)                 # (F, M, 3)
    d_plane2 = None
    for a in plane_axes(axis):
        # each is the JAX package's component bit for bit
        d = membrane[:, None, :, a] - heads[:, :, None, a]   # (F, M, Nm)
        if handle_pbc:
            d = min_image(d, box_diag[:, None, None, a])
        d_plane2 = d * d if d_plane2 is None else d_plane2 + d * d
    r2 = radius_squared(radius, coords.device)
    weights = (d_plane2 <= r2).to(coords.dtype)
    v0, v1 = _member_values(membrane, box_diag, axis, handle_pbc)
    total = (weights * v0[:, None, :]).sum(dim=-1)
    other = ((weights * v1[:, None, :]).sum(dim=-1) if handle_pbc
             else weights.sum(dim=-1))
    return torch.stack([total, other], dim=-1)


def local_sums(coords, box_diag, membrane_idx, head_idx, axis: int,
               radius: float, handle_pbc: bool,
               max_elements: int = MAX_ELEMENTS):
    """(B, A, 3) f32 coordinates, (B, 3) f32 box lengths, (Nm,) int64
    membrane and (M,) int64 head atom indices, the normal axis → (B, M, 2)
    f32: (Σ w·cos θ, Σ w·sin θ) with PBC, (Σ w·z, Σ w) without, w the
    in-plane mask. On the card θ, cos θ and sin θ are torch ops before
    the launch, as the plain version takes them; the kernel reads each
    membrane atom as (plane0, plane1, value0, value1). On the CPU
    `max_elements` bounds the plain version's chunks; the kernel holds no
    pair."""
    global local_launches
    device = device_of(coords)
    _check(coords, box_diag, {"membrane_idx": membrane_idx,
                              "head_idx": head_idx}, device)
    if axis not in (0, 1, 2):
        raise ValueError(f"axis {axis} is not 0, 1 or 2")
    if device.type == "cpu":
        return local_sums_plain(coords, box_diag, membrane_idx, head_idx,
                                axis, radius, handle_pbc, max_elements)
    p0, p1 = plane_axes(axis)
    membrane = coords.index_select(1, membrane_idx)          # (B, Nm, 3)
    members = torch.stack(
        [membrane[..., p0], membrane[..., p1],
         *_member_values(membrane, box_diag, axis, handle_pbc)],
        dim=-1).contiguous()                                 # (B, Nm, 4)
    heads = coords.index_select(1, head_idx)[..., [p0, p1]].contiguous()
    box_plane = box_diag[:, [p0, p1]].contiguous()
    n_frames = coords.shape[0]
    n_heads = head_idx.shape[0]
    out = torch.empty((n_frames, n_heads, 2), dtype=torch.float32,
                      device=device)
    if not out.numel():
        return out
    n_members = membrane_idx.shape[0]
    tile = max(1, min(n_members, LOCAL_TILE))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        call("local_sums", members.data_ptr(), heads.data_ptr(),
             box_plane.data_ptr(), out.data_ptr(), n_frames, n_members,
             n_heads, float(np.float32(radius) * np.float32(radius)),
             MIN_IMAGE_MARGIN, int(handle_pbc), tile, stream)
    local_launches += 1
    return out
