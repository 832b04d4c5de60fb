"""Plain dynamic membrane normals from grid integers.

gorder's dynamic normal of a molecule in a frame: every atom of the
normal-heads selection within `radius` of the molecule's head, by
minimum-image offsets, gives a cloud; the normal is the principal axis of
smallest variance of the cloud's centred offsets (its sign does not
matter to an order parameter, which squares the projection). Here the
offsets are exact integers, the radius test an integer comparison
(d² ≤ r²), the sums exact int64, and the covariance and its
eigendecomposition float64; one frame at a time, all pairs of heads."""

from __future__ import annotations

import torch


def _min_image_int(delta: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Integer offsets wrapped to [-L/2, L/2) per axis (box as int)."""
    return delta - box * torch.div(2 * delta + box, 2 * box,
                                   rounding_mode="floor")


_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def frame_clouds(heads: torch.Tensor, cloud: torch.Tensor,
                 box: torch.Tensor, radius2: int):
    """(M, 3) head and (C, 3) cloud integers of one frame → ((M,) int64
    counts, (M, 3) int64 offset sums, (M, 6) int64 product sums xx xy xz
    yy yz zz) of each head's cloud."""
    wide = 3 * (int(box.max()) // 2 + 1) ** 2 >= 2 ** 31
    kind = torch.int64 if wide else torch.int32
    h = heads.to(kind)
    delta = _min_image_int(cloud.to(kind)[None, :, :] - h[:, None, :],
                           box.to(kind))                       # (M, C, 3)
    d2 = (delta * delta).sum(-1, dtype=kind)
    i, j = torch.nonzero(d2 <= radius2, as_tuple=True)
    dv = delta[i, j].to(torch.int64)                           # (P, 3)
    m = heads.shape[0]
    counts = torch.bincount(i, minlength=m)
    s1 = torch.zeros((m, 3), dtype=torch.int64, device=heads.device)
    s1.index_add_(0, i, dv)
    s2 = torch.zeros((m, 6), dtype=torch.int64, device=heads.device)
    s2.index_add_(0, i, torch.stack([dv[:, a] * dv[:, b]
                                     for a, b in _PAIRS], 1))
    return counts, s1, s2


def dynamic_normals(heads: torch.Tensor, cloud: torch.Tensor,
                    box: torch.Tensor, radius2: int, dtype=torch.float64):
    """(F, M, 3) head and (F, C, 3) cloud integers, the box in grid units
    and the squared radius in grid units → ((F, M, 3) unit normals in
    `dtype`, the number of (head, cloud atom) pairs within the radius).
    Below float32 the covariance is rounded to `dtype` and solved in
    float32 (no eigensolver takes less)."""
    box_i = torch.round(box).to(torch.int64)
    normals, pairs = [], 0
    for f in range(heads.shape[0]):
        n, s1, s2 = frame_clouds(heads[f], cloud[f], box_i, radius2)
        pairs += int(n.sum())
        n = n.to(torch.float64).clamp(min=1.0)
        s1 = s1.to(torch.float64)
        cov6 = s2.to(torch.float64) - torch.stack(
            [s1[:, a] * s1[:, b] for a, b in _PAIRS], 1) / n[:, None]
        cov = cov6[:, [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(-1, 3, 3)
        if dtype != torch.float64:
            cov = cov.to(dtype).to(torch.float32)
        normals.append(torch.linalg.eigh(cov)[1][:, :, 0].to(dtype))
    return torch.stack(normals), pairs
