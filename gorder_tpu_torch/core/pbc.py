"""Periodic-boundary helpers on tensors (port of `gorder_tpu/core/pbc.py`).

Orthogonal boxes only, like the reference's PBCHandler
(src/analysis/pbc.rs:21-480). `torch.round` rounds half to even, as
`jnp.round` does, so the minimum image matches the JAX package bit for
bit.
"""

from __future__ import annotations

import math

import torch


def min_image(d: torch.Tensor, box_diag: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement: d − L·round(d / L).

    d: (..., 3) displacements; box_diag: broadcastable (..., 3) lengths."""
    return d - box_diag * torch.round(d / box_diag)


def wrap(x: torch.Tensor, box_diag: torch.Tensor) -> torch.Tensor:
    """Wrap coordinates into [0, L)."""
    return x - box_diag * torch.floor(x / box_diag)


def circular_mean_cog(points: torch.Tensor, mask: torch.Tensor,
                      box_diag: torch.Tensor) -> torch.Tensor:
    """Refined Bai–Breen center of geometry under PBC (port of
    `gorder_tpu/core/pbc.py circular_mean_cog`).

    points: (..., N, 3); mask: (..., N) bool/float weights; box_diag:
    (..., 3). Returns the (..., 3) center inside the box: the weighted
    circular mean of each coordinate, refined by the mean min-image
    deviation of the points from it. The sums reduce in another order
    than XLA's, so centers agree to float noise, not bit for bit."""
    weights = mask.to(points.dtype)[..., None]
    count = torch.clamp(weights.sum(dim=-2), min=1e-30)
    theta = points / box_diag[..., None, :] * (2.0 * math.pi)
    xi = (torch.cos(theta) * weights).sum(dim=-2)
    zeta = (torch.sin(theta) * weights).sum(dim=-2)
    mean_theta = torch.atan2(-zeta, -xi) + math.pi
    estimate = mean_theta / (2.0 * math.pi) * box_diag
    dev = min_image(points - estimate[..., None, :], box_diag[..., None, :])
    refined = estimate + (dev * weights).sum(dim=-2) / count
    return wrap(refined, box_diag)


def naive_cog(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain center of geometry (no PBC)."""
    weights = mask.to(points.dtype)[..., None]
    total = (points * weights).sum(dim=-2)
    count = torch.clamp(weights.sum(dim=-2), min=1e-30)
    return total / count
