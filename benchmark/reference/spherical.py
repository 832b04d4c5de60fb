"""Plain spherical-clustering leaflets from grid integers, in float64.

gorder's classifier for vesicles: the distances of the head atoms from
their centre of geometry (the circular mean of each coordinate over the
periodic box, refined by the heads' mean minimum-image deviation from
it), a two-component one-dimensional Gaussian mixture fitted to them by
50 EM steps (the 25th and 75th percentile distances as the starting
means, the distances' variance as both starting variances, equal
weights; variances and the smaller weight floored), each head in the
component of responsibility ≥ 0.5, and the component of the larger mean
distance the upper leaflet (class 0; the other class 1)."""

from __future__ import annotations

import math

import torch

EM_STEPS = 50


def _min_image(d, box):
    return d - box * torch.round(d / box)


def centre(points: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """(F, M, 3) points in a box → (F, 3) refined circular-mean centres."""
    theta = points / box * (2 * math.pi)
    mean_theta = torch.atan2(-torch.sin(theta).sum(1),
                             -torch.cos(theta).sum(1)) + math.pi
    estimate = mean_theta / (2 * math.pi) * box
    dev = _min_image(points - estimate[:, None], box)
    refined = estimate + dev.mean(1)
    return refined - box * torch.floor(refined / box)


def _log_gauss(x, m, v):
    return -0.5 * (math.log(2 * math.pi) + torch.log(v) + (x - m) ** 2 / v)


def spherical_classes(heads: torch.Tensor, box: torch.Tensor,
                      precision: float) -> torch.Tensor:
    """(F, M, 3) head integers, the box in grid units → (F, M) int64
    classes, 0 = upper (outer), 1 = lower (inner)."""
    x = heads.to(torch.float64) / precision
    box = box / precision
    rel = _min_image(x - centre(x, box)[:, None], box)
    dist = torch.linalg.vector_norm(rel, dim=-1)                   # (F, M)
    n = dist.shape[1]
    ordered = torch.sort(dist, 1).values
    m_a, m_b = ordered[:, n // 4], ordered[:, (3 * n) // 4]
    v_a = v_b = torch.clamp(torch.var(dist, 1, correction=1), min=1e-6)
    w_a = torch.full_like(m_a, 0.5)

    def responsibility():
        ja = torch.log(w_a)[:, None] + _log_gauss(dist, m_a[:, None],
                                                  v_a[:, None])
        jb = torch.log(1 - w_a)[:, None] + _log_gauss(dist, m_b[:, None],
                                                      v_b[:, None])
        return torch.exp(ja - torch.logaddexp(ja, jb))

    for _ in range(EM_STEPS):
        r = responsibility()
        s_a = torch.clamp(r.sum(1), min=1e-6)
        s_b = torch.clamp(n - r.sum(1), min=1e-6)
        w_a = torch.clamp(s_a / n, 1e-4, 1 - 1e-4)
        m_a = (r * dist).sum(1) / s_a
        m_b = ((1 - r) * dist).sum(1) / s_b
        v_a = torch.clamp((r * (dist - m_a[:, None]) ** 2).sum(1) / s_a,
                          min=1e-6)
        v_b = torch.clamp(((1 - r) * (dist - m_b[:, None]) ** 2).sum(1)
                          / s_b, min=1e-6)
    in_a = responsibility() >= 0.5
    upper = torch.where((m_a >= m_b)[:, None], in_a, ~in_a)
    return torch.where(upper, 0, 1)
