"""Clustering-based leaflet classification on tensors (port of
`gorder_tpu/core/clustering.py`).

Behavioral reference: src/analysis/clustering.rs (spectral) and
src/analysis/spherical_clustering.rs (1-D GMM).

Spectral: similarity W = exp(−σ d²) over the head atoms, the normalized
similarity S = D^{-1/2} W D^{-1/2}, its top three eigenvectors with the
analytic top vector D^{1/2}·1 deflated, the two principal directions of
the remainder energy-weighted and row-normalized, then k-means (k = 2,
farthest-point init, 100 fixed iterations). Cluster→leaflet identity is
resolved on the host, frame after frame (`SpectralOrienter`): ab initio
on the first assignment frame (larger cluster = upper; tie → the cluster
holding the lowest head index), then ≥ 80 % membership overlap with the
previous assignment (clustering.rs classify_by_match).

Spherical: distances of the heads from their center of geometry → a
two-component 1-D GMM fitted by 50 fixed EM steps (percentile init,
log-sum-exp, variance and weight floors); the component with the larger
mean distance (the outer shell) is the upper leaflet.

Every function works on a batch of frames, (B, …) tensors on whatever
device they lie on; a reduction (a norm, a maximum, an argmax, a mean)
is taken per frame, never over the batch. The eigenvector algebra is
chosen by the tensors' device, as the JAX package chooses it by backend:
on the CPU, LAPACK `eigh`; on the card, matmul-only algebra (polynomial-
filtered subspace iteration, Newton–Schulz), which is batched GEMMs where
a batched `eigh` of matrices larger than 32 × 32 runs one matrix at a
time. The `algebra` argument picks a branch explicitly. The products are
meant in full f32: TF32 matmuls (`torch.backends.cuda.matmul.allow_tf32`)
must stay off, as they are by default (`ops/spectral.py
require_f32_matmuls`). The eigenvectors differ by branch and backend, the
labels do not: a rotation or a sign flip of the embedding leaves the
k-means result the same, since its init is row 0 and the row farthest
from it and it depends only on distances.

The per-frame passes go through `ops/spectral.py`, whose wrappers launch
hand-written kernels on the card and run their plain versions on the CPU:
the similarity (dense path), the subspace iteration after the filter's
squarings (matmul branch: its products and QRs in one launch), the
deflated span's two leading directions (with the dense path's Laplacian
products in the same launch), and the embedding's k-means. The filter's
squarings and the Nyström path's products stay `torch.matmul`. A
classifier's `.plain` runs the same chain through the plain versions on
any device, which is what the card's kernels are held to.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..errors import ClusterError
from ..ops import spectral
from ..ops.spectral import sq_distances
from ..parallel.mesh import Replicas
from .pbc import circular_mean_cog, min_image, naive_cog

PRECISE_SIGMA = 1.0
CLASSIFICATION_LIMIT = 0.8
KMEANS_ITERS = 100
GMM_MAX_ITERATIONS = 50
GMM_TOLERANCE = 1e-4

# dense spectral clustering holds an (n, n) similarity matrix per frame;
# larger head clouds switch to the Nyström landmark path: (n, m) per
# frame, landmarks stride-sampled (deterministic)
DENSE_CLUSTER_HEADS = 20_000
NYSTROM_LANDMARKS = 1024
# rank clip for the landmark-similarity eigendecomposition: directions
# below this fraction of the top eigenvalue are treated as numerically
# null (genuinely redundant landmarks)
NYSTROM_RANK_TOL = 1e-6
#: f32 elements of one (b, n, n) or (b, n, m) tensor of the frames
#: processed together (256 MiB); a frame larger than that runs alone
CHUNK_ELEMENTS = 1 << 26


def _algebra(device, algebra):
    """'eigh' (LAPACK, on the CPU) or 'matmul' (the card) unless given."""
    if algebra is not None:
        if algebra not in ("eigh", "matmul"):
            raise ValueError(f"unknown algebra '{algebra}'")
        return algebra
    return "eigh" if torch.device(device).type == "cpu" else "matmul"


def _frame_max(x):
    """(B, 1, 1) largest |entry| of each frame's matrix, floored."""
    return torch.clamp(x.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)


def _norm(v):
    """(B, 1) Euclidean norm of each frame's vector."""
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _inv_sqrt_spd(a, ridge=1e-4, iters=48):
    """(B, m, m) → A^{-1/2} of each SPD matrix by coupled Newton–Schulz
    iteration (pure matmuls), after a small ridge; the spectral scale
    comes from 16 steps of a deterministic power iteration
    (gorder_tpu/core/clustering.py:86-112)."""
    m = a.shape[-1]
    eye = torch.eye(m, dtype=a.dtype, device=a.device)
    a = a + ridge * eye
    v = torch.ones((a.shape[0], m, 1), dtype=a.dtype, device=a.device) \
        / torch.sqrt(torch.tensor(float(m), dtype=a.dtype))
    for _ in range(16):
        v = a @ v
        v = v / torch.clamp(_norm(v[..., 0]), min=1e-30)[..., None]
    lam = (_norm((a @ v)[..., 0]) * 1.2 + 1e-30)[..., None]   # (B, 1, 1)
    y, z = a / lam, eye.expand_as(a)
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return z / torch.sqrt(lam)


def _top3_subspace(s_mat, v0, top3_subspace, squarings=12):
    """(B, n, n) symmetric PSD matrices and (B, n) start vectors → (B, n,
    3) orthonormal bases of their top-3 eigenspaces, by polynomial-filtered
    deterministic subspace iteration: the matrix squared `squarings` times
    (rescaled by its largest entry after each, per frame), then the
    iteration itself, `top3_subspace(gp, s_mat, start)` (`ops/spectral.py`:
    the start basis's QR, SUBSPACE_ITERS QR steps with the filtered matrix
    and one final un-filtered one; gorder_tpu/core/clustering.py:115-151)."""
    spectral.require_f32_matmuls(s_mat.device)
    n = s_mat.shape[-1]
    i = torch.arange(n, dtype=s_mat.dtype, device=s_mat.device)
    r1 = torch.sin(0.7 * i + 0.3).expand_as(v0)
    r2 = torch.cos(1.3 * i + 0.1).expand_as(v0)
    start = torch.stack([v0, r1, r2], dim=-1)
    gp = s_mat / _frame_max(s_mat)
    for _ in range(squarings):
        gp = gp @ gp
        gp = gp / _frame_max(gp)
    return top3_subspace(gp, s_mat.contiguous(), start)


def _embed(u, degree, ops, s_mat=None, lap=None):
    """Deflate v0 = D^{1/2}·1 from the (B, n, 3) span `u`, take the two
    principal directions of the remainder, weight them by energy and
    cluster them: → (B, n) raw k-means labels. The dense path passes its
    similarity `s_mat`, whose Laplacian products u2 − S u2 the span's pass
    forms too; Nyström passes `lap`, which maps a (B, n, 2) span to its
    products."""
    if s_mat is not None:
        u2, lu2 = ops.top2_span(u.contiguous(), degree, s_mat)
    else:
        u2 = ops.top2_span(u.contiguous(), degree)
        lu2 = lap(u2)
    return ops.rayleigh_kmeans(u2, lu2, KMEANS_ITERS)


def _spectral_chunk(heads, box, handle_pbc, algebra, ops):
    """(B, n, 3) head positions → (B, n) raw k-means labels, dense path
    (gorder_tpu/core/clustering.py:154-195), through `ops` (an
    `ops.spectral.Ops`)."""
    s_mat, degree = ops.affinity(heads, box, handle_pbc, PRECISE_SIGMA)
    if algebra == "eigh":
        n = heads.shape[1]
        eye = torch.eye(n, dtype=s_mat.dtype, device=s_mat.device)
        span = torch.linalg.eigh(eye - s_mat).eigenvectors[..., :3]
    else:
        v0 = torch.sqrt(torch.clamp(degree, min=0.0))
        v0 = v0 / torch.clamp(_norm(v0), min=1e-30)
        span = _top3_subspace(s_mat, v0, ops.top3_subspace)
    return _embed(span, degree, ops, s_mat=s_mat)


def _nystrom_chunk(heads, box, landmark_pos, handle_pbc, algebra, ops):
    """(B, n, 3) head positions → (B, n) raw k-means labels through a
    Nyström spectral embedding W ≈ C W_LL⁻¹ Cᵀ over the landmark heads
    (gorder_tpu/core/clustering.py:251-322), through `ops`."""
    marks = heads.index_select(1, landmark_pos)                 # (B, m, 3)
    c = torch.exp(-PRECISE_SIGMA * sq_distances(heads, marks, box,
                                                handle_pbc))    # (B, n, m)
    w_ll = c.index_select(1, landmark_pos)                      # (B, m, m)
    t = c.sum(1)[..., None]                                     # Cᵀ·1
    if algebra == "eigh":
        s, e = torch.linalg.eigh(w_ll)
        good = s > NYSTROM_RANK_TOL * s.amax(-1, keepdim=True)
        s_safe = torch.clamp(s, min=1e-30)
        zero = torch.zeros_like(s)
        inv_sqrt_v = torch.where(good, 1.0 / torch.sqrt(s_safe), zero)
        inv_v = torch.where(good, 1.0 / s_safe, zero)
        degree = (c @ (e @ (inv_v[..., None]
                            * (e.transpose(1, 2) @ t))))[..., 0]
        degree = torch.clamp(degree, min=1e-10)
        r = (c * (1.0 / torch.sqrt(degree))[..., None]) \
            @ (e * inv_sqrt_v[:, None, :])                      # (B, n, m)
        mu, q = torch.linalg.eigh(r.transpose(1, 2) @ r)        # ascending
        top = q[..., -3:]
        mu_top = torch.clamp(mu[..., -3:], min=1e-12)
    else:
        w_inv_sqrt = _inv_sqrt_spd(w_ll)
        degree = (c @ (w_inv_sqrt @ (w_inv_sqrt @ t)))[..., 0]
        degree = torch.clamp(degree, min=1e-10)
        r = (c * (1.0 / torch.sqrt(degree))[..., None]) @ w_inv_sqrt
        g = r.transpose(1, 2) @ r
        gi = torch.arange(g.shape[-1], dtype=g.dtype, device=g.device)
        gv = torch.sin(0.7 * gi + 0.3)
        q3 = _top3_subspace(g, (gv / torch.linalg.vector_norm(gv))
                            .expand(g.shape[0], -1), ops.top3_subspace)
        mu3, e3 = torch.linalg.eigh(q3.transpose(1, 2) @ (g @ q3))  # 3×3
        top = q3 @ e3
        mu_top = torch.clamp(mu3, min=1e-12)
    u = (r @ top) * (1.0 / torch.sqrt(mu_top))[:, None, :]      # (B, n, 3)
    return _embed(u, degree, ops,
                  lap=lambda u2: u2 - r @ (r.transpose(1, 2) @ u2))


def _by_chunks(fn, coords, box_diag, per_frame: int):
    """`fn` over frame chunks of at most CHUNK_ELEMENTS / `per_frame`."""
    step = max(1, CHUNK_ELEMENTS // max(per_frame, 1))
    return torch.cat([fn(coords[i:i + step], box_diag[i:i + step])
                      for i in range(0, coords.shape[0], step)])


def make_spectral_labels(head_indices, handle_pbc=True, device="cpu",
                         algebra=None):
    """The spectral classifier over the head atoms `head_indices`: (B, A,
    3) f32 coordinates and (B, 3) box lengths → (B, n) int32 raw k-means
    labels, to be oriented by `SpectralOrienter`. Dense up to
    DENSE_CLUSTER_HEADS heads, Nyström above. `algebra` ('eigh' or
    'matmul') overrides the choice by the coordinates' device. The
    classifier's `.plain` gives the labels of the same chain through the
    plain versions of `ops/spectral.py`, on any device."""
    head_indices = np.asarray(head_indices, np.int64)
    head_d = Replicas(torch.as_tensor(head_indices, device=device))
    n = len(head_indices)
    if n <= DENSE_CLUSTER_HEADS:
        def chunk(coords, box_diag, ops):
            return _spectral_chunk(
                coords.index_select(1, head_d.on(coords.device)),
                box_diag.contiguous(), handle_pbc,
                _algebra(coords.device, algebra), ops)

        per_frame = n * n
    else:
        # deterministic stride-sampled landmarks (positions into the heads)
        m = min(NYSTROM_LANDMARKS, n)
        landmark_d = Replicas(torch.as_tensor(np.unique(
            np.linspace(0, n - 1, m).round().astype(np.int64)),
            device=device))

        def chunk(coords, box_diag, ops):
            here = coords.device
            return _nystrom_chunk(
                coords.index_select(1, head_d.on(here)), box_diag,
                landmark_d.on(here), handle_pbc, _algebra(here, algebra),
                ops)

        per_frame = n * len(landmark_d)

    def compute(coords, box_diag):
        return _by_chunks(lambda c, b: chunk(c, b, spectral.WRAPPERS),
                          coords, box_diag, per_frame)

    def plain(coords, box_diag):
        return _by_chunks(lambda c, b: chunk(c, b, spectral.PLAIN),
                          coords, box_diag, per_frame)

    compute.plain = plain
    return compute


class SpectralOrienter:
    """Sequential cluster→leaflet identity across assignment frames."""

    def __init__(self, head_indices):
        self.head_indices = np.asarray(head_indices)
        self.prev_upper = None   # (M,) bool

    def orient(self, labels: np.ndarray) -> np.ndarray:
        """raw (M,) k-means labels → (M,) classes (0 upper, 1 lower)."""
        c1 = labels == 0
        c2 = ~c1
        if self.prev_upper is None:
            n1, n2 = int(c1.sum()), int(c2.sum())
            if n1 > n2:
                upper = c1
            elif n2 > n1:
                upper = c2
            else:
                # tie: the cluster holding the lowest head atom index
                first = int(np.argmin(self.head_indices))
                upper = c1 if c1[first] else c2
        else:
            overlap_upper = (c1 & self.prev_upper).sum() / max(c1.sum(), 1)
            overlap_lower = (c1 & ~self.prev_upper).sum() / max(c1.sum(), 1)
            if (overlap_upper < CLASSIFICATION_LIMIT
                    and overlap_lower < CLASSIFICATION_LIMIT):
                # wording: src/errors.rs:531-537
                # (ClusterError::CouldNotMatchLeaflets); "number of
                # threads" reads "number of devices" in this architecture
                pct = int(CLASSIFICATION_LIMIT * 100)
                raise ClusterError(
                    f"clustering leaflet classification failed\ndetails: "
                    f"when comparing current frame to previous frame, the "
                    f"previously identified leaflets show >{pct}% lipid "
                    f"composition change\nhint: this may be caused by "
                    f"either of several issues:\n  - leaflets identified "
                    f"incorrectly => consider manual leaflet assignment,\n"
                    f"  - too rapid flip-flop => increase classification "
                    f"frequency,\n  - frames too far apart => increase "
                    f"classification frequency")
            upper = c1 if overlap_upper >= overlap_lower else c2
        self.prev_upper = upper
        return np.where(upper, 0, 1).astype(np.int32)


# ------------------------------------------------------------------ spherical


def _log_gauss(x, m, v, log_2pi):
    return -0.5 * (log_2pi + torch.log(v) + (x - m) ** 2 / v)


def _spherical_classes(coords, box_diag, head_idx, handle_pbc):
    """(B, A, 3) → (B, M) int32 classes (0 = outer/upper, 1 = inner/lower)
    (gorder_tpu/core/clustering.py:398-469)."""
    heads = coords.index_select(1, head_idx)                    # (B, M, 3)
    mask = torch.ones(heads.shape[:-1], dtype=heads.dtype,
                      device=heads.device)
    if handle_pbc:
        center = circular_mean_cog(heads, mask, box_diag)
    else:
        center = naive_cog(heads, mask)
    rel = heads - center[:, None, :]
    if handle_pbc:
        rel = min_image(rel, box_diag[:, None, :])
    dist = torch.sqrt((rel * rel).sum(-1))                      # (B, M)

    # GMM init: 25th/75th percentile means, the global variance
    n = dist.shape[1]
    sorted_d = torch.sort(dist, dim=1).values
    m_a, m_b = sorted_d[:, n // 4], sorted_d[:, (3 * n) // 4]
    gvar = torch.clamp(torch.var(dist, dim=1, correction=1), min=1e-6)
    v_a = v_b = gvar
    w_a = torch.full_like(gvar, 0.5)
    # f32 log(2π), as XLA computes jnp.log(2π) of the weak f32 constant
    log_2pi = torch.log(torch.tensor(2.0 * math.pi, dtype=dist.dtype,
                                     device=dist.device))

    def responsibility(w_a, m_a, v_a, m_b, v_b):
        ja = torch.log(w_a)[:, None] + _log_gauss(
            dist, m_a[:, None], v_a[:, None], log_2pi)
        jb = torch.log(1.0 - w_a)[:, None] + _log_gauss(
            dist, m_b[:, None], v_b[:, None], log_2pi)
        mx = torch.maximum(ja, jb)
        log_px = mx + torch.log(torch.exp(ja - mx) + torch.exp(jb - mx))
        return torch.exp(ja - log_px)

    for _ in range(GMM_MAX_ITERATIONS):
        resp_a = responsibility(w_a, m_a, v_a, m_b, v_b)
        total_a = resp_a.sum(1)
        sum_a = torch.clamp(total_a, min=1e-6)
        sum_b = torch.clamp(n - total_a, min=1e-6)
        w_a = torch.clamp(sum_a / n, 1e-4, 1.0 - 1e-4)
        m_a = (resp_a * dist).sum(1) / sum_a
        m_b = ((1.0 - resp_a) * dist).sum(1) / sum_b
        v_a = torch.clamp(
            (resp_a * (dist - m_a[:, None]) ** 2).sum(1) / sum_a, min=1e-6)
        v_b = torch.clamp(
            ((1.0 - resp_a) * (dist - m_b[:, None]) ** 2).sum(1) / sum_b,
            min=1e-6)
    in_a = responsibility(w_a, m_a, v_a, m_b, v_b) >= 0.5
    # the outer shell (larger mean distance) is the upper leaflet
    upper = torch.where((m_a >= m_b)[:, None], in_a, ~in_a)
    return torch.where(upper, 0, 1).to(torch.int32)


def make_spherical_classifier(head_indices, handle_pbc=True, device="cpu"):
    """The spherical classifier over the head atoms: (B, A, 3) f32
    coordinates and (B, 3) box lengths → (B, M) int32 classes. It is a
    pure function of each batch, so every-frame runs call it with the
    order step on the device."""
    head_d = Replicas(torch.as_tensor(np.asarray(head_indices, np.int64),
                                      device=device))

    def classify(coords, box_diag):
        return _spherical_classes(coords, box_diag,
                                  head_d.on(coords.device), handle_pbc)

    return classify
