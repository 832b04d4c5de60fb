"""The spectral leaflet classifier's kernels' wrappers and their plain
PyTorch versions: the similarity pass, the thin QR of an n × 3 basis, the
two leading directions of the deflated span, and the energy-weighted
embedding with its k-means (`core/clustering.py` calls them for a batch of
frames).

`spectral_affinity` gives, per frame, the similarity S = D^{-1/2} W D^{-1/2}
of W = exp(−σ d²) over the heads and the degrees D, as
`gorder_tpu/core/clustering.py _spectral_labels` (:159-176) forms them;
`thin_qr3` an orthonormal basis Q of an (n, 3) matrix A with span(Q[:, :k])
= span(A[:, :k]), where `jnp.linalg.qr` (:136, :144, :149) gives one;
`top2_span` the two leading left singular vectors of the span with the
analytic top vector D^{1/2}·1 deflated (:189-190, :315-317);
`rayleigh_kmeans` the raw k-means labels of the energy-weighted embedding
(`_rayleigh_weighted` :198-235, `_kmeans2` :51-83), given the span's
Laplacian products. None is a Pallas kernel in gorder_tpu: there all are
XLA ops.

For tensors on the CPU the wrappers run the plain versions; for CUDA
tensors they launch the hand-written kernels (`csrc/spectral.cu`) on the
current stream, or raise. The wrappers alone choose between the two, and
there is no fallback from a kernel to its plain version. All check their
arguments on either device. The plain QR and span run in f64, as the
kernels do: the filtered subspace iteration hands the QR inputs with
condition numbers near 5e7, whose orthogonality f32 Gram–Schmidt or
Cholesky-QR lose. The third column of a QR of such an input is set by
rounding, and the span's two directions are equal in energy, so a kernel
and its plain version agree on the spaces they span (their projectors),
not column by column; the labels, which depend only on distances within
the embedding, agree exactly.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.pbc import min_image
from .build import call, check_tensor, device_of

#: heads a spectral_affinity block keeps in shared memory at a time (16
#: bytes a head: x, y, z and 1/√degree)
AFFINITY_TILE = 1024
#: rows whose working columns thin_qr3 (48 bytes a row) and
#: rayleigh_kmeans (8 bytes a row) keep in shared memory; larger frames
#: work in a scratch buffer in device memory (csrc/spectral.cu takes at
#: most 40 KiB of dynamic shared memory a block)
QR_SHARED_ROWS = 40 * 1024 // 48
KMEANS_SHARED_ROWS = 40 * 1024 // 8

#: launches of each kernel since the last reset; the plain versions count
#: in none
affinity_launches = 0
qr_launches = 0
span_launches = 0
kmeans_launches = 0


def sq_distances(a, b, box, handle_pbc):
    """(B, n, m) squared (min-image) distances between (B, n, 3) and
    (B, m, 3) points, summed over the components in order, as the JAX
    package sums its (…, 3) differences."""
    total = None
    for k in range(3):
        d = a[:, :, None, k] - b[:, None, :, k]
        if handle_pbc:
            d = min_image(d, box[:, None, None, k])
        total = d * d if total is None else total + d * d
    return total


def _frames_of(name, t, width, device):
    """Check a (B, n, width) contiguous f32 tensor on `device`; → n."""
    if t.dim() != 3 or t.shape[-1] != width:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"(n_frames, n, {width})")
    check_tensor(name, t, torch.float32, tuple(t.shape), device)
    return int(t.shape[1])


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------- spectral_affinity


def spectral_affinity_plain(heads, box_diag, handle_pbc: bool,
                            sigma: float):
    """(B, n, 3) f32 heads → ((B, n, n) f32 S, (B, n) f32 degree), op by op
    as gorder_tpu forms them: W = exp(−σ d²), the degree W·1, D^{-1/2}
    where the degree > 1e-10 (else 0), S = (W · D_i^{-1/2}) · D_j^{-1/2}."""
    w = torch.exp(-sigma * sq_distances(heads, heads, box_diag, handle_pbc))
    degree = w.sum(-1)
    d_inv_sqrt = torch.where(degree > 1e-10, 1.0 / torch.sqrt(degree),
                             torch.zeros_like(degree))
    return w * d_inv_sqrt[:, :, None] * d_inv_sqrt[:, None, :], degree


def spectral_affinity(heads, box_diag, handle_pbc: bool, sigma: float):
    """(B, n, 3) f32 head positions and (B, 3) f32 box lengths → ((B, n, n)
    f32 normalized similarity S, (B, n) f32 degree). The kernel sums the
    degrees in f64 and rounds them once, so S and the degrees agree with
    the plain version's to a few f32 ulps."""
    global affinity_launches
    device = device_of(heads)
    n = _frames_of("heads", heads, 3, device)
    check_tensor("box_diag", box_diag, torch.float32, (heads.shape[0], 3),
                 device)
    if device.type == "cpu":
        return spectral_affinity_plain(heads, box_diag, handle_pbc, sigma)
    n_frames = heads.shape[0]
    s_mat = torch.empty((n_frames, n, n), dtype=torch.float32, device=device)
    degree = torch.empty((n_frames, n), dtype=torch.float32, device=device)
    if not degree.numel():
        return s_mat, degree
    with torch.cuda.device(device):
        call("spectral_affinity", heads.data_ptr(), box_diag.data_ptr(),
             s_mat.data_ptr(), degree.data_ptr(), n_frames, n, float(sigma),
             int(handle_pbc), min(AFFINITY_TILE, n), _stream(device))
    affinity_launches += 1
    return s_mat, degree


# ---------------------------------------------------------------- thin_qr3


def thin_qr3_plain(a):
    """(B, n, 3) f32 → (B, n, 3) f32 Q: the kernel's three Householder
    reflections in f64 as torch ops. Reflector k of x = A[k:, k]: v = x −
    α e₀, α = −sign(x₀)‖x‖, vᵀv = 2‖x‖(‖x‖ + |x₀|), skipped for a zero
    column; applied to the later columns, then in reverse to the first
    three columns of the identity."""
    x = a.to(torch.float64)
    n_frames, n = x.shape[:2]
    reflectors = []
    for k in range(3):
        col = x[:, k:, k]
        norm = torch.linalg.vector_norm(col, dim=-1)
        x0 = col[:, 0]
        alpha = torch.where(x0 >= 0, -norm, norm)
        v = torch.cat([(x0 - alpha)[:, None], col[:, 1:]], dim=1)
        vv = 2.0 * norm * (norm + x0.abs())
        scale = torch.where(vv > 0, 2.0 / torch.where(vv > 0, vv, 1.0),
                            torch.zeros_like(vv))
        reflectors.append((v, scale))
        if k < 2:
            rest = x[:, k:, k + 1:]
            dots = (v[..., None] * rest).sum(1)                  # (B, 2-k)
            x = x.clone()
            x[:, k:, k + 1:] = rest - (scale[:, None, None] * v[..., None]
                                       * dots[:, None, :])
    q = torch.eye(n, 3, dtype=torch.float64, device=a.device).repeat(
        n_frames, 1, 1)
    for k in (2, 1, 0):
        v, scale = reflectors[k]
        rest = q[:, k:, :]
        dots = (v[..., None] * rest).sum(1)                      # (B, 3)
        q[:, k:, :] = rest - (scale[:, None, None] * v[..., None]
                              * dots[:, None, :])
    return q.to(torch.float32)


def thin_qr3(a):
    """(B, n, 3) f32, n ≥ 3 → (B, n, 3) f32 with orthonormal columns,
    span(Q[:, :k]) = span(A[:, :k]) for k = 1, 2, 3 (the reduced QR's Q,
    up to the signs of its columns): Householder in f64."""
    global qr_launches
    device = device_of(a)
    n = _frames_of("a", a, 3, device)
    if n < 3:
        raise ValueError(f"a has {n} rows, a thin QR of 3 columns needs 3")
    if device.type == "cpu":
        return thin_qr3_plain(a)
    n_frames = a.shape[0]
    q = torch.empty_like(a)
    if not q.numel():
        return q
    scratch = (None if n <= QR_SHARED_ROWS else
               torch.empty((n_frames, 6 * n), dtype=torch.float64,
                           device=device))
    with torch.cuda.device(device):
        call("thin_qr3", a.data_ptr(), q.data_ptr(),
             None if scratch is None else scratch.data_ptr(), n_frames, n,
             _stream(device))
    qr_launches += 1
    return q


# --------------------------------------------------------------- top2_span


def top2_span_plain(span, degree):
    """(B, n, 3) span and (B, n) degree → (B, n, 2) f32, in f64: v0 =
    √max(degree, 0) / max(‖·‖, 1e-30), the deflated D = span − v0 (v0ᵀ
    span), the eigenpairs of its 3 × 3 Gram DᵀD, and U_k = D V_k /
    max(σ_k, 1e-30) for the two largest σ_k = √λ_k."""
    d = span.to(torch.float64)
    v0 = torch.sqrt(torch.clamp(degree.to(torch.float64), min=0.0))
    v0 = v0 / torch.clamp(torch.linalg.vector_norm(v0, dim=-1, keepdim=True),
                          min=1e-30)
    d = d - v0[..., None] * (v0[..., None] * d).sum(1)[:, None, :]
    lam, vec = torch.linalg.eigh(d.transpose(1, 2) @ d)         # ascending
    lam, vec = lam[:, [2, 1]], vec[..., [2, 1]]
    sigma = torch.clamp(torch.sqrt(torch.clamp(lam, min=0.0)), min=1e-30)
    return ((d @ vec) / sigma[:, None, :]).to(torch.float32)


def top2_span(span, degree):
    """(B, n, 3) f32 span and (B, n) f32 degree → (B, n, 2) f32: the two
    leading left singular vectors of the span with v0 = D^{1/2}·1 / ‖·‖
    deflated (the third, σ ≈ 0 after deflation, is never formed)."""
    global span_launches
    device = device_of(span)
    n = _frames_of("span", span, 3, device)
    check_tensor("degree", degree, torch.float32, (span.shape[0], n),
                 device)
    if device.type == "cpu":
        return top2_span_plain(span, degree)
    u2 = torch.empty((span.shape[0], n, 2), dtype=torch.float32,
                     device=device)
    if not u2.numel():
        return u2
    with torch.cuda.device(device):
        call("top2_span", span.data_ptr(), degree.data_ptr(), u2.data_ptr(),
             span.shape[0], n, _stream(device))
    span_launches += 1
    return u2


# --------------------------------------------------------- rayleigh_kmeans


def rayleigh_embedding(u2, lu2):
    """Rayleigh–Ritz the normalized Laplacian within each frame's deflated
    2-D span (B, n, 2), given its products `lu2` = lap(u2) (B, n, 2),
    shrink the higher-energy direction by √(λ₁/λ₂), then normalize the
    rows (gorder_tpu/core/clustering.py:198-235: the inter-cluster
    indicator stays dominant whatever the span's rotation)."""
    a, b = u2[..., 0], u2[..., 1]
    h00 = (a * lu2[..., 0]).sum(-1)
    h01 = (a * lu2[..., 1]).sum(-1)
    h11 = (b * lu2[..., 1]).sum(-1)
    h = torch.stack([torch.stack([h00, h01], -1),
                     torch.stack([h01, h11], -1)], -2)          # (B, 2, 2)
    lam, q = torch.linalg.eigh(h)                               # ascending
    v = u2 @ q
    lam = torch.clamp(lam, min=1e-9)
    w = torch.sqrt(lam[:, 0] / lam[:, 1])                       # ≤ 1
    embedding = torch.stack([v[..., 0], v[..., 1] * w[:, None]], dim=-1)
    norm = torch.sqrt((embedding ** 2).sum(-1, keepdim=True))
    return torch.where(norm > 1e-10, embedding / norm, embedding)


def kmeans2(embedding, iters: int):
    """(B, n, k) → (B, n) int32 labels: deterministic k-means with k = 2,
    farthest-point init (c0 = row 0, c1 = the row farthest from it) and
    `iters` fixed iterations; an empty cluster falls back to row 0
    (gorder_tpu/core/clustering.py:51-83)."""
    first = embedding[:, 0]                                   # (B, k)
    far = torch.argmax(((embedding - first[:, None]) ** 2).sum(-1), dim=1)
    rows = torch.arange(embedding.shape[0], device=embedding.device)
    c0, c1 = first, embedding[rows, far]
    for _ in range(iters):
        d0 = ((embedding - c0[:, None]) ** 2).sum(-1)
        d1 = ((embedding - c1[:, None]) ** 2).sum(-1)
        w1 = (d1 < d0).to(embedding.dtype)[..., None]         # (B, n, 1)
        w0 = 1.0 - w1
        n0, n1 = w0.sum(dim=(1, 2)), w1.sum(dim=(1, 2))       # (B,)
        c0 = (embedding * w0).sum(1) / torch.clamp(n0, min=1.0)[:, None]
        c1 = (embedding * w1).sum(1) / torch.clamp(n1, min=1.0)[:, None]
        c0 = torch.where((n0 > 0)[:, None], c0, first)
        c1 = torch.where((n1 > 0)[:, None], c1, first)
    d0 = ((embedding - c0[:, None]) ** 2).sum(-1)
    d1 = ((embedding - c1[:, None]) ** 2).sum(-1)
    return (d1 < d0).to(torch.int32)


def rayleigh_kmeans_plain(u2, lu2, iters: int):
    """`kmeans2(rayleigh_embedding(u2, lu2), iters)`, in f32 as gorder_tpu
    computes them."""
    return kmeans2(rayleigh_embedding(u2, lu2), iters)


def rayleigh_kmeans(u2, lu2, iters: int):
    """(B, n, 2) f32 span u2 and its Laplacian products lap(u2) (B, n, 2)
    f32 → (B, n) int32 raw k-means labels of the energy-weighted embedding
    after `iters` steps. The kernel takes the Rayleigh matrix, the
    embedding and the centroids' sums in f64 and rounds the embedding and
    the centroids to f32."""
    global kmeans_launches
    device = device_of(u2)
    n = _frames_of("u2", u2, 2, device)
    check_tensor("lu2", lu2, torch.float32, tuple(u2.shape), device)
    if n < 1:
        raise ValueError("u2 has no rows")
    if iters < 0:
        raise ValueError(f"iters {iters} < 0")
    if device.type == "cpu":
        return rayleigh_kmeans_plain(u2, lu2, iters)
    n_frames = u2.shape[0]
    labels = torch.empty((n_frames, n), dtype=torch.int32, device=device)
    if not labels.numel():
        return labels
    scratch = None if n <= KMEANS_SHARED_ROWS else torch.empty_like(u2)
    with torch.cuda.device(device):
        call("rayleigh_kmeans", u2.data_ptr(), lu2.data_ptr(),
             labels.data_ptr(),
             None if scratch is None else scratch.data_ptr(), n_frames, n,
             iters, _stream(device))
    kmeans_launches += 1
    return labels


class Ops(NamedTuple):
    """The four passes `core/clustering.py` takes a frame batch through."""
    affinity: Callable
    thin_qr3: Callable
    top2_span: Callable
    rayleigh_kmeans: Callable


#: the wrappers (the kernel on the card, the plain version on the CPU)
WRAPPERS = Ops(spectral_affinity, thin_qr3, top2_span, rayleigh_kmeans)
#: the plain versions on any device: what the card's kernels are held to
PLAIN = Ops(spectral_affinity_plain, thin_qr3_plain, top2_span_plain,
            rayleigh_kmeans_plain)


def require_f32_matmuls(device) -> None:
    """Raise unless f32 products on `device` run in full f32: on the card
    TF32 off (`torch.backends.cuda.matmul.allow_tf32`) and the f32 matmul
    precision "highest" (PyTorch's defaults). The filter's squarings and
    the subspace products need them."""
    if torch.device(device).type != "cuda":
        return
    precision = torch.get_float32_matmul_precision()
    if torch.backends.cuda.matmul.allow_tf32 or precision != "highest":
        raise RuntimeError(f"TF32 matmuls are on (allow_tf32 "
                           f"{torch.backends.cuda.matmul.allow_tf32}, "
                           f"precision {precision!r}): the spectral "
                           f"classifier needs f32 products")
