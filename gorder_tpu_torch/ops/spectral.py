"""The spectral leaflet classifier's kernels' wrappers and their plain
PyTorch versions: the similarity pass, the subspace iteration of the top
three eigenvectors, the two leading directions of the deflated span with
their Laplacian products, and the energy-weighted embedding with its
k-means (`core/clustering.py` calls them for a batch of frames).

`spectral_affinity` gives, per frame, the similarity S = D^{-1/2} W D^{-1/2}
of W = exp(−σ d²) over the heads and the degrees D, as
`gorder_tpu/core/clustering.py _spectral_labels` (:159-176) forms them;
`top3_subspace` an orthonormal basis of the top-3 eigenspace by the
subspace iteration of `_top3_subspace` after its filter (its QRs
`jnp.linalg.qr` :136, :144, :149 and its products), given the filtered
matrix, the matrix and the start basis; `top2_span` the two leading left
singular vectors of the span with the analytic top vector D^{1/2}·1
deflated (:189-190, :315-317) and, given S, their normalized-Laplacian
products u2 − S u2 (:192); `rayleigh_kmeans` the raw k-means labels of
the energy-weighted embedding (`_rayleigh_weighted` :198-235, `_kmeans2`
:51-83), given the span's Laplacian products. None is a Pallas kernel in
gorder_tpu: there all are XLA ops.

The kernels pick their path from the frame's size (`affinity_plan`,
`subspace_plan`, `kmeans_plan`): the similarity holds a frame's upper
triangle of weights on chip and computes each weight once where it fits
(up to 288 heads), else takes two passes over the heads; the subspace
iteration streams its matrices through a ring of tiles in shared memory
up to 1,024 rows, else reads them straight from device memory, its
working columns in shared memory up to 3,657 rows, else in device
memory; the k-means runs one warp a frame up to 256 rows,
else one block, and stops at the fixed point of its labels, which are
then the labels `iters` steps give (`kmeans2_fixed_point` is its plain
counterpart).

For tensors on the CPU the wrappers run the plain versions; for CUDA
tensors they launch the hand-written kernels (`csrc/spectral.cu`) on the
current stream, or raise. The wrappers alone choose between the two, and
there is no fallback from a kernel to its plain version. All check their
arguments on either device. The subspace iteration and the span run in
f64, as the kernels do: the filter hands the QRs inputs with condition
numbers up to 7.8e7, whose orthogonality f32 Gram–Schmidt or Cholesky-QR
lose. The third column of a QR of such an input is set by rounding, and
the span's two directions are equal in energy, so a kernel and its plain
version agree on the spaces they span (their projectors), not column by
column; the labels, which depend only on distances within the embedding,
agree exactly. The kernels read S and the filtered matrix by columns
(products with the transpose): both are symmetric but for the last ulp,
and the plain versions take the same transpose.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.pbc import min_image
from .build import call, check_tensor, device_of

#: the shared memory a spectral_affinity block may take for a frame's
#: triangle of weights (the card's 227 KiB a block, csrc/spectral.cu
#: kMaxShared); a larger frame takes the two passes
AFFINITY_TRIANGLE_BYTES = 227 * 1024
#: heads a two-pass spectral_affinity block keeps in shared memory at a
#: time (16 bytes a head: x, y, z and 1/√degree)
AFFINITY_TILE = 1024
#: the bytes a row of top3_subspace's working columns takes (Q and the
#: product y, 7 f64), and the shared memory a block may take for them and
#: its ring: the rows of larger frames work in a scratch buffer in device
#: memory
SUBSPACE_ROW_BYTES = 56
SUBSPACE_SHARED_BYTES = 200 * 1024
#: top3_subspace's ring of matrix tiles (csrc/spectral.cu kRingBytes: four
#: stages of 32 KiB), and the rows it takes (four columns a thread of 256)
SUBSPACE_RING_BYTES = 4 * 32 * 1024
SUBSPACE_RING_ROWS = 1024
#: the filtered steps of the subspace iteration (`core/clustering.py
#: _top3_subspace`), before its one unfiltered step
SUBSPACE_ITERS = 4
#: rows rayleigh_kmeans' one-block path (8 bytes a row) keeps in shared
#: memory; larger frames work in a scratch buffer in device memory (csrc/
#: spectral.cu takes at most 40 KiB of dynamic shared memory a block there)
KMEANS_SHARED_ROWS = 40 * 1024 // 8
#: rows rayleigh_kmeans takes with one warp a frame (8 a lane, in
#: registers: csrc/spectral.cu kWarpRows); larger frames take one block
KMEANS_WARP_ROWS = 256

#: launches of each kernel since the last reset; the plain versions count
#: in none
affinity_launches = 0
subspace_launches = 0
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


def triangle_bytes(n: int) -> int:
    """Shared memory of spectral_affinity's triangle path for a frame of n
    heads (csrc/spectral.cu triangle_bytes): the upper triangle's T(T+1)/2
    tiles of 32 × 32 f32, T = ⌈n/32⌉; each head's T f64 parts of its
    degree (one a tile of 32 heads), its 1/√degree and its x, y, z in two
    frames; and two frames' flags of each of the 32 warps."""
    t = -(-n // 32)
    return t * (t + 1) // 2 * 32 * 32 * 4 + (8 * t + 28) * n + 256


class AffinityPlan(NamedTuple):
    """How spectral_affinity takes a frame: "triangle" (the frame's weights
    on chip, each computed once) or "two-pass" (`tile` heads at a time,
    each weight computed twice), and the shared memory of its block."""
    path: str
    tile: int
    shared_bytes: int


def affinity_plan(n: int) -> AffinityPlan:
    """The path of spectral_affinity for frames of n heads: the triangle
    where it fits AFFINITY_TRIANGLE_BYTES (up to 288 heads), else two
    passes."""
    tri = triangle_bytes(n)
    if tri <= AFFINITY_TRIANGLE_BYTES:
        return AffinityPlan("triangle", 0, tri)
    tile = min(AFFINITY_TILE, n)
    return AffinityPlan("two-pass", tile, 16 * tile)


def affinity_weights_plain(heads, box_diag, handle_pbc: bool, sigma: float):
    """(B, n, 3) f32 heads → (B, n, n) f32 W = exp(−σ d²), d the
    (min-imaged) p_i − p_j summed over the components in order. The
    minimum image is odd in d, so W is symmetric bit for bit: the kernel
    computes each w_ij = w_ji once."""
    return torch.exp(-sigma * sq_distances(heads, heads, box_diag,
                                           handle_pbc))


def spectral_affinity_plain(heads, box_diag, handle_pbc: bool,
                            sigma: float):
    """(B, n, 3) f32 heads → ((B, n, n) f32 S, (B, n) f32 degree), op by op
    as gorder_tpu forms them: W = exp(−σ d²), the degree W·1, D^{-1/2}
    where the degree > 1e-10 (else 0), S = (W · D_i^{-1/2}) · D_j^{-1/2}."""
    w = affinity_weights_plain(heads, box_diag, handle_pbc, sigma)
    degree = w.sum(-1)
    d_inv_sqrt = torch.where(degree > 1e-10, 1.0 / torch.sqrt(degree),
                             torch.zeros_like(degree))
    return w * d_inv_sqrt[:, :, None] * d_inv_sqrt[:, None, :], degree


def spectral_affinity(heads, box_diag, handle_pbc: bool, sigma: float):
    """(B, n, 3) f32 head positions and (B, 3) f32 box lengths → ((B, n, n)
    f32 normalized similarity S, (B, n) f32 degree). The kernel sums a
    degree in f64 in a fixed order (the row a tile of 32 heads at a time,
    in index order, the tiles' sums in order) and rounds it once, so S and
    the degrees agree with the plain version's to a few f32 ulps; its two
    paths (`affinity_plan`) give the same bits."""
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
    plan = affinity_plan(n)
    with torch.cuda.device(device):
        call("spectral_affinity", heads.data_ptr(), box_diag.data_ptr(),
             s_mat.data_ptr(), degree.data_ptr(), n_frames, n, float(sigma),
             int(handle_pbc), int(plan.path == "triangle"), plan.tile,
             _stream(device))
    affinity_launches += 1
    return s_mat, degree


# ------------------------------------------------------------ top3_subspace


def householder_q(x):
    """(B, n, 3) f64 → (B, n, 3) f64 Q: three Householder reflections as
    torch ops. Reflector k of x = A[k:, k]: v = x − α e₀, α = −sign(x₀)‖x‖,
    vᵀv = 2‖x‖(‖x‖ + |x₀|), skipped for a zero column; applied to the
    later columns, then in reverse to the first three columns of the
    identity."""
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
    q = torch.eye(n, 3, dtype=x.dtype, device=x.device).repeat(
        n_frames, 1, 1)
    for k in (2, 1, 0):
        v, scale = reflectors[k]
        rest = q[:, k:, :]
        dots = (v[..., None] * rest).sum(1)                      # (B, 3)
        q[:, k:, :] = rest - (scale[:, None, None] * v[..., None]
                              * dots[:, None, :])
    return q


def thin_qr3_plain(a):
    """(B, n, 3) f32 → (B, n, 3) f32 Q with orthonormal columns,
    span(Q[:, :k]) = span(A[:, :k]) for k = 1, 2, 3 (the reduced QR's Q,
    up to the signs of its columns): `householder_q` in f64, rounded once.
    The QR of each step of `top3_subspace_plain`, there without the
    rounding."""
    return householder_q(a.to(torch.float64)).to(torch.float32)


class SubspacePlan(NamedTuple):
    """How top3_subspace takes a frame: "ring" (the matrices stream
    through a ring of tiles in shared memory, the working columns, Q and
    the product y, beside it; its 128 KiB leave one persistent block an
    SM, and the frames in flight, 256 KiB each at 256 rows, within the
    card's 50 MB L2, which serves the later passes over each frame),
    "shared" (the matrices read straight from device memory, the working
    columns in shared memory) or "device" (those in a scratch buffer); and
    its block's shared memory."""
    path: str
    shared_bytes: int


def subspace_plan(n: int) -> SubspacePlan:
    """The path of top3_subspace for frames of n rows: the ring up to
    SUBSPACE_RING_ROWS rows where the ring and the working columns (56
    bytes a row) fit SUBSPACE_SHARED_BYTES (the dense path's 256 heads,
    Nyström's 1,024 landmarks), else the working columns alone where they
    fit (up to 3,657 rows), else device memory."""
    columns = SUBSPACE_ROW_BYTES * n
    if (n <= SUBSPACE_RING_ROWS
            and SUBSPACE_RING_BYTES + columns <= SUBSPACE_SHARED_BYTES):
        return SubspacePlan("ring", SUBSPACE_RING_BYTES + columns)
    if columns <= SUBSPACE_SHARED_BYTES:
        return SubspacePlan("shared", columns)
    return SubspacePlan("device", 0)


def _check_subspace(gp, s_mat, start, device):
    n = _frames_of("start", start, 3, device)
    if n < 3:
        raise ValueError(f"start has {n} rows, a basis of 3 columns needs 3")
    for name, m in (("gp", gp), ("s_mat", s_mat)):
        check_tensor(name, m, torch.float32, (start.shape[0], n, n), device)
    return n


def top3_subspace_plain(gp, s_mat, start):
    """(B, n, n) f32 filtered and unfiltered matrices and a (B, n, 3) f32
    start basis → (B, n, 3) f32: Q of the start, then SUBSPACE_ITERS steps
    Q ← QR(gpᵀ Q) and one Q ← QR(s_matᵀ Q), each product of the f32 matrix
    and the f64 Q in f64, Q (`householder_q`) in f64 between the steps and
    rounded to f32 once. The matrices are symmetric up to an ulp (S_ij =
    (w_ij d_i) d_j against (w_ij d_j) d_i), so ᵀ is the kernel's reading
    of them by columns, not another function."""
    q = householder_q(start.to(torch.float64))
    for m in (gp,) * SUBSPACE_ITERS + (s_mat,):
        q = householder_q(m.transpose(1, 2).to(torch.float64) @ q)
    return q.to(torch.float32)


def top3_subspace(gp, s_mat, start):
    """(B, n, n) f32 filtered matrices `gp` (the similarity squared and
    rescaled), their unfiltered `s_mat` and (B, n, 3) f32 start bases, n
    ≥ 3 → (B, n, 3) f32 orthonormal bases of the top-3 subspaces: the
    subspace iteration of `core/clustering.py _top3_subspace` after its
    squarings, one launch a batch (`top3_subspace_plain` is its plain
    version)."""
    global subspace_launches
    device = device_of(start)
    n = _check_subspace(gp, s_mat, start, device)
    if device.type == "cpu":
        return top3_subspace_plain(gp, s_mat, start)
    n_frames = start.shape[0]
    q = torch.empty_like(start)
    if not q.numel():
        return q
    plan = subspace_plan(n)
    scratch = (None if plan.path != "device" else
               torch.empty((n_frames, 8 * n), dtype=torch.float64,
                           device=device))
    with torch.cuda.device(device):
        call("top3_subspace", gp.data_ptr(), s_mat.data_ptr(),
             start.data_ptr(), q.data_ptr(),
             None if scratch is None else scratch.data_ptr(), n_frames, n,
             SUBSPACE_ITERS, int(plan.path == "ring"), _stream(device))
    subspace_launches += 1
    return q


# --------------------------------------------------------------- top2_span


def top2_span_plain(span, degree, s_mat=None):
    """(B, n, 3) span and (B, n) degree → (B, n, 2) f32, in f64: v0 =
    √max(degree, 0) / max(‖·‖, 1e-30), the deflated D = span − v0 (v0ᵀ
    span), the eigenpairs of its 3 × 3 Gram DᵀD, and U_k = D V_k /
    max(σ_k, 1e-30) for the two largest σ_k = √λ_k. With a (B, n, n)
    `s_mat`, → (u2, lap(u2)): also u2's normalized-Laplacian products u2 −
    s_matᵀ u2 of the f32 u2, the product in f64, rounded once."""
    d = span.to(torch.float64)
    v0 = torch.sqrt(torch.clamp(degree.to(torch.float64), min=0.0))
    v0 = v0 / torch.clamp(torch.linalg.vector_norm(v0, dim=-1, keepdim=True),
                          min=1e-30)
    d = d - v0[..., None] * (v0[..., None] * d).sum(1)[:, None, :]
    lam, vec = torch.linalg.eigh(d.transpose(1, 2) @ d)         # ascending
    lam, vec = lam[:, [2, 1]], vec[..., [2, 1]]
    sigma = torch.clamp(torch.sqrt(torch.clamp(lam, min=0.0)), min=1e-30)
    u2 = ((d @ vec) / sigma[:, None, :]).to(torch.float32)
    if s_mat is None:
        return u2
    x = u2.to(torch.float64)
    return u2, (x - s_mat.transpose(1, 2).to(torch.float64) @ x).to(
        torch.float32)


def top2_span(span, degree, s_mat=None):
    """(B, n, 3) f32 span and (B, n) f32 degree → (B, n, 2) f32: the two
    leading left singular vectors of the span with v0 = D^{1/2}·1 / ‖·‖
    deflated (the third, σ ≈ 0 after deflation, is never formed). With a
    (B, n, n) f32 `s_mat` (the dense path's similarity) → (u2, lap(u2) =
    u2 − s_matᵀ u2), both in the one launch."""
    global span_launches
    device = device_of(span)
    n = _frames_of("span", span, 3, device)
    check_tensor("degree", degree, torch.float32, (span.shape[0], n),
                 device)
    if s_mat is not None:
        check_tensor("s_mat", s_mat, torch.float32, (span.shape[0], n, n),
                     device)
    if device.type == "cpu":
        return top2_span_plain(span, degree, s_mat)
    u2 = torch.empty((span.shape[0], n, 2), dtype=torch.float32,
                     device=device)
    lu2 = None if s_mat is None else torch.empty_like(u2)
    if u2.numel():
        with torch.cuda.device(device):
            call("top2_span", span.data_ptr(), degree.data_ptr(),
                 None if s_mat is None else s_mat.data_ptr(), u2.data_ptr(),
                 None if lu2 is None else lu2.data_ptr(), span.shape[0], n,
                 _stream(device))
        span_launches += 1
    return u2 if s_mat is None else (u2, lu2)


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


def _farthest_start(embedding):
    """kmeans2's start: (row 0, the row farthest from it), the lowest row
    on ties (torch.argmax)."""
    first = embedding[:, 0]                                   # (B, k)
    far = torch.argmax(((embedding - first[:, None]) ** 2).sum(-1), dim=1)
    rows = torch.arange(embedding.shape[0], device=embedding.device)
    return first, embedding[rows, far]


def _assign(embedding, c0, c1):
    """(B, n) bool: the rows nearer c1 than c0."""
    d0 = ((embedding - c0[:, None]) ** 2).sum(-1)
    d1 = ((embedding - c1[:, None]) ** 2).sum(-1)
    return d1 < d0


def _centroids(embedding, ones, first):
    """The centroids of the rows labelled 0 and 1 (`ones`), row 0 for an
    empty cluster."""
    w1 = ones.to(embedding.dtype)[..., None]                  # (B, n, 1)
    w0 = 1.0 - w1
    n0, n1 = w0.sum(dim=(1, 2)), w1.sum(dim=(1, 2))           # (B,)
    c0 = (embedding * w0).sum(1) / torch.clamp(n0, min=1.0)[:, None]
    c1 = (embedding * w1).sum(1) / torch.clamp(n1, min=1.0)[:, None]
    return (torch.where((n0 > 0)[:, None], c0, first),
            torch.where((n1 > 0)[:, None], c1, first))


def kmeans2(embedding, iters: int):
    """(B, n, k) → (B, n) int32 labels: deterministic k-means with k = 2,
    farthest-point init (c0 = row 0, c1 = the row farthest from it) and
    `iters` fixed iterations; an empty cluster falls back to row 0
    (gorder_tpu/core/clustering.py:51-83)."""
    first, c1 = _farthest_start(embedding)
    c0 = first
    for _ in range(iters):
        c0, c1 = _centroids(embedding, _assign(embedding, c0, c1), first)
    return _assign(embedding, c0, c1).to(torch.int32)


def kmeans2_fixed_point(embedding, iters: int):
    """`kmeans2`, stopped where the rayleigh_kmeans kernel stops: at the
    first step t ≥ 2 whose labels equal step t − 1's, whose labels are
    then the final ones (a step's centroids are a function of its labels,
    so every later step repeats it). → ((B, n) int32 labels, equal to
    `kmeans2(embedding, iters)`'s; (B,) int32 centroid updates each frame
    ran: t − 1, or `iters` where the labels never repeat)."""
    first, c1 = _farthest_start(embedding)
    c0 = first
    n_frames = embedding.shape[0]
    labels = torch.zeros(embedding.shape[:2], dtype=torch.int32,
                         device=embedding.device)
    steps = torch.full((n_frames,), iters, dtype=torch.int32,
                       device=embedding.device)
    done = torch.zeros(n_frames, dtype=torch.bool, device=embedding.device)
    before = None
    for it in range(iters):
        ones = _assign(embedding, c0, c1)
        if before is not None:
            now = (ones == before).all(-1) & ~done
            labels[now] = ones[now].to(torch.int32)
            steps[now] = it
            done |= now
            if bool(done.all()):
                return labels, steps
        before = ones
        c0, c1 = _centroids(embedding, ones, first)
    rest = ~done
    labels[rest] = _assign(embedding, c0, c1)[rest].to(torch.int32)
    return labels, steps


def rayleigh_kmeans_plain(u2, lu2, iters: int):
    """`kmeans2(rayleigh_embedding(u2, lu2), iters)`, in f32 as gorder_tpu
    computes them."""
    return kmeans2(rayleigh_embedding(u2, lu2), iters)


class KmeansPlan(NamedTuple):
    """How rayleigh_kmeans takes a frame: "warp" (one warp a frame, the
    rows in registers), "shared" or "device" (one block a frame, the rows
    in shared memory or a scratch buffer), and that shared memory."""
    path: str
    shared_bytes: int


def kmeans_plan(n: int) -> KmeansPlan:
    """The path of rayleigh_kmeans for frames of n rows: one warp up to
    KMEANS_WARP_ROWS, else one block, its rows in shared memory up to
    KMEANS_SHARED_ROWS."""
    if n <= KMEANS_WARP_ROWS:
        return KmeansPlan("warp", 0)
    if n <= KMEANS_SHARED_ROWS:
        return KmeansPlan("shared", 8 * n)
    return KmeansPlan("device", 0)


def rayleigh_kmeans(u2, lu2, iters: int, steps=None):
    """(B, n, 2) f32 span u2 and its Laplacian products lap(u2) (B, n, 2)
    f32 → (B, n) int32 raw k-means labels of the energy-weighted embedding
    after `iters` steps. The kernel takes the Rayleigh matrix, the
    embedding and the centroids' sums in f64, rounds the embedding and the
    centroids to f32, and stops at the fixed point of its labels. `steps`,
    a (B,) int32 tensor on the same device, takes the centroid updates
    each frame ran (on the CPU: `kmeans2_fixed_point`'s, whose labels it
    then returns)."""
    global kmeans_launches
    device = device_of(u2)
    n = _frames_of("u2", u2, 2, device)
    check_tensor("lu2", lu2, torch.float32, tuple(u2.shape), device)
    if steps is not None:
        check_tensor("steps", steps, torch.int32, (u2.shape[0],), device)
    if n < 1:
        raise ValueError("u2 has no rows")
    if iters < 0:
        raise ValueError(f"iters {iters} < 0")
    if device.type == "cpu":
        if steps is None:
            return rayleigh_kmeans_plain(u2, lu2, iters)
        labels, ran = kmeans2_fixed_point(rayleigh_embedding(u2, lu2), iters)
        steps.copy_(ran)
        return labels
    n_frames = u2.shape[0]
    labels = torch.empty((n_frames, n), dtype=torch.int32, device=device)
    if not labels.numel():
        return labels
    plan = kmeans_plan(n)
    scratch = torch.empty_like(u2) if plan.path == "device" else None
    with torch.cuda.device(device):
        call("rayleigh_kmeans", u2.data_ptr(), lu2.data_ptr(),
             labels.data_ptr(), None if steps is None else steps.data_ptr(),
             None if scratch is None else scratch.data_ptr(), n_frames, n,
             iters, int(plan.path == "warp"), _stream(device))
    kmeans_launches += 1
    return labels


class Ops(NamedTuple):
    """The four passes `core/clustering.py` takes a frame batch through."""
    affinity: Callable
    top3_subspace: Callable
    top2_span: Callable
    rayleigh_kmeans: Callable


#: the wrappers (the kernel on the card, the plain version on the CPU)
WRAPPERS = Ops(spectral_affinity, top3_subspace, top2_span, rayleigh_kmeans)
#: the plain versions on any device: what the card's kernels are held to
PLAIN = Ops(spectral_affinity_plain, top3_subspace_plain, top2_span_plain,
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
