"""The spectral classifier's passes in the port (gorder_tpu_torch/ops/
spectral.py) on the CPU, where the wrappers run their plain versions;
tests/test_torch_kernels.py holds the kernels against them on the card.

Each plain version against its `gorder_tpu.core.clustering` counterpart
on the same inputs, made with numpy from a seed:

- `thin_qr3_plain` (the QR of each step of `top3_subspace_plain`) against
  `jnp.linalg.qr`: both orthonormal, ‖QᵀQ − I‖ ≤ 1e-5; on a random
  well-conditioned input the projectors of all three columns within 1e-5,
  on the filter's ill-conditioned input (a 256-head bilayer's similarity
  squared 12 times times its start basis, condition number ~1e7) those of
  the first two: the third column is set by rounding there;
- `top3_subspace_plain` through `core/clustering.py _top3_subspace`
  against JAX's `_top3_subspace` on those bilayers' similarities: the
  projectors of the first two columns within 1e-4 (the f32 filter leaves
  the third eigenvalue below its rounding, so JAX's f32 products and the
  plain version's f64 ones set the third column differently);
- `top2_span_plain` against JAX's deflation and `jnp.linalg.svd`: the
  projectors of the top two within 1e-5 (their singular values are equal,
  so the basis may rotate); with S, the same u2 and its Laplacian products
  within 1e-6 of JAX's `u2 − S u2`;
- `rayleigh_kmeans_plain` against `_kmeans2(_rayleigh_weighted(...))`:
  labels equal, also with a tie for the farthest row and with a cluster
  left empty;
- `spectral_affinity_plain` against JAX's S and degree: rtol 1e-6, with
  and without PBC (an entry below f32's normal range, 2^-126, carries
  fewer bits: atol 2^-126).

What the kernels' designs stand on, on the plain versions:

- W is symmetric bit for bit (`affinity_weights_plain`, torch.equal with
  its transpose) on the three systems with and without PBC and on heads
  at and one ulp either side of minimum-image ties, in and outside the
  box: the similarity kernel computes each w_ij = w_ji once;
- k-means stopped at the first step whose labels repeat the previous
  step's (`kmeans2_fixed_point`, the kernel's exit) gives the 100-step
  labels on every frame, and JAX's;
- the kernels' paths (`affinity_plan`, `subspace_plan`, `kmeans_plan`) at
  their limits and either side of them.

The norms are spectral norms of the differences. The wrappers give the
plain versions' tensors bit for bit on the CPU and count no launch, and
refuse a wrong dtype, shape, layout or device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorder_tpu.core import clustering as jc
from gorder_tpu_torch.core import clustering as tc
from gorder_tpu_torch.ops import spectral

from .test_torch_clustering import systems  # noqa: F401
from .test_torch_clustering_pipeline import one_torch_thread

#: the smallest normal f32: below it an entry carries fewer bits
TINY = 2.0 ** -126


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _norm2(a):
    """Spectral norm of each (…, m, m) matrix, the largest of a batch."""
    return float(np.linalg.norm(np.asarray(a, np.float64), 2,
                                axis=(-2, -1)).max())


def _orthonormality(q):
    q = np.asarray(q, np.float64)
    return _norm2(np.swapaxes(q, -1, -2) @ q - np.eye(q.shape[-1]))


def _projector_gap(a, b, k):
    """‖P_a − P_b‖ of the spans of the first k columns."""
    a = np.asarray(a, np.float64)[..., :k]
    b = np.asarray(b, np.float64)[..., :k]
    return _norm2(a @ np.swapaxes(a, -1, -2) - b @ np.swapaxes(b, -1, -2))


def _bilayer(seed, n_per_leaflet=128, box=(13.0, 13.0, 11.0), offset=2.0):
    """(n, 3) f32 heads of a flat bilayer: two jittered grids ±offset nm
    about the box's midplane, as tools/bench_modes.py synth_aa_bilayer
    places its P heads."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_per_leaflet)))
    g = (np.arange(side) + 0.5) * box[0] / side
    xy = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)[:n_per_leaflet]
    layers = []
    for z in (box[2] / 2 + offset, box[2] / 2 - offset):
        p = np.column_stack([xy, np.full(len(xy), z)])
        layers.append(p + rng.normal(0, 0.15, p.shape))
    return (np.concatenate(layers) % np.asarray(box)).astype(np.float32)


def _filtered_basis(heads, box):
    """The filter's QR input `gp @ q` of `_top3_subspace` (after its 12
    squarings), computed with JAX in f32 from the heads' similarity."""
    w = jnp.exp(-jc.PRECISE_SIGMA * jc._pairwise_sq_distances(
        jnp.asarray(heads), jnp.asarray(box), True))
    degree = jnp.sum(w, axis=1)
    dis = 1.0 / jnp.sqrt(degree)
    s = w * dis[:, None] * dis[None, :]
    v0 = jnp.sqrt(degree)
    v0 = v0 / jnp.linalg.norm(v0)
    i = jnp.arange(s.shape[0], dtype=s.dtype)
    q, _ = jnp.linalg.qr(jnp.stack([v0, jnp.sin(0.7 * i + 0.3),
                                    jnp.cos(1.3 * i + 0.1)], axis=1))
    gp = s / jnp.max(jnp.abs(s))
    for _ in range(12):
        gp = gp @ gp
        gp = gp / jnp.max(jnp.abs(gp))
    return np.asarray(gp @ q)


def _jax_qr(a):
    return np.stack([np.asarray(jnp.linalg.qr(jnp.asarray(m))[0])
                     for m in a])


def test_thin_qr3_plain_well_conditioned():
    rng = np.random.default_rng(11)
    a = rng.normal(size=(4, 40, 3)).astype(np.float32)
    got = spectral.thin_qr3_plain(_t(a)).numpy()
    want = _jax_qr(a)
    assert got.shape == a.shape and got.dtype == np.float32
    assert _orthonormality(got) <= 1e-5 and _orthonormality(want) <= 1e-5
    for k in (1, 2, 3):
        assert _projector_gap(got, want, k) <= 1e-5


def test_thin_qr3_plain_ill_conditioned():
    box = np.array([13.0, 13.0, 11.0], np.float32)
    a = np.stack([_filtered_basis(_bilayer(seed), box) for seed in (1, 2)])
    sv = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    assert (sv[:, 0] / sv[:, 2] > 1e6).all(), sv
    got = spectral.thin_qr3_plain(_t(a)).numpy()
    want = _jax_qr(a)
    assert _orthonormality(got) <= 1e-5 and _orthonormality(want) <= 1e-5
    assert _projector_gap(got, want, 2) <= 1e-5


def test_thin_qr3_plain_zero_column():
    """A zero column takes no reflection (LAPACK's τ = 0): Q stays
    orthonormal and spans the other columns."""
    rng = np.random.default_rng(12)
    a = rng.normal(size=(2, 10, 3)).astype(np.float32)
    a[:, :, 1] = 0.0
    got = spectral.thin_qr3_plain(_t(a)).numpy()
    assert np.isfinite(got).all() and _orthonormality(got) <= 1e-6
    assert _projector_gap(got, _jax_qr(a), 1) <= 1e-6


def _jax_similarity(heads, box):
    """JAX's S and v0 of one frame's heads, as `_spectral_labels` forms
    them."""
    w = jnp.exp(-jc.PRECISE_SIGMA * jc._pairwise_sq_distances(
        jnp.asarray(heads), jnp.asarray(box), True))
    degree = jnp.sum(w, axis=1)
    dis = jnp.where(degree > 1e-10, 1.0 / jnp.sqrt(degree), 0.0)
    v0 = jnp.sqrt(degree)
    return w * dis[:, None] * dis[None, :], v0 / jnp.linalg.norm(v0)


@pytest.mark.parametrize("seed", [1, 2])
def test_top3_subspace_plain_against_jax(seed):
    box = np.array([13.0, 13.0, 11.0], np.float32)
    s, v0 = _jax_similarity(_bilayer(seed), box)
    want = np.asarray(jc._top3_subspace(s, v0))
    got = tc._top3_subspace(_t(np.array(s))[None], _t(np.array(v0))[None],
                            spectral.top3_subspace_plain)[0].numpy()
    assert got.dtype == np.float32 and _orthonormality(got) <= 1e-5
    assert _projector_gap(got, want, 2) <= 1e-4


def _jax_top2(span, degree):
    out = []
    for s, d in zip(span, degree):
        v0 = jnp.sqrt(jnp.maximum(jnp.asarray(d), 0.0))
        v0 = v0 / jnp.maximum(jnp.linalg.norm(v0), 1e-30)
        s = jnp.asarray(s)
        u, _, _ = jnp.linalg.svd(s - v0[:, None] * (v0 @ s)[None, :],
                                 full_matrices=False)
        out.append(np.asarray(u[:, :2]))
    return np.stack(out)


def _eigh_span(coords, boxes, heads):
    """The CPU branch's span (LAPACK eigh of I − S) and the degrees."""
    s, degree = spectral.spectral_affinity_plain(
        _t(coords[:, heads]), _t(boxes), True, tc.PRECISE_SIGMA)
    eye = torch.eye(len(heads))
    span = torch.linalg.eigh(eye - s).eigenvectors[..., :3].contiguous()
    return s, span, degree


@pytest.mark.parametrize("name", ["flat", "scrambling"])
def test_top2_span_plain_against_jax(systems, name):  # noqa: F811
    coords, boxes, heads = systems[name]
    _, span, degree = _eigh_span(coords, boxes, heads)
    got = spectral.top2_span_plain(span, degree).numpy()
    want = _jax_top2(span.numpy(), degree.numpy())
    assert got.shape == (len(coords), len(heads), 2)
    assert _orthonormality(got) <= 1e-5
    assert _projector_gap(got, want, 2) <= 1e-5


def test_top2_span_plain_non_orthonormal_span():
    """A span that is not orthonormal (the Nyström path's): the left
    singular vectors still agree."""
    rng = np.random.default_rng(13)
    span = (rng.normal(size=(3, 50, 3)) * [3.0, 1.0, 0.2]).astype(np.float32)
    degree = rng.uniform(0.5, 4.0, (3, 50)).astype(np.float32)
    got = spectral.top2_span_plain(_t(span), _t(degree)).numpy()
    assert _projector_gap(got, _jax_top2(span, degree), 2) <= 1e-5


@pytest.mark.parametrize("name", ["flat", "scrambling"])
def test_top2_span_plain_with_laplacian(systems, name):  # noqa: F811
    """With S the plain span gives the same u2 and its products u2 − Sᵀu2
    (in f64, rounded once) within 1e-6 of JAX's `v − s_mat @ v` in f32."""
    coords, boxes, heads = systems[name]
    s, span, degree = _eigh_span(coords, boxes, heads)
    u2, lu2 = spectral.top2_span_plain(span, degree, s)
    assert torch.equal(u2, spectral.top2_span_plain(span, degree))
    assert lu2.dtype == torch.float32 and lu2.shape == u2.shape
    want = np.stack([np.asarray(jnp.asarray(u) - jnp.asarray(m) @ u)
                     for u, m in zip(u2.numpy(), s.numpy())])
    np.testing.assert_allclose(lu2.numpy(), want, rtol=0, atol=1e-6)


def _jax_labels(u2, lu2):
    """gorder_tpu's `_kmeans2(_rayleigh_weighted(u2, lap))`, with lap
    giving the products `lu2` of each of u2's two columns."""
    out = []
    for u, lu in zip(u2, lu2):
        u, lu = jnp.asarray(u), jnp.asarray(lu)

        def lap(v, u=u, lu=lu):
            return jnp.where(jnp.all(v == u[:, 0]), lu[:, 0], lu[:, 1])

        out.append(np.asarray(jc._kmeans2(jc._rayleigh_weighted(u, lap))))
    return np.stack(out)


@pytest.mark.parametrize("name", ["flat", "vesicle", "scrambling"])
def test_rayleigh_kmeans_plain_against_jax(systems, name):  # noqa: F811
    coords, boxes, heads = systems[name]
    s, span, degree = _eigh_span(coords, boxes, heads)
    u2 = spectral.top2_span_plain(span, degree)
    lu2 = u2 - s @ u2
    got = spectral.rayleigh_kmeans_plain(u2, lu2, tc.KMEANS_ITERS)
    assert got.dtype == torch.int32
    want = _jax_labels(u2.numpy(), lu2.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((want == 0).any(1) & (want == 1).any(1)).all()


def test_rayleigh_kmeans_plain_tie_and_empty_cluster():
    """Frame 0: the second column's Laplacian products are 0, so the
    Rayleigh matrix is diagonal and the embedding is the rows of (b, w·a)
    normalized, exactly; rows 3 and 7 mirror each other, the farthest
    from row 0 at exactly equal distance (the lowest row wins, as
    torch.argmax and jnp.argmax take it). Frame 1: every row the same, so
    cluster 1 stays empty and falls back to row 0 (all labels 0)."""
    rng = np.random.default_rng(14)
    n = 24
    u2 = np.column_stack([rng.normal(size=n), rng.uniform(0.1, 1.0, n)])
    u2 = np.stack([u2, np.tile([0.3, -0.2], (n, 1))]).astype(np.float32)
    u2[0, 0] = (0.0, 0.5)
    u2[0, 3] = (0.1, -0.4)
    u2[0, 7] = (-0.1, -0.4)
    lu2 = (u2 * np.array([0.05, 0.0], np.float32)).astype(np.float32)
    lu2[1] = u2[1] * np.array([0.05, 0.8], np.float32)
    got = spectral.rayleigh_kmeans_plain(_t(u2), _t(lu2), tc.KMEANS_ITERS)
    want = _jax_labels(u2, lu2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[1].any() and want[0].any()
    emb = spectral.rayleigh_embedding(_t(u2), _t(lu2))[0]
    d = ((emb - emb[0]) ** 2).sum(-1)
    assert d[3] == d[7] == d.max() and int(torch.argmax(d)) == 3


@pytest.mark.parametrize("handle_pbc", [True, False])
@pytest.mark.parametrize("name", ["flat", "vesicle"])
def test_spectral_affinity_plain_against_jax(systems, name,  # noqa: F811
                                             handle_pbc):
    coords, boxes, heads = systems[name]
    pts = coords[:, heads]
    got_s, got_d = spectral.spectral_affinity_plain(
        _t(pts), _t(boxes), handle_pbc, tc.PRECISE_SIGMA)
    for f, (p, b) in enumerate(zip(pts, boxes)):
        w = jnp.exp(-jc.PRECISE_SIGMA * jc._pairwise_sq_distances(
            jnp.asarray(p), jnp.asarray(b), handle_pbc))
        degree = jnp.sum(w, axis=1)
        dis = jnp.where(degree > 1e-10, 1.0 / jnp.sqrt(degree), 0.0)
        s = w * dis[:, None] * dis[None, :]
        np.testing.assert_allclose(got_d[f].numpy(), np.asarray(degree),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(got_s[f].numpy(), np.asarray(s),
                                   rtol=1e-6, atol=TINY)


@pytest.mark.parametrize("handle_pbc", [True, False])
@pytest.mark.parametrize("name", ["flat", "vesicle", "scrambling"])
def test_plain_weights_are_symmetric(systems, name,  # noqa: F811
                                     handle_pbc):
    coords, boxes, heads = systems[name]
    w = spectral.affinity_weights_plain(_t(coords[:, heads]), _t(boxes),
                                        handle_pbc, tc.PRECISE_SIGMA)
    assert torch.equal(w, w.transpose(1, 2))


def _tie_heads(seed, n_frames=3, n=96):
    """(F, n, 3) f32 heads on the quarter points of a box whose sides are
    exact in f32, so that many differences are exactly ±L/2 or ±L; a third
    of the coordinates moved one ulp either way, and some shifted by ±L or
    −L/2 out of the box."""
    rng = np.random.default_rng(seed)
    box = np.array([[4.0, 6.0, 5.0], [3.2, 3.2, 11.0],
                    [7.3, 7.3, 7.3]][:n_frames], np.float32)
    q = rng.integers(0, 4, (n_frames, n, 3)).astype(np.float32)
    p = (q * box[:, None, :] / np.float32(4.0)).astype(np.float32)
    step = rng.integers(-1, 2, p.shape)
    p = np.where(step > 0, np.nextafter(p, np.float32(np.inf)),
                 np.where(step < 0, np.nextafter(p, np.float32(-np.inf)), p))
    shift = rng.choice([0.0, 1.0, -1.0, -0.5], p.shape, p=[.7, .1, .1, .1])
    p = (p + shift.astype(np.float32) * box[:, None, :]).astype(np.float32)
    return p, box


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_plain_weights_are_symmetric_at_ties(handle_pbc):
    heads, box = _tie_heads(16)
    d = heads[:, :, None, :] - heads[:, None, :, :]
    t = d / box[:, None, None, :]
    assert (np.abs(np.abs(t) - 0.5) == 0).sum() > 1000   # exact ties
    w = spectral.affinity_weights_plain(_t(heads), _t(box), handle_pbc,
                                        tc.PRECISE_SIGMA)
    assert torch.equal(w, w.transpose(1, 2))


@pytest.mark.parametrize("name", ["flat", "vesicle", "scrambling"])
def test_kmeans_fixed_point_gives_the_100_step_labels(systems,  # noqa: F811
                                                      name):
    coords, boxes, heads = systems[name]
    s, span, degree = _eigh_span(coords, boxes, heads)
    u2 = spectral.top2_span_plain(span, degree)
    lu2 = u2 - s @ u2
    emb = spectral.rayleigh_embedding(u2, lu2)
    labels, steps = spectral.kmeans2_fixed_point(emb, tc.KMEANS_ITERS)
    assert labels.dtype == torch.int32 and steps.dtype == torch.int32
    assert torch.equal(labels, spectral.kmeans2(emb, tc.KMEANS_ITERS))
    np.testing.assert_array_equal(labels.numpy(),
                                  _jax_labels(u2.numpy(), lu2.numpy()))
    assert bool((steps >= 1).all()) and int(steps.max()) < tc.KMEANS_ITERS
    # a cap below the fixed point: the labels of that many steps
    for cap in range(int(steps.max()) + 1):
        got, ran = spectral.kmeans2_fixed_point(emb, cap)
        assert torch.equal(got, spectral.kmeans2(emb, cap))
        assert torch.equal(ran, torch.clamp(steps, max=cap))


def test_kmeans_fixed_point_random_embeddings():
    """Many small random frames, some of which move for several steps;
    every cap from 0 to past the slowest frame."""
    rng = np.random.default_rng(17)
    emb = torch.as_tensor(rng.normal(size=(200, 40, 2)).astype(np.float32))
    emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    _, steps = spectral.kmeans2_fixed_point(emb, tc.KMEANS_ITERS)
    assert int(steps.max()) >= 4
    for cap in list(range(int(steps.max()) + 2)) + [tc.KMEANS_ITERS]:
        got, ran = spectral.kmeans2_fixed_point(emb, cap)
        assert torch.equal(got, spectral.kmeans2(emb, cap))
        assert torch.equal(ran, torch.clamp(steps, max=cap))


@pytest.mark.parametrize("n, path", [
    (1, "triangle"), (31, "triangle"), (32, "triangle"), (33, "triangle"),
    (256, "triangle"), (287, "triangle"), (288, "triangle"),
    (289, "two-pass"), (20_000, "two-pass")])
def test_affinity_plan_at_its_limit(n, path):
    plan = spectral.affinity_plan(n)
    assert plan.path == path
    if path == "triangle":
        t = -(-n // 32)
        assert plan.shared_bytes == (t * (t + 1) // 2 * 4096
                                     + (8 * t + 28) * n + 256)
        assert plan.shared_bytes <= 227 * 1024 and plan.tile == 0
    else:
        assert plan.tile == min(n, spectral.AFFINITY_TILE)
        assert plan.shared_bytes == 16 * plan.tile <= 40 * 1024


def test_affinity_plan_follows_its_limit(monkeypatch):
    """The limit in bytes decides, as the card tests force the two passes
    with it."""
    n = 256
    monkeypatch.setattr(spectral, "AFFINITY_TRIANGLE_BYTES",
                        spectral.triangle_bytes(n))
    assert spectral.affinity_plan(n).path == "triangle"
    assert spectral.affinity_plan(n + 1).path == "two-pass"
    monkeypatch.setattr(spectral, "AFFINITY_TRIANGLE_BYTES", 0)
    assert spectral.affinity_plan(1).path == "two-pass"


@pytest.mark.parametrize("n, path", [
    (3, "ring"), (256, "ring"), (1024, "ring"), (1025, "shared"),
    (3657, "shared"), (3658, "device"), (20_000, "device")])
def test_subspace_plan_at_its_limit(n, path):
    plan = spectral.subspace_plan(n)
    assert plan.path == path
    ring = 128 * 1024 if path == "ring" else 0
    assert plan.shared_bytes == (ring + 56 * n if path != "device" else 0)
    assert plan.shared_bytes <= 200 * 1024


def test_subspace_plan_follows_its_limits(monkeypatch):
    """The limits decide, as the card tests force the paths with them:
    the rows the ring takes, and the bytes of the ring and the working
    columns."""
    monkeypatch.setattr(spectral, "SUBSPACE_SHARED_BYTES", 56 * 300)
    assert spectral.subspace_plan(300).path == "shared"
    assert spectral.subspace_plan(301).path == "device"
    monkeypatch.setattr(spectral, "SUBSPACE_SHARED_BYTES", 0)
    assert spectral.subspace_plan(3).path == "device"
    monkeypatch.undo()
    monkeypatch.setattr(spectral, "SUBSPACE_RING_ROWS", 0)
    assert spectral.subspace_plan(3).path == "shared"


@pytest.mark.parametrize("n, path", [
    (1, "warp"), (255, "warp"), (256, "warp"), (257, "shared"),
    (spectral.KMEANS_SHARED_ROWS, "shared"),
    (spectral.KMEANS_SHARED_ROWS + 1, "device"), (20_000, "device")])
def test_kmeans_plan_at_its_limits(n, path):
    plan = spectral.kmeans_plan(n)
    assert plan.path == path
    assert plan.shared_bytes == (8 * n if path == "shared" else 0)
    assert plan.shared_bytes <= 40 * 1024


def test_rayleigh_kmeans_reports_steps_on_cpu(systems):  # noqa: F811
    coords, boxes, heads = systems["scrambling"]
    s, span, degree = _eigh_span(coords, boxes, heads)
    u2 = spectral.top2_span_plain(span, degree)
    lu2 = u2 - s @ u2
    steps = torch.full((len(coords),), -1, dtype=torch.int32)
    before = spectral.kmeans_launches
    labels = spectral.rayleigh_kmeans(u2, lu2, tc.KMEANS_ITERS, steps=steps)
    assert spectral.kmeans_launches == before
    assert torch.equal(labels, spectral.rayleigh_kmeans_plain(
        u2, lu2, tc.KMEANS_ITERS))
    want = spectral.kmeans2_fixed_point(spectral.rayleigh_embedding(u2, lu2),
                                        tc.KMEANS_ITERS)[1]
    assert torch.equal(steps, want)
    with pytest.raises(TypeError):
        spectral.rayleigh_kmeans(u2, lu2, 5, steps=steps.long())
    with pytest.raises(ValueError):
        spectral.rayleigh_kmeans(u2, lu2, 5, steps=steps[:1].contiguous())


def _inputs(seed=15, B=3, n=40):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(B, n, n)).astype(np.float32)
    return dict(
        heads=_t(rng.uniform(0, 5, (B, n, 3)).astype(np.float32)),
        box=_t(np.full((B, 3), 5.0, np.float32)),
        a=_t(rng.normal(size=(B, n, 3)).astype(np.float32)),
        gp=_t(m @ np.swapaxes(m, 1, 2) / n),
        s=_t(np.abs(m) / n),
        degree=_t(rng.uniform(1, 3, (B, n)).astype(np.float32)),
        u2=_t(rng.normal(size=(B, n, 2)).astype(np.float32)),
        lu2=_t(rng.normal(size=(B, n, 2)).astype(np.float32)))


def test_wrappers_on_cpu_run_the_plain_versions():
    x = _inputs()
    counts = ("affinity_launches", "subspace_launches", "span_launches",
              "kmeans_launches")
    before = [getattr(spectral, c) for c in counts]
    pairs = [
        (spectral.spectral_affinity(x["heads"], x["box"], True, 1.0),
         spectral.spectral_affinity_plain(x["heads"], x["box"], True, 1.0)),
        (spectral.top3_subspace(x["gp"], x["s"], x["a"]),
         spectral.top3_subspace_plain(x["gp"], x["s"], x["a"])),
        (spectral.top2_span(x["a"], x["degree"]),
         spectral.top2_span_plain(x["a"], x["degree"])),
        (spectral.top2_span(x["a"], x["degree"], x["s"]),
         spectral.top2_span_plain(x["a"], x["degree"], x["s"])),
        (spectral.rayleigh_kmeans(x["u2"], x["lu2"], 7),
         spectral.rayleigh_kmeans_plain(x["u2"], x["lu2"], 7)),
    ]
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [getattr(spectral, c) for c in counts] == before


def test_wrappers_reject_wrong_arguments():
    x = _inputs()
    with pytest.raises(TypeError):
        spectral.spectral_affinity(x["heads"].double(), x["box"], True, 1.0)
    with pytest.raises(ValueError):
        spectral.spectral_affinity(x["heads"], x["box"][:, :2].contiguous(),
                                   True, 1.0)
    with pytest.raises(ValueError):                         # n < 3
        spectral.top3_subspace(x["gp"][:, :2, :2].contiguous(),
                               x["s"][:, :2, :2].contiguous(),
                               x["a"][:, :2].contiguous())
    with pytest.raises(ValueError):                         # not contiguous
        spectral.top3_subspace(x["gp"], x["s"].transpose(1, 2), x["a"])
    with pytest.raises(ValueError):                         # 2 columns
        spectral.top3_subspace(x["gp"], x["s"],
                               x["a"][..., :2].contiguous())
    with pytest.raises(TypeError):
        spectral.top3_subspace(x["gp"].double(), x["s"], x["a"])
    with pytest.raises(ValueError):                         # frames differ
        spectral.top3_subspace(x["gp"][:2].contiguous(), x["s"], x["a"])
    with pytest.raises(ValueError):
        spectral.top2_span(x["a"], x["degree"][:, :5].contiguous())
    with pytest.raises(ValueError):
        spectral.top2_span(x["a"], x["degree"], x["s"][:, :5].contiguous())
    with pytest.raises(TypeError):
        spectral.rayleigh_kmeans(x["u2"], x["lu2"].double(), 7)
    with pytest.raises(ValueError):
        spectral.rayleigh_kmeans(x["u2"], x["lu2"], -1)
    with pytest.raises(ValueError):
        spectral.top2_span(x["a"].to("meta"), x["degree"])
    with pytest.raises(ValueError):
        spectral.top3_subspace(x["gp"], x["s"].to("meta"), x["a"])


@pytest.mark.parametrize("algebra", ["eigh", "matmul"])
def test_plain_chain_equals_wrappers_on_cpu(systems, algebra):  # noqa: F811
    coords, boxes, heads = systems["scrambling"]
    classify = tc.make_spectral_labels(heads, algebra=algebra)
    assert torch.equal(classify(_t(coords), _t(boxes)),
                       classify.plain(_t(coords), _t(boxes)))


def test_the_clustering_diagnostic_needs_a_card(monkeypatch, capsys):
    """`diagnostics/clustering.py` runs nothing, and exits 1, without a
    card."""
    from gorder_tpu_torch.diagnostics import clustering

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert clustering.main(["--runs", "0"]) == 1
    assert "nothing was run" in capsys.readouterr().err
