"""Clustering leaflet classification in the port (gorder_tpu_torch/core/
clustering.py) held against `gorder_tpu.core.clustering` on the same
inputs, on the CPU.

- The elementwise and small algebra (`ops/spectral.py sq_distances` and
  `rayleigh_embedding`, `_inv_sqrt_spd`) to rtol 1e-5; the top-3
  subspace (its iteration by `ops/spectral.py top3_subspace`) through its
  projector (the basis may rotate), ‖P_port − P_jax‖ ≤ 1e-4, on a
  matrix with a tight top-3 spectrum, also at Nyström's 1,024 landmarks.
- Labels exactly: k-means, the spectral labels of both port branches
  (LAPACK `eigh`, which the CPU runs, and the matmul algebra the card
  runs) against JAX's CPU labels, the Nyström path, and the spherical
  classes with and without PBC. The eigenvectors differ by branch and
  backend; the labels must not.
- `SpectralOrienter` on the hand cases of tests/test_clustering.py and on
  a scrambling run, with its `ClusterError` text.

The systems are tests/synthetic.py's flat bilayer, a small vesicle and
the scrambling bilayer, read back from their XTC files.
"""

import numpy as np
import pytest
import torch

from gorder_tpu.core import clustering as jc
from gorder_tpu.errors import ClusterError as JaxClusterError
from gorder_tpu_torch.core import clustering as tc
from gorder_tpu_torch.errors import ClusterError
from gorder_tpu_torch.io.gro import read_gro
from gorder_tpu_torch.io.traj import Trajectory
from gorder_tpu_torch.ops import spectral

from . import synthetic
from .test_torch_clustering_pipeline import _one_thread  # noqa: F401

ALGEBRAS = ("eigh", "matmul")


def _frames(gro, xtc):
    """(F, A, 3) f32 coordinates, (F, 3) box lengths and the PO4 heads."""
    system = read_gro(gro)
    traj = Trajectory(xtc)
    coords, boxes, _, _ = traj.read_frames(
        traj.select_frames(None, None, 1), system.n_atoms)
    heads = np.nonzero(system.atom_names == "PO4")[0]
    return (np.ascontiguousarray(coords),
            np.ascontiguousarray(boxes[:, [0, 1, 2], [0, 1, 2]]), heads)


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """{name: (coords, boxes, heads)} of the three synthetic systems."""
    flat = synthetic.make_flat_bilayer(tmp_path_factory.mktemp("flat"),
                                       n_frames=4)
    vesicle = synthetic.make_vesicle(tmp_path_factory.mktemp("ves"),
                                     n_outer=300, n_inner=60, n_frames=3)
    scram = synthetic.make_scrambling(tmp_path_factory.mktemp("scr"),
                                      n_per_leaflet=64, n_frames=8,
                                      flip_at=4, n_flip=4)
    return {"flat": _frames(flat[0], flat[2]),
            "vesicle": _frames(vesicle[0], vesicle[2]),
            "scrambling": _frames(scram[0], scram[2])}


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_pairwise_sq_distances(systems, handle_pbc):
    coords, boxes, heads = systems["flat"]
    pts = coords[:, heads]
    want = np.stack([np.asarray(jc._pairwise_sq_distances(p, b, handle_pbc))
                     for p, b in zip(pts, boxes)])
    got = spectral.sq_distances(_t(pts), _t(pts), _t(boxes),
                                handle_pbc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_inv_sqrt_spd():
    """A landmark-similarity-like SPD matrix (Gaussian kernel of random
    points, well conditioned after the ridge)."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 4, (3, 24, 3)).astype(np.float32)
    d2 = ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)
    a = np.exp(-d2).astype(np.float32)
    want = np.stack([np.asarray(jc._inv_sqrt_spd(m)) for m in a])
    got = tc._inv_sqrt_spd(_t(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rayleigh_weighted(systems):
    """The energy-weighted embedding of a frame's deflated span, given its
    Laplacian products, up to the sign of each column (each 2×2
    eigenvector's sign is the solver's)."""
    coords, boxes, heads = systems["flat"]
    pts = coords[0, heads]
    d2 = np.asarray(jc._pairwise_sq_distances(pts, boxes[0], True))
    w = np.exp(-d2).astype(np.float32)
    dis = (1.0 / np.sqrt(w.sum(1))).astype(np.float32)
    s = (w * dis[:, None] * dis[None, :]).astype(np.float32)
    u2 = np.linalg.qr(np.random.default_rng(2).normal(
        size=(len(heads), 2)))[0].astype(np.float32)
    want = np.asarray(jc._rayleigh_weighted(u2, lambda v: v - s @ v))
    got = spectral.rayleigh_embedding(
        _t(u2)[None], _t(u2)[None] - _t(s)[None] @ _t(u2)[None])[0].numpy()
    sign = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * sign, want, rtol=1e-5, atol=1e-6)


def test_top3_subspace_projector():
    """A symmetric PSD matrix whose top three eigenvalues lie within 1e-3
    of each other (as a similarity's do) and the rest ≤ 0.99: the filtered
    subspace is well defined, and the two projectors agree."""
    rng = np.random.default_rng(3)
    n = 48
    q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    lam = np.concatenate([[1.0, 0.9996, 0.9992],
                          np.linspace(0.99, 0.05, n - 3)])
    s = ((q * lam) @ q.T).astype(np.float32)
    v0 = rng.normal(size=n).astype(np.float32)
    v0 /= np.linalg.norm(v0)
    qj = np.asarray(jc._top3_subspace(s, v0))
    qt = tc._top3_subspace(_t(s)[None], _t(v0)[None],
                           spectral.top3_subspace)[0].numpy()
    exact = q[:, :3] @ q[:, :3].T
    assert np.linalg.norm(qt @ qt.T - qj @ qj.T, 2) <= 1e-4
    assert np.linalg.norm(qt @ qt.T - exact, 2) <= 1e-3


def test_top3_subspace_projector_nystrom_sized():
    """The spectrum of `test_top3_subspace_projector` on a Nyström-sized
    landmark Gram (1,024 × 1,024), started as `_spectral_labels_nystrom`
    starts it: the two projectors agree."""
    rng = np.random.default_rng(5)
    n = tc.NYSTROM_LANDMARKS
    q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    lam = np.concatenate([[1.0, 0.9996, 0.9992],
                          np.linspace(0.99, 0.05, n - 3)])
    g = ((q * lam) @ q.T).astype(np.float32)
    gv = np.sin(0.7 * np.arange(n, dtype=np.float32) + 0.3)
    gv = (gv / np.linalg.norm(gv)).astype(np.float32)
    qj = np.asarray(jc._top3_subspace(g, gv))
    qt = tc._top3_subspace(_t(g)[None], _t(gv)[None],
                           spectral.top3_subspace)[0].numpy()
    exact = q[:, :3] @ q[:, :3].T
    assert np.linalg.norm(qt @ qt.T - qj @ qj.T, 2) <= 1e-4
    assert np.linalg.norm(qt @ qt.T - exact, 2) <= 1e-3


def test_kmeans2_labels():
    """Two blobs of different spread on the unit circle, a third batch
    frame of noise (k-means still ends somewhere, identically)."""
    rng = np.random.default_rng(4)
    ang = np.concatenate([rng.normal(0.3, 0.05, 40),
                          rng.normal(2.5, 0.6, 60)])
    blobs = np.stack([np.cos(ang), np.sin(ang)], 1)
    noise = rng.normal(size=(100, 2))
    emb = np.stack([blobs, blobs[::-1], noise]).astype(np.float32)
    want = np.stack([np.asarray(jc._kmeans2(e)) for e in emb])
    got = spectral.kmeans2(_t(emb), tc.KMEANS_ITERS).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and 0 < got[0].sum() < 100


@pytest.mark.parametrize("algebra", ALGEBRAS)
@pytest.mark.parametrize("name", ["flat", "vesicle", "scrambling"])
def test_spectral_labels_equal_jax(systems, name, algebra):
    coords, boxes, heads = systems[name]
    want = np.asarray(jc.make_spectral_labels(heads)(coords, boxes))
    got = tc.make_spectral_labels(heads, algebra=algebra)(
        _t(coords), _t(boxes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # both labels occur in every frame: a real bipartition
    assert ((want == 0).any(1) & (want == 1).any(1)).all()


def test_spectral_labels_in_chunks(systems, monkeypatch):
    """Frames split into chunks (the memory budget) give the same
    labels."""
    coords, boxes, heads = systems["scrambling"]
    whole = tc.make_spectral_labels(heads)(_t(coords), _t(boxes))
    monkeypatch.setattr(tc, "CHUNK_ELEMENTS", len(heads) ** 2 * 3)
    chunked = tc.make_spectral_labels(heads)(_t(coords), _t(boxes))
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("algebra", ALGEBRAS)
def test_nystrom_labels_equal_jax(systems, monkeypatch, algebra):
    """The landmark path, forced on both sides (DENSE_CLUSTER_HEADS below
    the head count, 120 of the vesicle's 360 heads as landmarks)."""
    coords, boxes, heads = systems["vesicle"]
    for mod in (jc, tc):
        monkeypatch.setattr(mod, "DENSE_CLUSTER_HEADS", 100)
        monkeypatch.setattr(mod, "NYSTROM_LANDMARKS", 120)
    want = np.asarray(jc.make_spectral_labels(heads)(coords, boxes))
    got = tc.make_spectral_labels(heads, algebra=algebra)(
        _t(coords), _t(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    n_outer = 300
    for frame in got:   # the two shells, one cluster each
        assert len(set(frame[:n_outer])) == len(set(frame[n_outer:])) == 1
        assert frame[0] != frame[-1]


@pytest.mark.parametrize("path", ["dense", "nystrom"])
def test_plain_matmul_chain_labels_equal_jax(systems, monkeypatch, path):
    """The matmul chain through the plain versions (`.plain`, what the
    card's kernels are held to) against `_spectral_labels` and
    `_spectral_labels_nystrom`: labels equal."""
    coords, boxes, heads = systems["vesicle" if path == "nystrom"
                                   else "scrambling"]
    if path == "nystrom":
        for mod in (jc, tc):
            monkeypatch.setattr(mod, "DENSE_CLUSTER_HEADS", 100)
            monkeypatch.setattr(mod, "NYSTROM_LANDMARKS", 120)
    want = np.asarray(jc.make_spectral_labels(heads)(coords, boxes))
    got = tc.make_spectral_labels(heads, algebra="matmul").plain(
        _t(coords), _t(boxes))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("handle_pbc", [True, False])
@pytest.mark.parametrize("name", ["vesicle", "flat"])
def test_spherical_classes_equal_jax(systems, name, handle_pbc):
    coords, boxes, heads = systems[name]
    want = np.asarray(jc.make_spherical_classifier(heads, handle_pbc)(
        coords, boxes))
    got = tc.make_spherical_classifier(heads, handle_pbc)(
        _t(coords), _t(boxes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "vesicle":
        assert (want[:, :300] == 0).all() and (want[:, 300:] == 1).all()


def _orient_sets(orienter, heads, cluster1):
    labels = np.array([0 if h in cluster1 else 1 for h in heads], np.int32)
    classes = orienter.orient(labels)
    upper = {h for h, c in zip(heads, classes) if c == 0}
    lower = {h for h, c in zip(heads, classes) if c == 1}
    return upper, lower


def test_orienter_hand_cases_equal_jax():
    """tests/test_clustering.py's hand cases (clustering.rs:819-930), each
    decision taken by both orienters, and the same error text."""
    c1 = {13, 18, 24, 27, 29, 33, 156, 17, 14}
    c2 = {1, 4, 8, 146, 158, 123, 1453, 19}
    c2_eq = c2 | {20}
    c1_new = c1 | {1}
    c2_new = c2_eq - {1}
    c1_bad = {13, 18, 24, 27, 17, 14, 1, 19}
    heads_uneq = sorted(c1 | c2)
    heads = sorted(c1 | c2_eq)
    errors = []
    for mod, error in ((tc, ClusterError), (jc, JaxClusterError)):
        orienter = mod.SpectralOrienter(heads_uneq)
        assert _orient_sets(orienter, heads_uneq, c1) == (c1, c2)
        orienter = mod.SpectralOrienter(heads)
        assert _orient_sets(orienter, heads, c1) == (c2_eq, c1)
        assert _orient_sets(orienter, heads, c1) == (c2_eq, c1)
        assert _orient_sets(orienter, heads, c1_new) == (c2_new, c1_new)
        orienter.prev_upper = np.isin(heads, sorted(c2_eq))
        assert _orient_sets(orienter, heads, c2_new) == (c2_new, c1_new)
        orienter.prev_upper = np.isin(heads, sorted(c2_eq))
        with pytest.raises(error, match="80") as err:
            _orient_sets(orienter, heads, c1_bad)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith("clustering leaflet classification failed")


def test_orienter_on_scrambling_run(systems):
    """Every frame of the scrambling bilayer through the port's labels and
    orienter gives the classes gorder_tpu's give (identities held across
    frames by the ≥ 80 % overlap), and a scrambled frame fails both."""
    coords, boxes, heads = systems["scrambling"]
    labels = tc.make_spectral_labels(heads)(_t(coords), _t(boxes)).numpy()
    port, ref = tc.SpectralOrienter(heads), jc.SpectralOrienter(heads)
    for frame in labels:
        np.testing.assert_array_equal(port.orient(frame),
                                      ref.orient(np.asarray(frame)))
    # lipid 2m sits in the upper leaflet before the flip (2m + 1 lower);
    # at frame 4 four upper lipids flip down
    first = tc.SpectralOrienter(heads)
    classes = [first.orient(f) for f in labels]
    assert (classes[0][0::2] == 0).all() and (classes[0][1::2] == 1).all()
    assert (classes[-1][:8:2] == 1).all() and (classes[-1][8::2] == 0).all()
    scramble = np.arange(len(heads)) % 2 ^ (np.arange(len(heads)) // 2 % 2)
    with pytest.raises(ClusterError) as port_err:
        port.orient(scramble)
    with pytest.raises(JaxClusterError) as jax_err:
        ref.orient(scramble)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flat", "vesicle", "scrambling"])
def test_classifiers_on_card_equal_cpu(systems, name):
    """The classifiers on the card (the matmul algebra, in full f32)
    against the CPU on the same frames: labels equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    coords, boxes, heads = systems[name]
    for make in (tc.make_spectral_labels, tc.make_spherical_classifier):
        cpu = make(heads)(_t(coords), _t(boxes))
        card = make(heads, device="cuda")(_t(coords).cuda(),
                                          _t(boxes).cuda())
        assert torch.equal(card.cpu(), cpu)
