"""The dense neighbour passes of the port (gorder_tpu_torch/ops/
neighbors.py: `normal_cloud` for dynamic membrane normals, `local_sums`
for the local leaflet classifier) on the CPU, where the wrappers run
their plain versions; tests/test_torch_kernels.py holds the kernels
against them on the card.

- On the CPU each wrapper gives its plain version's tensors bit for bit
  and launches nothing (the launch counts stay 0), and so do
  `core/normals.py dynamic_normals` and `LocalClassifier`.
- The plain versions against `gorder_tpu`: the cloud counts equal
  `make_dynamic_normals`'s; the covariances and the local sums differ
  from an f64 sum over the same f32 offsets and mask by at most 1e-5 of
  the sum of the terms' magnitudes (torch adds in f32); a head with an
  empty cloud has count 0 and a zero covariance.
- The wrappers refuse a wrong dtype, shape or device, on either device.
- A run hands out the consumers its step called (`DeviceBatch
  .consumers`): from the batch's wire, they give the batch's normals and
  classes again, as chip_smoke.py recomputes them on the card.
- The kernels' minimum image, modelled in numpy f32 (`_kernel_rint`:
  t = d · fl(1/L) rounded half to even as the kernels round it, the
  correctly rounded d / L where t lies within the wrapper's
  MIN_IMAGE_MARGIN · MIN_IMAGE_SPAN of a half-integer or the pair's
  coordinates leave the kernels' per-tile range [−L, 2L]), rounds every
  offset as rint(f32(d / L)) does and gives its offset d − L·k: on
  offsets within 4 ulps of (j + ½)·L, on ±0, on uniform offsets, on what
  hypothesis draws, and on coordinates just and far outside the range;
  with a margin of 0, or without the range, it does not. Coordinates in
  the range keep |t| under MIN_IMAGE_SPAN.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke
from gorder_tpu.core import normals as jn
from gorder_tpu.input import Analysis as JaxAnalysis
from gorder_tpu.input import AnalysisType as JaxAnalysisType
from gorder_tpu.input.config import LeafletClassification, MembraneNormal
from gorder_tpu_torch.core import leaflets as tl
from gorder_tpu_torch.core import normals as tn
from gorder_tpu_torch.core.normals import DynamicNormals
from gorder_tpu_torch.engine.drivers import run_analysis
from gorder_tpu_torch.ops import neighbors

from .synthetic import make_flat_bilayer
from .test_torch_leaflets import _membrane
from .test_torch_normals import _membrane_frames

#: the bound of an f32 sum against the f64 sum of the same terms, as a
#: share of the sum of their magnitudes: torch's pairwise f32 reduction
#: over up to 10^4 terms stays within log2(n) · 2^-24 ≈ 1e-6 of it
SUM_BOUND = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _idx(a):
    return torch.as_tensor(np.asarray(a, np.int64))


def _min_image(d, box):
    """f32 d − L·round(d / L), half to even, as torch and jnp take it."""
    return (d - box * np.round(d / box)).astype(np.float32)


def _cloud_reference(coords, box, heads, cloud, radius, handle_pbc):
    """The counts, and the covariances summed in f64 over the same f32
    offsets and mask, with |terms| for the bound."""
    rel = coords[:, None, cloud, :] - coords[:, heads, None, :]
    if handle_pbc:
        rel = _min_image(rel, box[:, None, None, :])
    d2 = (rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
          + rel[..., 2] * rel[..., 2])
    mask = d2 <= np.float32(radius) * np.float32(radius)
    count = mask.sum(-1)
    r64 = np.where(mask[..., None], rel, 0).astype(np.float64)
    centroid = r64.sum(-2) / np.maximum(count, 1)[..., None]
    e = np.where(mask[..., None], r64 - centroid[..., None, :], 0)
    pairs = [(a, b) for a in range(3) for b in range(a, 3)]
    cov = np.stack([(e[..., a] * e[..., b]).sum(-1) for a, b in pairs], -1)
    scale = np.stack([np.abs(e[..., a] * e[..., b]).sum(-1)
                      for a, b in pairs], -1)
    return count, cov, scale


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_normal_cloud_against_jax_and_f64(handle_pbc):
    coords, box, heads, cloud = _membrane_frames(4, B=4)
    counts, cov = neighbors.normal_cloud(_t(coords), _t(box), _idx(heads),
                                         _idx(cloud), 2.0, handle_pbc)
    _, want_counts = jn.make_dynamic_normals(heads, cloud, 2.0,
                                             handle_pbc)(coords, box)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    count, ref, scale = _cloud_reference(coords, box, heads, cloud, 2.0,
                                         handle_pbc)
    np.testing.assert_array_equal(counts.numpy(), count)
    assert cov.dtype == torch.float32 and cov.shape == (4, 80, 6)
    assert np.all(np.abs(cov.numpy() - ref) <= SUM_BOUND * scale + 1e-12)


def test_a_head_with_an_empty_cloud():
    coords, box, heads, cloud = _membrane_frames(5, B=3)
    # head 0 alone in its 0.05 nm: its cloud holds nothing but itself,
    # and the cloud leaves it out
    counts, cov = neighbors.normal_cloud(_t(coords), _t(box), _idx(heads),
                                         _idx(cloud[1:]), 0.05, True)
    assert counts[:, 0].tolist() == [0.0] * 3
    assert torch.all(cov[:, 0] == 0)


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_local_sums_against_f64(handle_pbc):
    centers = None if handle_pbc else np.full(6, 4.0)
    coords, box, membrane, heads, _, _ = _membrane(3, centers=centers)
    got = neighbors.local_sums(_t(coords), _t(box), _idx(membrane),
                               _idx(heads), 2, 2.0, handle_pbc).numpy()
    d = coords[:, None, membrane, :2] - coords[:, heads, None, :2]
    if handle_pbc:
        d = _min_image(d, box[:, None, None, :2])
    w = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
         <= np.float32(2.0) * np.float32(2.0))
    z = coords[:, membrane, 2]
    if handle_pbc:
        theta = (z / box[:, None, 2] * np.float32(2.0 * np.pi)).astype(
            np.float32)
        values = (np.cos(theta), np.sin(theta))
    else:
        values = (z, np.ones_like(z))
    for k, v in enumerate(values):
        terms = np.where(w, v[:, None, :], 0).astype(np.float64)
        assert np.all(np.abs(got[..., k] - terms.sum(-1))
                      <= SUM_BOUND * np.abs(terms).sum(-1) + 1e-12)
    assert got.shape == (6, 24, 2) and got.dtype == np.float32
    if not handle_pbc:
        np.testing.assert_array_equal(got[..., 1], w.sum(-1))


def test_the_cpu_takes_the_plain_versions(monkeypatch):
    monkeypatch.setattr(neighbors, "normals_launches", 0)
    monkeypatch.setattr(neighbors, "local_launches", 0)
    coords, box, heads, cloud = _membrane_frames(6, B=3)
    args = (_t(coords), _t(box), _idx(heads), _idx(cloud), 2.0, True)
    for got, want in zip(neighbors.normal_cloud(*args),
                         neighbors.normal_cloud_plain(*args)):
        assert torch.equal(got, want)
    for got, want in zip(tn.dynamic_normals(*args),
                         tn.dynamic_normals_plain(*args)):
        assert torch.equal(got, want)
    coords, box, membrane, heads, _, _ = _membrane(7)
    args = (_t(coords), _t(box), _idx(membrane), _idx(heads), 2, 2.0, True)
    assert torch.equal(neighbors.local_sums(*args),
                       neighbors.local_sums_plain(*args))
    local = tl.LocalClassifier(membrane, heads, 2, 2.0)
    assert torch.equal(local(_t(coords), _t(box)),
                       local.plain(_t(coords), _t(box)))
    assert neighbors.normals_launches == 0 and neighbors.local_launches == 0


def _refusals():
    coords = torch.zeros((2, 5, 3))
    box = torch.ones((2, 3))
    idx = torch.arange(3)
    meta = torch.empty(3, dtype=torch.int64, device="meta")
    return {
        "f64 coords": ((coords.double(), box, idx, idx), TypeError),
        "int32 indices": ((coords, box, idx.int(), idx), TypeError),
        "(B, A, 2) coords": ((coords[..., :2], box, idx, idx), ValueError),
        "a (B, 2) box": ((coords, box[:, :2], idx, idx), ValueError),
        "indices not 1-D": ((coords, box, idx[None], idx), ValueError),
        "indices on another device": ((coords, box, idx, meta), ValueError),
        "coords on no kernel's device": (
            (coords.to("meta"), box, idx, idx), ValueError),
        "a strided box": ((coords, torch.ones((3, 2)).t(), idx, idx),
                          ValueError),
    }


@pytest.mark.parametrize("case", list(_refusals()))
@pytest.mark.parametrize("wrapper", ["normal_cloud", "local_sums"])
def test_the_wrappers_refuse_wrong_arguments(wrapper, case):
    (coords, box, a, b), error = _refusals()[case]
    extra = (2.0, True) if wrapper == "normal_cloud" else (2, 2.0, True)
    with pytest.raises(error):
        getattr(neighbors, wrapper)(coords, box, a, b, *extra)


def test_local_sums_refuse_an_axis():
    with pytest.raises(ValueError, match="axis 3"):
        neighbors.local_sums(torch.zeros((2, 5, 3)), torch.ones((2, 3)),
                             torch.arange(3), torch.arange(3), 3, 2.0, True)


@pytest.fixture(scope="module")
def cg_files(tmp_path_factory):
    return make_flat_bilayer(tmp_path_factory.mktemp("cg"), n_frames=20)


@pytest.mark.parametrize("wire", ["b7", "d8"])
def test_a_batch_hands_out_its_consumers(cg_files, tmp_path, monkeypatch,
                                         wire):
    """The normals and classes of each batch again from the consumers it
    hands out, fed the f32 coordinates its wire gives them
    (chip_smoke.neighbor_inputs): b7 carries the normals' cloud as aux
    atoms (b7x), d8 the whole frame; local leaflets ride the latter."""
    monkeypatch.setenv("GORDER_TPU_WIRE", wire)
    gro, bnd, xtc = cg_files
    kw = dict(structure=gro, bonds=bnd, trajectory=xtc, silent=True,
              overwrite=True, output_yaml=str(tmp_path / "order.yaml"),
              analysis_type=JaxAnalysisType.cgorder("resname POPC"),
              membrane_normal=MembraneNormal.dynamic(
                  "resname POPC and name PO4", 2.0))
    if wire == "d8":
        kw["leaflets"] = LeafletClassification.local(
            "resname POPC", "name PO4", 2.5).with_membrane_normal("z")
    seen = []
    run_analysis(JaxAnalysis(**kw), "cpu", batch_size=8,
                 on_batch=seen.append)
    assert {db.kind for db in seen} == {"b7x" if wire == "b7" else "d8"}
    for db in seen:
        normals = chip_smoke.batch_normals(db)
        assert isinstance(normals, DynamicNormals)
        coords = chip_smoke.neighbor_inputs(db)
        assert torch.equal(normals(coords, db.box)[0], db.normal)
        if wire == "d8":
            assert isinstance(db.consumers.coords, tl.LocalClassifier)
            assert torch.equal(db.consumers.coords(coords, db.box),
                               db.classes)


# ------------------------------------------------- the kernels' rounding

#: 1.5 · 2^23 (csrc/neighbors.cu kRound): t + ROUND − ROUND is t rounded
#: to an integer, half to even, for |t| < 2^22
ROUND = np.float32(1.5 * 2 ** 23)


def _kernel_rint(d, L, margin=neighbors.MIN_IMAGE_MARGIN, fast=True):
    """k of the kernels' minimum image d − L·k (csrc/neighbors.cu
    `min_image_fast`) in numpy f32: where `fast`, t = d · fl(1/L), k = t
    rounded half to even on the f32 pipe, and rint(fl(d / L)) where
    |t − k| ≥ ½ − margin · span (span: MIN_IMAGE_SPAN); elsewhere
    rint(fl(d / L)). The kernels test no |t| per pair: `fast` is their
    per-tile guard (`in_range`, one `__syncthreads_and` a tile: every
    head and atom coordinate of the tile in [−L, 2L]), which bounds |t|
    by span (`test_the_tile_guard_bounds_t`); `_guarded` takes it per
    pair, as a tile of one pair, since a tile takes the fast rule only
    where each of its pairs would."""
    d, L = np.asarray(d, np.float32), np.asarray(L, np.float32)
    span = np.float32(neighbors.MIN_IMAGE_SPAN)
    t = d * (np.float32(1.0) / L)
    k = (t + ROUND) - ROUND
    edge = np.float32(0.5) - np.float32(margin) * span
    tie = ~np.asarray(fast) | (np.abs(t - k) >= edge)
    return np.where(tie, np.rint(d / L), k)


def _in_range(x, L):
    """csrc/neighbors.cu `in_range`: x in [−L, 2L]."""
    return (x >= -L) & (x <= np.float32(2.0) * L)


def _guarded(q, p, L):
    """The offsets q − p of atoms at q from heads at p, in f32, and
    whether the kernels' tile guard lets a pair take the fast rule."""
    q, p, L = np.broadcast_arrays(*(np.asarray(a, np.float32)
                                    for a in (q, p, L)))
    return q - p, _in_range(q, L) & _in_range(p, L)


def _same_offsets(d, L, margin=neighbors.MIN_IMAGE_MARGIN, fast=True):
    """Whether the kernels' k and offset d − L·k equal rint(f32(d / L))
    and the plain offset: bit for bit, but that the kernels' rounding
    gives +0 for −0 (a zero offset may so differ in sign, which no sum
    sees). With `fast` everywhere, the offsets stand for pairs in the
    tile guard's range: up to ±3L."""
    d, L = np.broadcast_arrays(np.asarray(d, np.float32),
                               np.asarray(L, np.float32))
    k = _kernel_rint(d, L, margin, fast)
    want = np.rint(d / L)
    return (k == want) & ((d - L * k) == (d - L * want))


def _near_ties(j, n=20_000, seed=0):
    """Offsets within 0–4 ulps either side of f32((j + ½)·L), L from 1
    to 100 nm: where t and fl(d / L) may round apart."""
    rng = np.random.default_rng([seed, j + 3])
    L = np.concatenate([np.linspace(1.0, 100.0, n // 2),
                        rng.uniform(1.0, 100.0, n - n // 2)]).astype(
                            np.float32)
    d = ((j + 0.5) * L).astype(np.float32)
    steps = rng.integers(-4, 5, n)
    toward = np.where(steps < 0, -np.inf, np.inf).astype(np.float32)
    for _ in range(4):
        move = np.abs(steps) > 0
        d = np.where(move, np.nextafter(d, toward), d)
        steps = steps - np.sign(steps)
    return d, L


@pytest.mark.parametrize("j", range(-3, 3))
def test_the_kernel_rounding_at_near_ties(j):
    d, L = _near_ties(j)
    assert _same_offsets(d, L).all()


def test_a_zero_margin_rounds_near_ties_apart():
    d, L = (np.concatenate(p) for p in zip(*(_near_ties(j)
                                               for j in range(-3, 3))))
    assert not _same_offsets(d, L, margin=0.0).all()
    assert _same_offsets(d, L).all()


@pytest.mark.parametrize("zero", [0.0, -0.0])
def test_the_kernel_rounding_of_a_zero(zero):
    L = np.float32([1.0, 3.7, 13.0, 36.0, 100.0])
    assert _same_offsets(np.full(5, zero, np.float32), L).all()


@pytest.mark.parametrize("seed", range(3))
def test_the_kernel_rounding_of_uniform_offsets(seed):
    rng = np.random.default_rng(seed)
    L = rng.uniform(1.0, 100.0, 200_000).astype(np.float32)
    d = (rng.uniform(-2.0, 2.0, L.shape) * L).astype(np.float32)
    assert _same_offsets(d, L).all()


@settings(max_examples=2000, deadline=None, database=None)
@given(st.floats(-3.0, 3.0), st.floats(1.0, 100.0, width=32),
       st.integers(-4, 4))
def test_the_kernel_rounding_hypothesis(ratio, L, ulps):
    """Any offset up to ±3 L, nudged by a few ulps (ties come often)."""
    L = np.float32(L)
    d = np.float32(np.float32(ratio) * L)
    for _ in range(abs(ulps)):
        d = np.nextafter(d, np.float32(np.inf if ulps > 0 else -np.inf))
    assert _same_offsets(np.float32([d]), np.float32([L])).all()


@pytest.mark.parametrize("L", [1.0, 3.7, 13.0, 36.0, 100.0])
def test_the_tile_guard_bounds_t(L):
    """Coordinates at the ends of [−L, 2L] and a few ulps inside give
    |t| ≤ 3 (1 + 2⁻²²) < MIN_IMAGE_SPAN, which the margin's proof takes;
    one ulp outside, the guard refuses them."""
    L = np.float32(L)
    lo, hi = -L, np.float32(2.0) * L
    ends, a, b = [np.float32(0.0), L], lo, hi
    for _ in range(5):
        ends += [a, b]
        a, b = np.nextafter(a, hi), np.nextafter(b, lo)
    x = np.float32(ends)
    d, fast = _guarded(x[:, None], x[None, :], L)
    assert fast.all()
    t = np.abs(d * (np.float32(1.0) / L))
    assert t.max() <= 3.0 * (1.0 + 2.0 ** -22) < neighbors.MIN_IMAGE_SPAN
    out = np.float32([np.nextafter(lo, -np.inf), np.nextafter(hi, np.inf)])
    assert not _guarded(out, L / 2, L)[1].any()


@pytest.mark.parametrize("side", ["below", "above"])
def test_the_kernel_rounding_just_outside_the_tile_range(side):
    """Heads 1–4 ulps outside [−L, 2L] and atoms at near ties from
    them: the guard sends the pairs to the division, and every offset is
    the plain one."""
    d, L = (np.concatenate(p) for p in zip(*(_near_ties(j, n=4000)
                                               for j in range(-3, 3))))
    rng = np.random.default_rng(5)
    edge = -L if side == "below" else np.float32(2.0) * L
    p = edge
    for _ in range(4):
        p = np.where(rng.random(L.shape) < 0.8, np.nextafter(
            p, np.float32(-np.inf if side == "below" else np.inf)), p)
    p = np.where(p == edge, np.nextafter(
        p, np.float32(-np.inf if side == "below" else np.inf)), p)
    d, fast = _guarded(p + d, p, L)
    assert not fast.any()
    assert _same_offsets(d, L, fast=fast).all()


@pytest.mark.parametrize("j", [10, 100, 1000])
def test_the_kernel_rounding_far_outside_the_tile_range(j):
    """Atoms j + ½ boxes from heads at 0 (coordinates far outside
    [−L, 2L], as an unwrapped trajectory gives): guarded, every offset is
    the plain one."""
    d, L = _near_ties(j)
    d, fast = _guarded(d, np.float32(0.0), L)
    assert not fast.any()
    assert _same_offsets(d, L, fast=fast).all()


def test_the_tile_guard_is_needed_far_outside():
    """The same atoms 1,000 boxes out with the fast rule let through (no
    guard): t is then too far from fl(d / L) for the margin, and some
    offsets round apart, so the guard is what keeps them exact."""
    d, L = _near_ties(1000)
    assert not _same_offsets(d, L).all()
    assert _same_offsets(d, L, fast=False).all()
