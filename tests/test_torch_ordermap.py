"""The port's ordermaps (gorder_tpu_torch/core/ordermap.py and the map
output of the plain P2 and UA steps) held against `gorder_tpu`'s on the
same inputs, on the CPU.

- The grid (`build_map_spec`, with both error texts) is equal, and so are
  the cell ids (`map_cells`) op by op. The jitted `map_cells` differs only
  on tile boundaries: XLA:CPU rewrites the division by the constant bin
  size into a product with its reciprocal.
- The P2 step with a map is equal to `gorder_tpu`'s XLA step
  (GORDER_TPU_PALLAS=0) op by op (its unjitted body), map and type sums,
  after the JAX package's 7-bit limbs are recombined into int64. Against
  the jitted program the type sums hold to a quantum a sample, the maps
  hold the same samples, and a few samples lie in another tile (at most
  P2_MOVED): besides the reciprocal, XLA:CPU contracts the pair
  difference f32(q_b)·s − p_a into an FMA, which moves a midpoint on a
  tile boundary by an ulp. The pair_quantized type sums equal the JAX
  package's Pallas kernel in interpret mode (GORDER_TPU_PALLAS=1) within
  a quantum a sample, as the existing P2 tests hold it.
- The UA step with a map is equal to `_ua_step_impl` op by op without
  CH1u; with CH1u, whose hydrogens differ from XLA:CPU's in the last bits
  of atan2, cos and sin, the maps hold the same samples and at most 0.1 %
  of them lie in another tile; against the jitted step likewise.
"""

import jax
import numpy as np
import pytest
import torch

from gorder_tpu.core import ordermap as jom
from gorder_tpu.core import ua as jua
from gorder_tpu.core.order import make_order_step as jax_make_order_step
from gorder_tpu.input.config import GridSpan, OrderMapParams
from gorder_tpu_torch.core import ordermap as om
from gorder_tpu_torch.core import ua
from gorder_tpu_torch.core.order import (from_reference_rows, make_order_step,
                                         order_step)
from gorder_tpu_torch.errors import OrderMapError
from gorder_tpu_torch.ops import p2

from .test_pallas_ua import _ua_problem
from .test_torch_b7 import encode_b7
from .test_torch_order import _problem
from .test_torch_ua import _inputs, _no_ch1u

CLASSES = ("total", "upper", "lower")
#: the share of P2 samples that jitted XLA:CPU may put in another tile
#: here: these positions lie on a 0.01 nm grid, so one bond midpoint in ten
#: lies on a 0.1 nm tile boundary of one axis or the other (0.89 % moved,
#: measured); on the 0.0005 nm midpoint grid of XTC at precision 1000 the
#: share is smaller (tests/test_torch_ordermap_pipeline.py)
P2_MOVED = 0.02
BOX = np.diag([10.0, 7.5, 9.0]).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _params(plane="xy", manual=False, bin_size=(0.1, 0.1), **kw):
    dim = ((GridSpan.manual(1.0, 9.0), GridSpan.manual(-0.5, 6.0))
           if manual else (GridSpan(), GridSpan()))
    return OrderMapParams(bin_size=bin_size, dim=dim, plane=plane, **kw)


@pytest.mark.parametrize("pbc", [True, False])
@pytest.mark.parametrize("manual", [False, True])
@pytest.mark.parametrize("plane", ["xy", "xz", "yz"])
def test_build_map_spec_matches_jax(plane, manual, pbc):
    params = _params(plane, manual, bin_size=(0.1, 0.3))
    box = BOX if pbc else None
    if not manual and not pbc:
        errors = []
        for build in (om.build_map_spec, jom.build_map_spec):
            with pytest.raises(Exception) as err:
                build(params, box)
            errors.append((type(err.value).__name__, str(err.value)))
        assert errors[0] == errors[1]
        assert errors[0][0] == "OrderMapError"
        return
    got = om.build_map_spec(params, box)
    want = jom.build_map_spec(params, box)
    for field in ("ax0", "ax1", "start0", "start1", "bin0", "bin1", "n0",
                  "n1", "end0", "end1", "ncells"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.tick0(), want.tick0())
    np.testing.assert_array_equal(got.tick1(), want.tick1())


def test_bin_too_large_matches_jax():
    params = _params(manual=True, bin_size=(0.5, 8.0))
    with pytest.raises(OrderMapError) as err:
        om.build_map_spec(params, BOX)
    with pytest.raises(Exception) as want:
        jom.build_map_spec(params, BOX)
    assert str(err.value) == str(want.value)
    assert "larger than grid span" in str(err.value)


def _midpoints(seed, spec, B=6, N=3000):
    """Midpoints on the 0.0005 nm grid of XTC bond midpoints, some planted
    exactly on tile boundaries of both axes, some outside the grid."""
    rng = np.random.default_rng(seed)
    mid = (rng.integers(-2000, 22000, (B, N, 3)) * 0.0005).astype(np.float32)
    for ax, start, size, n in ((spec.ax0, spec.start0, spec.bin0, spec.n0),
                               (spec.ax1, spec.start1, spec.bin1, spec.n1)):
        k = rng.integers(-1, n + 1, (B, N // 3))
        mid[:, :N // 3, ax] = np.float32(start) + (k + 0.5) * np.float32(size)
    return mid


@pytest.mark.parametrize("manual", [False, True])
def test_map_cells_match_jax(manual):
    """Op by op: equal. Jitted: XLA:CPU rewrites the division by the
    constant bin size into a product with its reciprocal, so it differs,
    and only where a midpoint lies on a tile boundary."""
    spec = om.build_map_spec(_params(manual=manual), BOX)
    jspec = jom.build_map_spec(_params(manual=manual), BOX)
    mid = _midpoints(3, spec)
    T = 4
    btype = (np.arange(mid.shape[1]) % T).astype(np.int32)
    got, inside = om.map_cells(_t(mid), spec, _t(btype), T)
    want, want_inside = jom.map_cells(mid, jspec, btype, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(want_inside))
    dump = T * spec.ncells
    assert (got == dump).any() and (got < dump).any()
    jitted, _ = jax.jit(jom.map_cells, static_argnums=(1, 3))(mid, jspec,
                                                             btype, T)
    off = got.numpy() != np.asarray(jitted)
    x = np.stack([(mid[..., ax].astype(np.float64) - start) / size + 0.5
                  for ax, start, size in ((spec.ax0, spec.start0, spec.bin0),
                                          (spec.ax1, spec.start1,
                                           spec.bin1))])
    on_boundary = (np.abs(x - np.round(x)) < 1e-5).any(axis=0)
    assert on_boundary[off].all()


def _p2_map_case(seed, M=9):
    pb = _problem(seed=seed)
    rng = np.random.default_rng(seed + 50)
    bond_mol = rng.integers(0, M, len(pb["atom_a"])).astype(np.int32)
    classes = rng.integers(0, 3, (len(pb["box"]), M)).astype(np.int32)
    normals = rng.normal(0, 1, (len(pb["box"]), M, 3)).astype(np.float32)
    return pb, bond_mol, classes, normals


def _port_p2_map(pb, kind, spec, normal, bond_mol, classes):
    C = 3 if classes is not None else 1
    state = om.init_map_state(C, pb["T"], spec, "cpu")
    coords, inv = ((pb["q"], pb["inv"]) if kind == "i16"
                   else (pb["coords"], None))
    out = order_step(_t(coords), _t(pb["box"]), _t(normal), _t(pb["mask"]),
                     _t(pb["atom_a"]), _t(pb["atom_b"]), _t(pb["btype"]),
                     pb["T"], None if inv is None else _t(inv),
                     handle_pbc=True, bond_mol=_t(bond_mol),
                     classes=None if classes is None else _t(classes),
                     pair=True, map_spec=spec, map_state=state)
    return out.numpy(), state.numpy()


def _jax_p2_map(pb, kind, jspec, normal, bond_mol, classes, monkeypatch, *,
                jit=False, pallas=False):
    """`gorder_tpu`'s step with a map → ((B, [C,] 2, T) int64 type sums,
    (C, 2, S) int64 map)."""
    monkeypatch.setenv("GORDER_TPU_PALLAS", "1" if pallas else "0")
    names = CLASSES if classes is not None else CLASSES[:1]
    step = jax_make_order_step(
        pb["atom_a"], pb["atom_b"], pb["btype"], bond_mol, pb["T"],
        normal.shape[1] if normal.ndim == 3 else 1,
        with_leaflets=classes is not None,
        normal_mode="per_molecule" if normal.ndim == 3 else "static",
        map_spec=jspec)
    coords, inv = ((pb["q"], pb["inv"]) if kind == "i16"
                   else (pb["coords"], None))
    fn = step if jit or pallas else step.impl
    out, state = fn(coords, pb["box"], normal, pb["mask"],
                    leaflet_classes=classes, inv_scale=inv,
                    map_state=jom.init_map_state(names, pb["T"], jspec))
    sums = np.stack([from_reference_rows(np.asarray(out[c])) for c in names],
                    axis=1)
    maps = np.stack([from_reference_rows(np.asarray(state[c]))
                     for c in names])
    return (sums if classes is not None else sums[:, 0]), maps


def _moved_share(got, want):
    """Both (C, 2, S) maps hold the same samples per class, the dump
    included; → the share of the samples that lie in another cell."""
    np.testing.assert_array_equal(got[:, 1].sum(-1), want[:, 1].sum(-1))
    moved = np.abs(got[:, 1] - want[:, 1]).sum() // 2
    return moved / got[:, 1].sum()


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("leaflets", [False, True])
@pytest.mark.parametrize("kind", ["i16", "f32"])
def test_p2_step_map_matches_xla(monkeypatch, kind, leaflets, normals):
    """Op by op: equal. Jitted: counts per type equal, ≤ 0.1 % moved."""
    pb, bond_mol, classes, mol_normals = _p2_map_case(31)
    classes = classes if leaflets else None
    normal = mol_normals if normals else np.array([0, 0, 1], np.float32)
    params = _params(manual=True)
    spec, jspec = om.build_map_spec(params, BOX), jom.build_map_spec(params,
                                                                      BOX)
    got, got_map = _port_p2_map(pb, kind, spec, normal, bond_mol, classes)
    want, want_map = _jax_p2_map(pb, kind, jspec, normal, bond_mol, classes,
                                 monkeypatch)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_map, want_map)
    # the map holds every counted sample: per class, Σ map == Σ type sums
    sums = got if classes is not None else got[:, None]
    np.testing.assert_array_equal(got_map.sum(-1), sums.sum((0, 3)))
    assert got_map[:, 1, -1].sum() > 0          # some samples in the dump
    jitted, jitted_map = _jax_p2_map(pb, kind, jspec, normal, bond_mol,
                                     classes, monkeypatch, jit=True)
    assert (np.abs(got - jitted)[..., 0, :] <= got[..., 1, :]).all()
    assert _moved_share(got_map, jitted_map) <= P2_MOVED


@pytest.mark.parametrize("kind", ["i16", "f32"])
def test_pair_quantized_matches_pallas_interpret(monkeypatch, kind):
    """The pair_quantized type sums against the JAX kernel in interpret
    mode (its map comes from the jitted `_map_only_impl`)."""
    pb, bond_mol, _, _ = _p2_map_case(33)
    normal = np.array([0, 0, 1], np.float32)
    params = _params()
    spec, jspec = om.build_map_spec(params, BOX), jom.build_map_spec(params,
                                                                      BOX)
    got, got_map = _port_p2_map(pb, kind, spec, normal, bond_mol, None)
    want, want_map = _jax_p2_map(pb, kind, jspec, normal, bond_mol, None,
                                 monkeypatch, pallas=True)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    assert (np.abs(got[:, 0] - want[:, 0]) <= want[:, 1]).all()
    assert _moved_share(got_map, want_map) <= P2_MOVED
    # the pair formulation differs from the single rounding in some sample
    single = order_step(_t(pb["q"]), _t(pb["box"]), _t(normal),
                        _t(pb["mask"]), _t(pb["atom_a"]), _t(pb["atom_b"]),
                        _t(pb["btype"]), pb["T"], _t(pb["inv"]),
                        handle_pbc=True).numpy()
    if kind == "i16":
        assert not np.array_equal(got, single)


def test_map_is_batch_size_invariant():
    """Frames split over batches add up to the same map."""
    pb, bond_mol, classes, _ = _p2_map_case(35)
    pb["mask"][:] = True
    spec = om.build_map_spec(_params(), BOX)
    normal = _t(np.array([0, 0, 1], np.float32))
    state = om.init_map_state(3, pb["T"], spec, "cpu")
    step = make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                           bond_mol, pb["T"], 9, device="cpu",
                           with_leaflets=True, map_spec=spec)
    whole = om.init_map_state(3, pb["T"], spec, "cpu")
    step.positions(_t(pb["q"]), _t(pb["box"]), normal, _t(pb["mask"]),
                   inv_scale=_t(pb["inv"]), classes=_t(classes),
                   map_state=whole)
    for s in (slice(0, 5), slice(5, 11), slice(11, None)):
        step.positions(_t(pb["q"][s]), _t(pb["box"][s]), normal,
                       _t(pb["mask"][s]), inv_scale=_t(pb["inv"][s]),
                       classes=_t(classes[s]), map_state=state)
    assert torch.equal(state, whole) and whole[:, 1].sum() > 0


def test_step_routes_cpu_map_to_plain():
    """On CPU tensors the wrapper is the plain version and counts no
    launch; a map needs positions, integer ones with the pair
    difference, and a step made with a map_spec."""
    pb, bond_mol, _, _ = _p2_map_case(37)
    spec = om.build_map_spec(_params(), BOX)
    normal = _t(np.array([0, 0, 1], np.float32))
    counts = {n: getattr(p2, n) for n in dir(p2) if n.endswith("_launches")}
    state = om.init_map_state(1, pb["T"], spec, "cpu")
    step = make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                           bond_mol, pb["T"], 9, device="cpu",
                           map_spec=spec)
    got = step.positions(_t(pb["q"]), _t(pb["box"]), normal, _t(pb["mask"]),
                         inv_scale=_t(pb["inv"]), map_state=state)
    assert counts == {n: getattr(p2, n) for n in counts}
    want, want_map = _port_p2_map(pb, "i16", spec, normal.numpy(), bond_mol,
                                  None)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(state.numpy(), want_map)
    with pytest.raises(ValueError, match="b7"):
        step.b7(*map(_t, encode_b7(pb["r"])), _t(pb["base"]), _t(pb["inv"]),
                _t(pb["box"]), normal, _t(pb["mask"]))
    with pytest.raises(ValueError, match="pair"):
        order_step(_t(pb["q"]), _t(pb["box"]), normal, _t(pb["mask"]),
                   _t(pb["atom_a"]), _t(pb["atom_b"]), _t(pb["btype"]),
                   pb["T"], _t(pb["inv"]), handle_pbc=True, map_spec=spec,
                   map_state=state)
    plain = make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                            bond_mol, pb["T"], 9, device="cpu")
    with pytest.raises(ValueError, match="map_spec"):
        plain.positions(_t(pb["q"]), _t(pb["box"]), normal, _t(pb["mask"]),
                        inv_scale=_t(pb["inv"]), map_state=state)


def _ua_map(cats, btype, bmol, T, coords, inv, box, mask, spec, classes):
    step = ua.make_ua_step(cats, btype, bmol, T, device="cpu",
                           with_leaflets=classes is not None, map_spec=spec)
    state = om.init_map_state(3 if classes is not None else 1, T, spec,
                              "cpu")
    out = step.positions(_t(coords), _t(box),
                         _t(np.array([0, 0, 1], np.float32)), _t(mask),
                         inv_scale=None if inv is None else _t(inv),
                         classes=None if classes is None else _t(classes),
                         map_state=state)
    return out.numpy(), state.numpy()


def _jax_ua_map(cats, btype, bmol, T, coords, inv, box, mask, jspec,
                classes, *, jit):
    names = CLASSES if classes is not None else CLASSES[:1]
    step = jua.make_ua_step(cats, btype, bmol, T,
                            with_leaflets=classes is not None,
                            map_spec=jspec)
    fn = step if jit else step.impl
    out, state = fn(coords, box, np.array([0, 0, 1], np.float32), mask,
                    leaflet_classes=classes, inv_scale=inv,
                    map_state=jom.init_map_state(names, T, jspec))
    sums = np.stack([from_reference_rows(np.asarray(out[c])) for c in names],
                    axis=1)
    maps = np.stack([from_reference_rows(np.asarray(state[c]))
                     for c in names])
    return (sums if classes is not None else sums[:, 0]), maps


@pytest.mark.parametrize("with_ch1u", [False, True])
@pytest.mark.parametrize("leaflets", [False, True])
@pytest.mark.parametrize("kind", ["i16", "f32"])
def test_ua_step_map_matches_xla(monkeypatch, kind, leaflets, with_ch1u):
    monkeypatch.setenv("GORDER_TPU_PALLAS", "0")
    coords, box, mask, cats, btype, bmol, T, n_mols = _ua_problem(
        41, B=8, n_mols=30)
    if not with_ch1u:
        n = {c: len(cats[c]["target"]) * ua.N_HYDROGENS[c] for c in cats}
        keep = np.concatenate([np.full(n[c], c != "ch1u")
                               for c in ua.CATEGORIES if c in cats])
        cats, btype = _no_ch1u(cats, btype)
        bmol = bmol[keep]
    classes = (np.random.default_rng(42).integers(0, 2, (len(box), n_mols))
               .astype(np.int32) if leaflets else None)
    coords, inv = _inputs(kind, coords)
    params = OrderMapParams(bin_size=(0.1, 0.1), plane="xz",
                            dim=(GridSpan(), GridSpan()))
    ubox = np.diag([6.0, 6.0, 6.0]).astype(np.float32)
    spec, jspec = om.build_map_spec(params, ubox), jom.build_map_spec(params,
                                                                       ubox)
    got, got_map = _ua_map(cats, btype, bmol, T, coords, inv, box, mask,
                           spec, classes)
    want, want_map = _jax_ua_map(cats, btype, bmol, T, coords, inv, box,
                                 mask, jspec, classes, jit=False)
    sums = got if leaflets else got[:, None]
    np.testing.assert_array_equal(got_map.sum(-1), sums.sum((0, 3)))
    if with_ch1u:
        assert _moved_share(got_map, want_map) <= 1e-3
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_map, want_map)
    jitted, jitted_map = _jax_ua_map(cats, btype, bmol, T, coords, inv, box,
                                     mask, jspec, classes, jit=True)
    assert (np.abs(got - jitted)[..., 0, :] <= got[..., 1, :]).all()
    assert _moved_share(got_map, jitted_map) <= 1e-3
