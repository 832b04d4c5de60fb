"""Membrane normals in the port (gorder_tpu_torch/core/normals.py, the
per-molecule P2 and UA steps, engine/normals_runtime.py) held against
`gorder_tpu` on the same inputs, on the CPU.

- Normals: the eigenvector of the smallest eigenvalue, up to its sign,
  |n·n_jax| ≥ 1 − 1e-5: the f32 eigensolvers of two LAPACK builds (and
  the sums, which torch and XLA reduce in other orders) differ in the last
  bits. The cloud counts are comparisons of elementwise d² and are equal.
- Steps fed `gorder_tpu`'s own normals: equal int64 sums and counts
  against the XLA path op by op (the P2 step for every input, the UA step
  without CH1u); with CH1u, and against the jitted UA program and the
  Pallas kernels in interpret mode, |Δsum| ≤ n_samples quanta per
  (frame, type), the bound of gorder_tpu/ops/pallas_p2.py:14-24.
- The z plane: (B, M, 3) normals that are all (0, 0, 1) give the static
  step's integers bit for bit.
- Errors: the same text as `gorder_tpu` on the same input.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gorder_tpu.core import normals as jn
from gorder_tpu.core import ua as jua
from gorder_tpu.core.order import make_order_step as jax_make_order_step
from gorder_tpu.engine import normals_runtime as jnr
from gorder_tpu.engine.fused import _pop_normal_guard
from gorder_tpu_torch.core import normals as tn
from gorder_tpu_torch.core import ua
from gorder_tpu_torch.core.order import from_reference_rows, order_step
from gorder_tpu_torch.engine import normals_runtime as tnr

from .test_pallas_ua import _ua_problem
from .test_torch_order import _problem

CLASSES = ("total", "upper", "lower")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_up_to_sign(got, want, tol=1e-5):
    dots = np.abs(np.sum(np.asarray(got, np.float64)
                         * np.asarray(want, np.float64), axis=-1))
    assert dots.min() >= 1.0 - tol, dots.min()


# --------------------------------------------------------------- normals

def test_smallest_eigvec_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, (2000, 3, 3)).astype(np.float32)
    scale = rng.uniform(0.05, 3.0, (2000, 3, 1)).astype(np.float32)
    cov = np.einsum("bij,bkj->bik", a * scale, a * scale) + np.float32(
        1e-3) * np.eye(3, dtype=np.float32)
    got = tn.smallest_eigvec_3x3(_t(cov)).numpy()
    want = np.asarray(jn._smallest_eigvec_3x3(cov))
    assert got.dtype == np.float32 and got.shape == (2000, 3)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    _same_up_to_sign(got, want)
    # the solver takes the matrices in batches: the same vectors
    monkeypatch.setattr(tn, "EIGH_BATCH", 333)
    np.testing.assert_array_equal(
        tn.smallest_eigvec_3x3(_t(cov.reshape(40, 50, 3, 3))).numpy(),
        got.reshape(40, 50, 3))


def _membrane_frames(seed=0, B=12, M=40, box=(7.0, 7.5, 9.0)):
    """B frames of a flat two-leaflet membrane with some undulation: M
    heads per leaflet, 2 cloud-only atoms per molecule (as the other
    leaflet's heads are for each head), across the periodic boundary in
    z for half the frames."""
    rng = np.random.default_rng(seed)
    box = np.tile(np.asarray(box, np.float32), (B, 1))
    n = 2 * M
    coords = np.zeros((B, 3 * n, 3), np.float32)
    xy = rng.uniform(0, box[0, :2], (n, 2))
    center = np.where(np.arange(B) % 2 == 0, 0.3, 4.5)
    for f in range(B):
        wave = 0.4 * np.sin(2 * np.pi * xy[:, 0] / box[0, 0] + f / 3)
        side = np.where(np.arange(n) < M, 1.0, -1.0)
        heads = np.column_stack([
            xy + rng.normal(0, 0.05, (n, 2)),
            center[f] + side * 1.9 + wave + rng.normal(0, 0.05, n)])
        coords[f, :n] = heads
        coords[f, n:2 * n] = heads + rng.normal(0, 0.2, (n, 3))
        coords[f, 2 * n:] = heads - rng.normal(0, 0.2, (n, 3))
    coords = np.mod(coords, box[:, None, :]).astype(np.float32)
    return coords, box, np.arange(n), np.arange(3 * n)


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_dynamic_normals_match_jax(handle_pbc):
    coords, box, heads, cloud = _membrane_frames(1)
    want = jn.make_dynamic_normals(heads, cloud, 2.0, handle_pbc)
    wn, wc = (np.asarray(v) for v in want(coords, box))
    got = tn.DynamicNormals(heads, cloud, 2.0, handle_pbc)
    gn, gc = (v.numpy() for v in got(_t(coords), _t(box)))
    assert gn.shape == (12, 80, 3) and gc.shape == (12, 80)
    np.testing.assert_array_equal(gc, wc)
    assert gc.min() >= 3
    _same_up_to_sign(gn, wn)
    # frames in chunks: the same normals whatever the chunk size
    small = tn.dynamic_normals(_t(coords), _t(box), got.heads, got.cloud,
                               2.0, handle_pbc,
                               max_bytes=len(heads) * len(cloud) * 12 * 5)
    np.testing.assert_array_equal(small[0].numpy(), gn)
    np.testing.assert_array_equal(small[1].numpy(), gc)


def test_dynamic_normals_on_the_aux_atoms():
    """The b7x aux channel ships only the atoms the normals read: the
    same atom set as `gorder_tpu`'s, and the computation rebuilt over it
    gives the same normals."""
    coords, box, heads, cloud = _membrane_frames(2)
    cloud = cloud[::2]                  # heads ⊂ cloud, not every atom
    heads = heads[::2]
    want = jn.make_dynamic_normals(heads, cloud, 2.5, True)
    got = tn.DynamicNormals(heads, cloud, 2.5, True)
    np.testing.assert_array_equal(got.aux_atoms, want.aux_info["atoms"])
    lut = np.full(coords.shape[1], -1)
    lut[got.aux_atoms] = np.arange(len(got.aux_atoms))
    aux = got.rebuild(lambda idx: lut[idx])
    full = got(_t(coords), _t(box))
    part = aux(_t(coords[:, got.aux_atoms]), _t(box))
    for a, b in zip(full, part):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ----------------------------------------------------- per-molecule steps

def _jax_normals(coords, box, heads, radius):
    """`gorder_tpu`'s dynamic normals of `coords` (f32) as numpy."""
    compute = jn.make_dynamic_normals(heads, np.arange(coords.shape[1]),
                                      radius, True)
    normals, counts = compute(coords, box)
    assert np.asarray(counts).min() >= 3
    return np.array(normals)


def _p2_case(seed, M=9):
    pb = _problem(seed=seed)
    rng = np.random.default_rng(seed + 100)
    bond_mol = rng.integers(0, M, len(pb["atom_a"])).astype(np.int32)
    classes = rng.integers(0, 3, (len(pb["box"]), M)).astype(np.int32)
    normals = _jax_normals(pb["coords"], pb["box"], np.arange(M), 4.0)
    return pb, bond_mol, classes, normals


def _port_p2(pb, kind, normal, bond_mol, classes=None):
    common = (_t(pb["box"]), _t(normal), _t(pb["mask"]), _t(pb["atom_a"]),
              _t(pb["atom_b"]), _t(pb["btype"]), pb["T"])
    kw = dict(handle_pbc=True, bond_mol=_t(bond_mol),
              classes=None if classes is None else _t(classes))
    if kind == "resid":
        return order_step(_t(pb["r"]), *common, _t(pb["inv"]),
                          _t(pb["base"]), **kw).numpy()
    if kind == "i16":
        return order_step(_t(pb["q"]), *common, _t(pb["inv"]), **kw).numpy()
    return order_step(_t(pb["coords"]), *common, **kw).numpy()


def _jax_p2(pb, kind, normal, bond_mol, classes, monkeypatch, pallas):
    """`gorder_tpu`'s per-molecule step → {class: (B, 2, T) int64}. Its
    Pallas kernel takes positions only with per-molecule normals, so the
    b7 residuals meet it as the int16 positions they were made from (the
    same integer bond vectors)."""
    monkeypatch.setenv("GORDER_TPU_PALLAS", "1" if pallas else "0")
    M = normal.shape[1]
    step = jax_make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                               bond_mol, pb["T"], M,
                               with_leaflets=classes is not None,
                               normal_mode="per_molecule")
    kw = dict(leaflet_classes=classes, use_pallas=pallas)
    if kind == "resid" and not pallas:
        out, _ = step.impl((pb["r"], pb["base"]), pb["box"], normal,
                           pb["mask"], inv_scale=pb["inv"],
                           resid_input=True, **kw)
    elif kind in ("resid", "i16"):
        out, _ = step.impl(pb["q"], pb["box"], normal, pb["mask"],
                           inv_scale=pb["inv"], **kw)
    else:
        out, _ = step.impl(pb["coords"], pb["box"], normal, pb["mask"], **kw)
    return {c: from_reference_rows(np.asarray(v)) for c, v in out.items()}


@pytest.mark.parametrize("leaflets", [False, True])
@pytest.mark.parametrize("kind", ["resid", "i16", "f32"])
def test_order_step_per_molecule_matches_xla(monkeypatch, kind, leaflets):
    pb, bond_mol, classes, normals = _p2_case(21)
    classes = classes if leaflets else None
    got = _port_p2(pb, kind, normals, bond_mol, classes)
    want = _jax_p2(pb, kind, normals, bond_mol, classes, monkeypatch, False)
    B, T = len(pb["box"]), pb["T"]
    if leaflets:
        assert got.shape == (B, 3, 2, T)
        for k, c in enumerate(CLASSES):
            np.testing.assert_array_equal(got[:, k], want[c])
        assert (got[:, 1, 1] + got[:, 2, 1] < got[:, 0, 1]).any()
    else:
        assert got.dtype == np.int64 and got.shape == (B, 2, T)
        np.testing.assert_array_equal(got, want["total"])
    assert not got[~pb["mask"]].any()


@pytest.mark.parametrize("leaflets", [False, True])
@pytest.mark.parametrize("kind", ["resid", "i16", "f32"])
def test_order_step_per_molecule_matches_pallas_interpret(monkeypatch, kind,
                                                          leaflets):
    pb, bond_mol, classes, normals = _p2_case(23)
    classes = classes if leaflets else None
    got = _port_p2(pb, kind, normals, bond_mol, classes)
    want = _jax_p2(pb, kind, normals, bond_mol, classes, monkeypatch, True)
    for k, c in enumerate(CLASSES if leaflets else ("total",)):
        g = got[:, k] if leaflets else got
        np.testing.assert_array_equal(g[:, 1], want[c][:, 1])
        assert (np.abs(g[:, 0] - want[c][:, 0]) <= want[c][:, 1]).all()


def _ua_case(seed, with_ch1u, leaflets, kind):
    from .test_torch_ua import _inputs, _no_ch1u

    coords, box, mask, cats, btype, bmol, T, n_mols = _ua_problem(
        seed, B=12, n_mols=30)
    normals = _jax_normals(coords, box, np.arange(n_mols) * 10, 2.5)
    if not with_ch1u:
        n = {c: len(cats[c]["target"]) * ua.N_HYDROGENS[c] for c in cats}
        keep = np.concatenate([np.full(n[c], c != "ch1u")
                               for c in ua.CATEGORIES if c in cats])
        cats, btype = _no_ch1u(cats, btype)
        bmol = bmol[keep]
    classes = (np.random.default_rng(seed).integers(0, 3, (12, n_mols))
               .astype(np.int32) if leaflets else None)
    coords, inv = _inputs(kind, coords)
    return coords, inv, box, mask, cats, btype, bmol, T, normals, classes


def _port_ua(case):
    coords, inv, box, mask, cats, btype, bmol, T, normals, classes = case
    step = ua.make_ua_step(cats, btype, bmol, T, device="cpu",
                           with_leaflets=classes is not None,
                           normal_mode="per_molecule")
    out = step.positions(_t(coords), _t(box), _t(normals), _t(mask),
                         inv_scale=None if inv is None else _t(inv),
                         classes=None if classes is None else _t(classes))
    return out.numpy()


def _jax_ua(case, monkeypatch, *, pallas=False, jit=False):
    coords, inv, box, mask, cats, btype, bmol, T, normals, classes = case
    monkeypatch.setenv("GORDER_TPU_PALLAS", "1" if pallas else "0")
    step = jua.make_ua_step(cats, btype, bmol, T,
                            with_leaflets=classes is not None,
                            normal_mode="per_molecule")
    assert step.pallas_active() == pallas
    call = step if jit or pallas else step.impl
    out, _ = call(coords, box, normals, mask, leaflet_classes=classes,
                  inv_scale=inv)
    return {c: from_reference_rows(np.asarray(v)) for c, v in out.items()}


def _rows(got, leaflets):
    return ({c: got[:, k] for k, c in enumerate(CLASSES)} if leaflets
            else {"total": got})


@pytest.mark.parametrize("with_ch1u", [False, True])
@pytest.mark.parametrize("leaflets", [False, True])
@pytest.mark.parametrize("kind", ["f32", "i16"])
def test_ua_step_per_molecule_matches_jax(monkeypatch, kind, leaflets,
                                          with_ch1u):
    case = _ua_case(31, with_ch1u, leaflets, kind)
    got = _rows(_port_ua(case), leaflets)
    op_by_op = _jax_ua(case, monkeypatch)
    jitted = _jax_ua(case, monkeypatch, jit=True)
    for c, g in got.items():
        for want in (op_by_op[c], jitted[c]):
            np.testing.assert_array_equal(g[:, 1], want[:, 1])
            assert (np.abs(g[:, 0] - want[:, 0]) <= g[:, 1]).all()
        if not with_ch1u:
            np.testing.assert_array_equal(g, op_by_op[c])
    assert got["total"][:, 1].sum() == case[3].sum() * len(case[5])


@pytest.mark.parametrize("kind", ["f32", "i16"])
def test_ua_step_per_molecule_matches_pallas(monkeypatch, kind):
    case = _ua_case(33, True, True, kind)
    got = _rows(_port_ua(case), True)
    want = _jax_ua(case, monkeypatch, pallas=True)
    for c, g in got.items():
        np.testing.assert_array_equal(g[:, 1], want[c][:, 1])
        assert (np.abs(g[:, 0] - want[c][:, 0]) <= want[c][:, 1]).all()


# ------------------------------------------------------------ the z plane

@pytest.mark.parametrize("kind", ["resid", "i16", "f32", "ua_i16",
                                  "ua_f32"])
def test_z_plane_equals_static(kind):
    """Per-molecule normals that are all (0, 0, 1) give the static step's
    integers bit for bit: n2 = 1 and proj is the same chain."""
    z = np.array([0.0, 0.0, 1.0], np.float32)
    if kind.startswith("ua"):
        case = _ua_case(35, True, False, kind[3:])
        plane = np.broadcast_to(z, case[8].shape).copy()
        coords, inv, box, mask, cats, btype, bmol, T, _, _ = case
        step = ua.make_ua_step(cats, btype, bmol, T, device="cpu")
        static = step.positions(_t(coords), _t(box), _t(z), _t(mask),
                                inv_scale=None if inv is None else _t(inv))
        got = _port_ua(case[:8] + (plane, None))
        np.testing.assert_array_equal(got, static.numpy())
        return
    pb, bond_mol, _, normals = _p2_case(37)
    plane = np.broadcast_to(z, normals.shape).copy()
    got = _port_p2(pb, kind, plane, bond_mol)
    common = (_t(pb["box"]), _t(z), _t(pb["mask"]), _t(pb["atom_a"]),
              _t(pb["atom_b"]), _t(pb["btype"]), pb["T"])
    args = {"resid": (_t(pb["r"]), *common, _t(pb["inv"]), _t(pb["base"])),
            "i16": (_t(pb["q"]), *common, _t(pb["inv"])),
            "f32": (_t(pb["coords"]), *common)}[kind]
    np.testing.assert_array_equal(
        got, order_step(*args, handle_pbc=True).numpy())


# ----------------------------------------------------------------- errors

_KINDS = [SimpleNamespace(name="POPC", n_molecules=2),
          SimpleNamespace(name="POPE", n_molecules=1)]
_V = [0.0, 0.0, 1.0]

MANUAL_CASES = {
    "not_a_map": ([[_V, _V]], _KINDS),
    "unknown_type": ({"POPC": [[_V, _V]], "POPE": [[_V]], "CHOL": [[_V]]},
                     _KINDS),
    "missing_type": ({"POPC": [[_V, _V]]}, _KINDS),
    "no_normals": ({"POPC": None, "POPE": [[_V]]}, _KINDS),
    "frame_counts": ({"POPC": [[_V, _V]], "POPE": [[_V], [_V]]}, _KINDS),
    "molecule_count": ({"POPC": [[_V, _V], [_V]], "POPE": [[_V], [_V]]},
                       _KINDS),
    "empty": ({}, []),
}


def _same_error(fn_port, fn_jax):
    with pytest.raises(Exception) as port:
        fn_port()
    with pytest.raises(Exception) as jax_:
        fn_jax()
    assert type(port.value).__name__ == type(jax_.value).__name__
    assert str(port.value) == str(jax_.value)
    return port.value


@pytest.mark.parametrize("case", sorted(MANUAL_CASES))
def test_manual_normal_errors_match_jax(case):
    mapping, kinds = MANUAL_CASES[case]
    err = _same_error(lambda: tnr._manual_normals_table(mapping, kinds),
                      lambda: jnr._manual_normals_table(mapping, kinds))
    assert type(err).__name__ == "ManualNormalError"


@pytest.mark.parametrize("case", ["missing", "unparsable"])
def test_normals_file_errors_match_jax(tmp_path, case):
    from gorder_tpu.input.config import MembraneNormal

    path = tmp_path / "normals.yaml"
    if case == "unparsable":
        path.write_text("POPC: [[0, 0, 1]\n  - ]: :\n")
    analysis = SimpleNamespace(
        membrane_normal=MembraneNormal.from_file(str(path)), leaflets=None)
    err = _same_error(
        lambda: tnr._build_normals(None, analysis, _KINDS, 3),
        lambda: jnr._build_normals(None, analysis, _KINDS, 3))
    assert type(err).__name__ == "ManualNormalError"


def test_frame_count_error_matches_jax():
    table = np.zeros((4, 3, 3), np.float32)
    _same_error(lambda: tnr.NormalsRuntime("manual", table=table).validate(5),
                lambda: jnr.NormalsRuntime("manual", table=table).validate(5))


def test_missing_leaflet_axis_error_matches_jax():
    """Leaflets beside a normal that is not static need their own axis
    (src/errors.rs:353-356)."""
    from gorder_tpu.input.config import LeafletClassification, MembraneNormal

    analysis = SimpleNamespace(
        membrane_normal=MembraneNormal.dynamic("name P"),
        leaflets=LeafletClassification.global_("all", "name P"))
    err = _same_error(
        lambda: tnr._build_normals(None, analysis, _KINDS, 3),
        lambda: jnr._build_normals(None, analysis, _KINDS, 3))
    assert type(err).__name__ == "ConfigError"


@pytest.mark.parametrize("least", [0.0, 2.0])
def test_not_enough_points_error_matches_jax(least):
    """The ≥3-points guard, checked when a batch drains, with the JAX
    engine's text (gorder_tpu/engine/fused.py:19-35)."""
    _same_error(
        lambda: tnr.check_normal_guard(torch.tensor(np.float32(least))),
        lambda: _pop_normal_guard({"_normal_guard": np.float32(least)}))
    tnr.check_normal_guard(torch.tensor(np.float32(3.0)))
