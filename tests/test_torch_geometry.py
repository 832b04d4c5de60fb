"""Geometry selection in the port (gorder_tpu_torch/core/geometry.py, the
geometry parts of core/order.py, core/ua.py, engine/wire.py and
engine/normals_runtime.py) held against the JAX package on the same
inputs, made from a seed with numpy, on the CPU.

- Op by op (the JAX functions called eagerly, or a step's unjitted
  `impl`): the inside masks, the bitplane and every plain step's int64
  sums and counts are equal bit for bit.
- Against the TPU kernel in interpret mode (`with_geom`, and `diff_input`
  for the b7 residuals): equal counts and |Δsum| ≤ n_samples quanta per
  (frame, type), the bound the JAX package holds its own kernel to
  (gorder_tpu/ops/pallas_p2.py:14-24).
- A selection's center sums in another order and with torch's cos/sin, so
  it agrees with the JAX package's to 1e-5 nm, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorder_tpu.core import geometry as jgeom
from gorder_tpu.core import ua as jua
from gorder_tpu.core.order import _geometry_reference
from gorder_tpu.core.order import make_order_step as jax_make_order_step
from gorder_tpu.engine.normals_runtime import (
    _make_molecule_inside as jax_molecule_inside)
from gorder_tpu_torch.core import geometry, ua
from gorder_tpu_torch.core.order import (from_reference_rows,
                                         geometry_reference, make_order_step)
from gorder_tpu_torch.engine.normals_runtime import _make_molecule_inside
from gorder_tpu_torch.engine.wire import geo_bits, pack_geo_bits
from gorder_tpu_torch.ops import p2

from .test_pallas_ua import _ua_problem
from .test_torch_b7 import encode_b7

t = torch.as_tensor

#: shapes as (kind, fields); spans and radii on a binary grid, so that
#: midpoints placed on their boundaries are exact in f32
SHAPES = {
    "cuboid": ("cuboid", dict(xdim=(-1.25, 2.5), ydim=(-0.75, 1.5),
                              zdim=(0.5, 1.75))),
    "cuboid_half_open": ("cuboid", dict(zdim=(0.0, np.inf))),
    "cylinder": ("cylinder", dict(radius=1.25, span=(-1.0, 2.25),
                                  orientation=0)),
    "cylinder_no_radius": ("cylinder", dict(span=(-0.5, 0.75),
                                            orientation=2)),
    "sphere": ("sphere", dict(radius=1.25)),
}


def _specs(name, invert):
    kind, fields = SHAPES[name]
    return (geometry.GeometrySpec(kind, invert=invert, **fields),
            jgeom.GeometrySpec(kind, invert=invert, **fields))


def _boundary_points(name, ref):
    """(B, K, 3) midpoints exactly on the shape's boundaries relative to the
    (B, 3) reference, and their f32 neighbours: on each finite span end, on
    the radius (0.75² + 1² = 1.25²) and a box length away."""
    kind, fields = SHAPES[name]
    offsets = []
    if kind == "cuboid":
        for axis, key in enumerate(("xdim", "ydim", "zdim")):
            for end in fields.get(key, (-np.inf, np.inf)):
                if np.isfinite(end):
                    v = np.zeros(3)
                    v[axis] = end
                    offsets.append(v)
    elif kind == "cylinder":
        a = fields["orientation"]
        p0, p1 = (k for k in range(3) if k != a)
        for end in fields["span"]:
            v = np.zeros(3)
            v[a] = end
            offsets.append(v)
        v = np.zeros(3)
        v[p0], v[p1] = 0.75, 1.0
        offsets.append(v)
    else:
        offsets += [np.array([0.75, 1.0, 0.0]), np.array([0.0, 0.75, -1.0])]
    offsets = np.asarray(offsets, np.float32)
    mid = ref[:, None, :] + offsets[None]
    up = np.nextafter(mid, np.float32(np.inf))
    down = np.nextafter(mid, np.float32(-np.inf))
    wrapped = mid + np.float32(8.0) * np.array([1, 0, 0], np.float32)
    return np.concatenate([mid, up, down, wrapped], axis=1).astype(np.float32)


@pytest.mark.parametrize("handle_pbc", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_inside_mask_matches_jax(shape, handle_pbc):
    """Bit for bit, inverted and not, on random midpoints and on midpoints
    exactly on every boundary (and an ulp either side of it)."""
    rng = np.random.default_rng(len(shape) + handle_pbc)
    B = 6
    box = np.tile(np.array([8.0, 6.0, 7.0], np.float32), (B, 1))
    box[1::2] = 9.0
    ref = (np.round(rng.uniform(0, 6, (B, 3)) * 64) / 64).astype(np.float32)
    mid = np.concatenate([rng.uniform(-2, 11, (B, 400, 3)),
                          _boundary_points(shape, ref)], axis=1) \
        .astype(np.float32)
    on_boundary = mid.shape[1] - 400
    for invert in (False, True):
        spec, jspec = _specs(shape, invert)
        got = geometry.inside_mask(t(mid), t(ref), t(box), spec,
                                   handle_pbc).numpy()
        want = np.asarray(jgeom.inside_mask(mid, ref, box, jspec,
                                            handle_pbc))
        np.testing.assert_array_equal(got, want)
        # a real subset: a half-open span covers the whole box under PBC
        covers_box = shape == "cuboid_half_open" and handle_pbc
        assert got[:, :400].any() != got[:, :400].all() or covers_box
        assert on_boundary > 0


def test_bounds_are_the_f64_values_rounded_once():
    """`lo`, `hi − lo` and `radius·radius` are f32 of the f64 values, as
    jnp's weak typing takes a Python float, not the f32 arithmetic of their
    f32 parts; and torch's tensor-scalar ops round a Python float as the
    host does, so the plain version's comparisons match the JAX package's
    where these differ."""
    lo, hi, r = 0.1, 0.7, 1.02
    g = geometry.shape_bounds(geometry.GeometrySpec(
        "cylinder", radius=r, span=(lo, hi), orientation=2))
    assert g.lo[2] == float(np.float32(lo))
    assert g.extent[2] == float(np.float32(hi - lo))
    assert g.radius2 == float(np.float32(r * r))
    # the f32 arithmetic would give other numbers
    assert g.extent[2] != float(np.float32(hi) - np.float32(lo))
    assert g.radius2 != float(np.float32(r) * np.float32(r))
    x = np.linspace(-1, 1, 1001, dtype=np.float32)
    np.testing.assert_array_equal((t(x) - lo).numpy(),
                                  np.asarray(jnp.asarray(x) - lo))
    np.testing.assert_array_equal((t(x) <= (hi - lo)).numpy(),
                                  np.asarray(jnp.asarray(x) <= (hi - lo)))


@pytest.mark.parametrize("mode", ["point", "selection_pbc",
                                  "selection_nopbc"])
def test_geometry_reference_matches_jax(mode):
    """A (B, 3) point is used as it is; a selection's center per frame
    agrees with `_geometry_reference` to 1e-5 nm (the sums reduce in
    another order)."""
    rng = np.random.default_rng(3)
    coords = rng.uniform(0, 9, (5, 60, 3)).astype(np.float32)
    box = np.full((5, 3), 9.0, np.float32)
    if mode == "point":
        ref = np.tile(np.array([1.5, 2.0, 3.25], np.float32), (5, 1))
        got = geometry_reference(t(coords), t(box), t(ref), True)
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    pbc = mode == "selection_pbc"
    sel = np.arange(3, 60, 4, dtype=np.int32)
    got = geometry_reference(t(coords), t(box), t(sel), pbc).numpy()
    want = np.asarray(_geometry_reference(coords, box, jnp.asarray(sel),
                                          pbc))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_bonds", [8, 19, 1001])
def test_geo_bits_match_jax(n_bonds):
    """`pack_geo_bits` and `geo_bits` are each other's inverse in the
    decoder's layout, and `geo_bits` gives the JAX package's bits."""
    from gorder_tpu.engine.fused import _build_fused_steps

    rng = np.random.default_rng(n_bonds)
    mask = rng.random((4, n_bonds)) < 0.5
    plane = pack_geo_bits(t(mask))
    assert plane.dtype == torch.uint8 and plane.shape == (
        4, (n_bonds + 7) // 8)
    np.testing.assert_array_equal(geo_bits(plane, n_bonds).numpy(), mask)
    # bit j of byte j >> 3, as the decoder writes it
    want = np.zeros(plane.shape, np.uint8)
    for j in np.nonzero(mask[0])[0]:
        want[0, j >> 3] |= 1 << (j & 7)
    np.testing.assert_array_equal(plane[0].numpy(), want[0])
    # gorder_tpu's fused programs unpack the same bits
    class Spy:
        """A step that gives back the plane it is handed."""

        def impl(self, coords, box, normal, mask, **kw):
            return {"plane": kw["geom_plane"]}, None

    get = _build_fused_steps(Spy(), n_out=3, use_pallas=False,
                             n_bonds=n_bonds)
    q = np.zeros((4, 3, 3), np.int16)
    out, _ = get("i16G")((q, plane.numpy()), np.ones(4, np.float32),
                         np.ones((4, 3), np.float32),
                         np.zeros(3, np.float32), np.ones(4, bool), None,
                         None)
    np.testing.assert_array_equal(np.asarray(out["plane"]),
                                  mask.astype(np.float32))


def _p2_problem(seed, B=16, A=64, N=700, T=5, M=6, prec=100.0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 10, (B, A, 3)).astype(np.float32)
    box = np.full((B, 3), 10.0, np.float32)
    box[1::2] = 7.5
    atom_a = rng.integers(0, A, N).astype(np.int32)
    atom_b = rng.integers(0, A, N).astype(np.int32)
    q = np.round(coords * prec).astype(np.int16)
    d = q[:, atom_b].astype(np.int32) - q[:, atom_a].astype(np.int32)
    flat = d.reshape(B, 3 * N)
    mask = np.ones(B, bool)
    mask[-3:] = False
    return dict(coords=coords, q=q, inv=np.full(B, 1.0 / prec, np.float32),
                base=flat[0].astype(np.int32),
                r=(flat - flat[0][None]).astype(np.int16), box=box,
                atom_a=atom_a, atom_b=atom_b, mask=mask, T=T, M=M,
                btype=rng.integers(0, T, N).astype(np.int32),
                bond_mol=rng.integers(0, M, N).astype(np.int32),
                classes=rng.integers(0, 2, (B, M)).astype(np.int32),
                normals=rng.normal(0, 1, (B, M, 3)).astype(np.float32),
                plane=rng.random((B, N)) < 0.6)


def _rows(out, classes):
    return np.stack([from_reference_rows(np.asarray(out[c])) for c in
                     (("total", "upper", "lower") if classes
                      else ("total",))], axis=1)


def _port_positions(pb, kind, classes, normals, **kw):
    step = make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                           pb["bond_mol"], pb["T"], pb["M"], device="cpu",
                           with_leaflets=classes,
                           normal_mode="per_molecule" if normals
                           else "static",
                           geom_spec=kw.pop("spec", geometry.GeometrySpec(
                               "sphere")))
    normal = (pb["normals"] if normals
              else np.array([0, 0, 1], np.float32))
    coords, inv = ((pb["q"], pb["inv"]) if kind == "i16"
                   else (pb["coords"], None))
    out = step.positions(t(coords), t(pb["box"]), t(normal), t(pb["mask"]),
                         inv_scale=None if inv is None else t(inv),
                         classes=t(pb["classes"]) if classes else None,
                         **kw).numpy()
    return out if classes else out[:, None]


CASES = {"i16": ("i16", False, False), "f32": ("f32", False, False),
         "i16_classes": ("i16", True, False),
         "f32_normals": ("f32", False, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_step_with_plane_matches_jax(monkeypatch, case):
    """A given geometry plane: op by op against the XLA path (bit for bit)
    and against the `with_geom` TPU kernel in interpret mode (equal counts,
    |Δsum| ≤ n_samples)."""
    kind, classes, normals = CASES[case]
    pb = _p2_problem(len(case))
    plane = pb["plane"]
    got = _port_positions(pb, kind, classes, normals,
                          geo=pack_geo_bits(t(plane)))
    monkeypatch.setenv("GORDER_TPU_PALLAS", "1")
    jspec = jgeom.GeometrySpec("sphere")
    jstep = jax_make_order_step(
        pb["atom_a"], pb["atom_b"], pb["btype"], pb["bond_mol"], pb["T"],
        pb["M"], with_leaflets=classes,
        normal_mode="per_molecule" if normals else "static",
        geom_spec=jspec)
    assert jstep.pallas_active()
    coords, inv = ((pb["q"], pb["inv"]) if kind == "i16"
                   else (pb["coords"], None))
    normal = pb["normals"] if normals else np.array([0, 0, 1], np.float32)
    kw = dict(leaflet_classes=pb["classes"] if classes else None,
              inv_scale=inv, geom_plane=plane.astype(np.float32))
    xla, _ = jstep.impl(coords, pb["box"], normal, pb["mask"], **kw,
                        use_pallas=False)
    np.testing.assert_array_equal(got, _rows(xla, classes))
    kernel, _ = jstep.impl(coords, pb["box"], normal, pb["mask"], **kw,
                           use_pallas=True)
    want = _rows(kernel, classes)
    np.testing.assert_array_equal(got[:, :, 1], want[:, :, 1])
    assert (np.abs(got[:, :, 0] - want[:, :, 0]) <= want[:, :, 1]).all()
    # the plane keeps a real subset
    assert 0 < got[:, 0, 1].sum() < pb["mask"].sum() * len(pb["btype"])


REF_CASES = {"i16_cylinder_point": ("i16", False, False, "cylinder"),
             "f32_cuboid_center": ("f32", False, False, "cuboid"),
             "i16_sphere_selection": ("i16", True, True, "sphere"),
             "i16_cylinder_selection_nopbc": ("i16", False, False,
                                              "cylinder")}


@pytest.mark.parametrize("case", list(REF_CASES))
def test_step_computes_the_plane_as_jax(case):
    """Without a decoder bitplane the step computes the inside mask from
    positions and the batch's reference: the single rounding f32(q_b −
    q_a)·s with p_a = f32(q_a)·s for int16, the pair difference for f32
    (gorder_tpu/core/order.py:163-178, :201-214). Bit for bit against the
    XLA path op by op."""
    kind, classes, normals, shape = REF_CASES[case]
    pbc = not case.endswith("nopbc")
    pb = _p2_problem(len(case))
    spec, jspec = _specs(shape, invert=False)
    if case.endswith("point"):
        geom_ref = np.tile(np.array([5.0, 4.0, 5.5], np.float32), (16, 1))
    elif case.endswith("center"):
        geom_ref = pb["box"] * np.float32(0.5)
    else:
        geom_ref = np.arange(0, 64, 5, dtype=np.int32)
    step = make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                           pb["bond_mol"], pb["T"], pb["M"], device="cpu",
                           handle_pbc=pbc, with_leaflets=classes,
                           normal_mode="per_molecule" if normals
                           else "static", geom_spec=spec)
    normal = pb["normals"] if normals else np.array([0, 0, 1], np.float32)
    coords, inv = ((pb["q"], pb["inv"]) if kind == "i16"
                   else (pb["coords"], None))
    out = step.positions(t(coords), t(pb["box"]), t(normal), t(pb["mask"]),
                         inv_scale=None if inv is None else t(inv),
                         classes=t(pb["classes"]) if classes else None,
                         geom_ref=t(geom_ref)).numpy()
    got = out if classes else out[:, None]
    jstep = jax_make_order_step(
        pb["atom_a"], pb["atom_b"], pb["btype"], pb["bond_mol"], pb["T"],
        pb["M"], handle_pbc=pbc, with_leaflets=classes,
        normal_mode="per_molecule" if normals else "static",
        geom_spec=jspec)
    want, _ = jstep.impl(coords, pb["box"], normal, pb["mask"],
                         leaflet_classes=pb["classes"] if classes else None,
                         inv_scale=inv, geom_ref=jnp.asarray(geom_ref))
    np.testing.assert_array_equal(got, _rows(want, classes))
    assert 0 < got[:, 0, 1].sum() < pb["mask"].sum() * len(pb["btype"])


def test_resid_with_bitplane_matches_pallas_diff_input():
    """`p2_b7` with the bitplane (the b7geo wire's route) against the TPU
    kernel's `diff_input` + `with_geom` variant in interpret mode, on the
    same bond vectors: equal counts, |Δsum| ≤ n_samples."""
    from gorder_tpu.ops.pallas_p2 import make_pallas_order_step

    pb = _p2_problem(31)
    got = p2.p2_b7(*map(t, encode_b7(pb["r"])), t(pb["base"]), t(pb["inv"]),
                   t(pb["box"]), t(np.array([0, 0, 1], np.float32)),
                   t(pb["mask"]), t(pb["btype"]), pb["T"], handle_pbc=True,
                   geo=pack_geo_bits(t(pb["plane"]))).numpy()
    step = make_pallas_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                                  pb["bond_mol"], pb["T"], diff_input=True,
                                  with_geom=True)
    dq = (pb["base"][None] + pb["r"].astype(np.int32)).reshape(16, -1, 3)
    out, _ = step.impl(dq, pb["box"], np.array([0, 0, 1], np.float32),
                       pb["mask"], inv_scale=pb["inv"],
                       geom_plane=pb["plane"].astype(np.float32))
    want = from_reference_rows(np.asarray(out["total"]))
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    assert (np.abs(got[:, 0] - want[:, 0]) <= want[:, 1]).all()
    assert 0 < got[:, 1].sum() < pb["mask"].sum() * len(pb["btype"])


@pytest.mark.parametrize("classes", [False, True])
def test_resid_with_bitplane_matches_xla_diff_input(classes):
    """`p2_b7` with the bitplane against the XLA path's `diff_input`
    with the geometry plane (the b7geo route of `step_impl`), op by op: bit
    for bit, with and without classes."""
    pb = _p2_problem(37)
    got = p2.p2_b7(*map(t, encode_b7(pb["r"])), t(pb["base"]), t(pb["inv"]),
                   t(pb["box"]), t(np.array([0, 0, 1], np.float32)),
                   t(pb["mask"]), t(pb["btype"]), pb["T"], handle_pbc=True,
                   classes=t(pb["classes"]) if classes else None,
                   bond_mol=t(pb["bond_mol"]) if classes else None,
                   geo=pack_geo_bits(t(pb["plane"]))).numpy()
    jstep = jax_make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                                pb["bond_mol"], pb["T"], pb["M"],
                                with_leaflets=classes)
    out, _ = jstep.impl((pb["r"], pb["base"]), pb["box"],
                        np.array([0, 0, 1], np.float32), pb["mask"],
                        leaflet_classes=pb["classes"] if classes else None,
                        inv_scale=pb["inv"],
                        geom_plane=pb["plane"].astype(np.float32),
                        resid_input=True)
    want = _rows(out, classes)
    np.testing.assert_array_equal(got if classes else got[:, None], want)


@pytest.mark.parametrize("shape", ["cuboid", "cylinder", "sphere"])
def test_ua_step_geometry_matches_xla(monkeypatch, shape):
    """The plain UA step with a geometry (the bond position h + v·0.5
    against a selection's center, or a point) against `_ua_step_impl` op by
    op, on the categories without CH1u (whose atan2/cos/sin differ in the
    last bits between XLA:CPU and torch): bit for bit, int16 and f32."""
    from .test_torch_ua import _inputs, _no_ch1u

    monkeypatch.setenv("GORDER_TPU_PALLAS", "0")
    coords, box, mask, cats, btype, bmol, T, _ = _ua_problem(
        len(shape), B=8, n_mols=30)
    cats, btype = _no_ch1u(cats, btype)
    spec, jspec = _specs(shape, invert=shape == "sphere")
    geom_ref = (np.arange(0, 300, 7, dtype=np.int32) if shape != "cuboid"
                else np.tile(np.array([3.0, 2.5, 3.5], np.float32), (8, 1)))
    for kind in ("i16", "f32"):
        c, inv = _inputs(kind, coords)
        step = ua.make_ua_step(cats, btype, None, T, device="cpu",
                               geom_spec=spec)
        got = step.positions(t(c), t(box), t(np.array([0, 0, 1],
                                                      np.float32)),
                             t(mask), inv_scale=None if inv is None
                             else t(inv), geom_ref=t(geom_ref)).numpy()
        jstep = jua.make_ua_step(cats, btype, np.zeros(len(btype), np.int32),
                                 T, geom_spec=jspec)
        out, _ = jstep.impl(c, box, np.array([0, 0, 1], np.float32), mask,
                            inv_scale=inv, geom_ref=jnp.asarray(geom_ref))
        np.testing.assert_array_equal(got, from_reference_rows(
            np.asarray(out["total"])))
        assert 0 < got[:, 1].sum() < mask.sum() * len(btype)


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_molecule_inside_matches_jax(handle_pbc):
    """The molecules with ≥ 1 bond midpoint inside the geometry, which an
    export of normals restricted to it keeps, equal the JAX package's."""
    pb = _p2_problem(41, M=300)
    spec, jspec = _specs("cylinder", invert=False)
    sel = np.arange(0, 64, 3, dtype=np.int32)
    got = _make_molecule_inside(pb["atom_a"], pb["atom_b"], pb["bond_mol"],
                                pb["M"], spec, handle_pbc)(
        t(pb["coords"]), t(pb["box"]), t(sel)).numpy()
    want = np.asarray(jax_molecule_inside(
        pb["atom_a"], pb["atom_b"], pb["bond_mol"], pb["M"], jspec,
        handle_pbc)(pb["coords"], pb["box"], jnp.asarray(sel)))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_jitted_jax_moves_boundary_midpoints():
    """Why the device-computed mask is compared op by op: jitted XLA:CPU
    contracts the midpoint p_a + (f32(q_b − q_a)·s)·0.5 into an FMA, so a
    midpoint that the XTC grid puts exactly on a shape boundary moves by an
    ulp and leaves the shape; the port and the op-by-op JAX path keep it
    (ROADMAP Queue 3)."""
    from gorder_tpu.core.pbc import min_image

    q = np.zeros((1, 2, 3), np.int16)
    q[0, 0] = (1000, 1000, 5004)
    q[0, 1] = (1000, 1000, 9996)
    inv = np.full(1, 1e-3, np.float32)
    box = np.full((1, 3), 11.0, np.float32)
    ref = np.full((1, 3), 5.5, np.float32)
    jspec = jgeom.GeometrySpec("cuboid", zdim=(0.0, 2.0))
    a, b = jnp.asarray([0]), jnp.asarray([1])

    def jax_plane(q, inv, box, ref):
        pa_i = jnp.take(q, a, axis=1).astype(jnp.int32)
        pb_i = jnp.take(q, b, axis=1).astype(jnp.int32)
        s = inv[:, None, None]
        d = min_image((pb_i - pa_i).astype(jnp.float32) * s,
                      box[:, None, :])
        mid = pa_i.astype(jnp.float32) * s + d * 0.5
        return jgeom.inside_mask(mid, ref, box, jspec, True), mid

    eager, mid = jax_plane(q, inv, box, ref)
    step = make_order_step(np.array([0]), np.array([1]), np.array([0]),
                           np.array([0]), 1, 1, device="cpu",
                           geom_spec=geometry.GeometrySpec(
                               "cuboid", zdim=(0.0, 2.0)))
    got = step.positions(t(q), t(box), t(np.array([0, 0, 1], np.float32)),
                         t(np.ones(1, bool)), inv_scale=t(inv),
                         geom_ref=t(ref))
    assert float(mid[0, 0, 2]) - 5.5 == 2.0     # exactly on the boundary
    assert bool(eager[0, 0]) and int(got[0, 1, 0]) == 1
    jitted, _ = jax.jit(jax_plane)(q, inv, box, ref)
    print(f"jitted XLA:CPU keeps the boundary midpoint: {bool(jitted[0, 0])}")
