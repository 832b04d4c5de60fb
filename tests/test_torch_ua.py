"""The PyTorch UA step (gorder_tpu_torch/core/ua.py) held against the JAX
package's UA step on the same inputs, on the CPU.

Two forms of the JAX path are references here:

- op by op (the predictors called on arrays, or the step's unjitted body
  `step.impl`): every jnp operation is its own correctly rounded XLA
  computation, as every torch operation of the port is. The CH3, CH2 and
  CH1-saturated hydrogens are then bit-equal and the sums exact. The CH1-
  unsaturated predictor takes atan2, cos and sin, whose last bits differ
  between XLA:CPU and torch's CPU kernels, so there the hydrogens differ
  by at most one ulp and the sums by at most one 1e-6 quantum a sample.
- compiled (`jax.jit`, the production path): XLA's CPU backend always
  contracts a multiply and an add into an FMA, so its f32 chain rounds
  differently from any separately rounded one. The hydrogens then differ
  by at most a few ulp and the sums by at most one quantum a sample,
  |Δsum| ≤ n_samples per (frame, type): the bound the JAX package holds
  its own Pallas kernel to (gorder_tpu/ops/pallas_ua.py:19-22).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorder_tpu.core import ua as jua
from gorder_tpu_torch.core import ua
from gorder_tpu_torch.core.order import from_reference_rows

from .test_pallas_ua import _ua_problem

_JAX_PREDICT = {"ch3": jua.predict_ch3_planar, "ch2": jua.predict_ch2_planar,
                "ch1u": jua.predict_ch1_unsaturated_planar,
                "ch1s": jua.predict_ch1_saturated_planar}


def test_pinned_constants_are_xlas():
    """The six cos/sin values are those XLA folds jnp.cos/jnp.sin of the
    constant angles to, in the jitted step; π is f32(jnp.pi)."""
    def folded(a):
        return jax.jit(lambda: (jnp.cos(a), jnp.sin(a)))()

    got = []
    for angle in (jua.TETRAHEDRAL_ANGLE, jua.TETRAHEDRAL_ANGLE_HALF,
                  jua.CH3_ANGLE):
        c, s = folded(angle)
        cn, sn = folded(-angle)
        assert (float(cn), float(sn)) == (float(c), -float(s))
        got += [float(c), float(s)]
    assert tuple(got) == ua.TRIG
    assert ua.PI_F32 == float(jnp.float32(jnp.pi))
    assert ua.BOND_LENGTH == float(jua.BOND_LENGTH)
    # the one value XLA folds differently from numpy (and torch)
    assert ua.SIN_TET != float(np.sin(jua.TETRAHEDRAL_ANGLE))


def _planes(seed, B=6, n=2000):
    rng = np.random.default_rng(seed)
    return [tuple(rng.uniform(0, 6, (B, n)).astype(np.float32)
                  for _ in range(3)) for _ in range(4)]


def _ulps(a, b):
    """max |a − b| in ulps of the 6 nm box edge (4.8e-7 nm): positions
    lie in [0, 6) nm."""
    return float(np.abs(a - b).max()) / float(np.spacing(np.float32(6.0)))


@pytest.mark.parametrize("handle_pbc", [True, False])
@pytest.mark.parametrize("category", ["ch3", "ch2", "ch1u", "ch1s"])
def test_predictor_matches_jax(category, handle_pbc):
    planes = _planes(len(category) + handle_pbc)
    args = planes if category == "ch1s" else planes[:3]
    B = args[0][0].shape[0]
    box = tuple(np.full((B, 1), 6.0, np.float32) for _ in range(3))
    got = ua._PREDICT[category](
        *[tuple(map(torch.from_numpy, p)) for p in args],
        tuple(map(torch.from_numpy, box)), handle_pbc)
    fj = _JAX_PREDICT[category]
    eager = fj(*[tuple(map(jnp.asarray, p)) for p in args],
               tuple(map(jnp.asarray, box)), handle_pbc)
    jitted = jax.jit(lambda *a: fj(*a, handle_pbc))(*args, box)
    assert len(got) == len(eager) == ua.N_HYDROGENS[category]
    for h, he, hj in zip(got, eager, jitted):
        for c, ce, cj in zip(h, he, hj):
            c = c.numpy()
            if category == "ch1u":
                assert _ulps(c, np.asarray(ce)) <= 1.0     # measured: 1
            else:
                np.testing.assert_array_equal(c, np.asarray(ce))
            # measured over six seeds: 1 (CH3, CH1s), 2 (CH2), 3 (CH1u)
            assert _ulps(c, np.asarray(cj)) <= 4.0


def test_acos_is_xlas_form():
    """`acos_xla` is the atan2 expansion XLA compiles jnp.arccos to; on
    these inputs torch's and XLA's CPU atan2 agree within one ulp."""
    x = np.random.default_rng(3).uniform(-1, 1, 100_000).astype(np.float32)
    hlo = jax.jit(jnp.arccos).lower(x).compile().as_text()
    assert "atan2" in hlo and "sqrt" in hlo
    got = ua.acos_xla(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.arccos)(x))
    assert float((np.abs(got - want) / np.spacing(want)).max()) <= 1.0


def _inputs(kind, coords, prec=200.0):
    if kind == "f32":
        return coords, None
    return (np.round(coords * prec).astype(np.int16),
            np.full(len(coords), 1.0 / prec, np.float32))


def _port(cats, btype, T, coords, inv, box, mask, handle_pbc):
    step = ua.make_ua_step(cats, btype, None, T, handle_pbc=handle_pbc,
                           device="cpu")
    t = torch.from_numpy
    out = step.positions(t(coords), t(box), t(np.array([0, 0, 1],
                                                         np.float32)),
                         t(mask), inv_scale=None if inv is None else t(inv))
    return out.numpy()


def _jax_rows(cats, btype, bmol, T, coords, inv, box, mask, handle_pbc,
              *, jit):
    step = jua.make_ua_step(cats, btype, bmol, T, handle_pbc=handle_pbc)
    normal = np.array([0, 0, 1], np.float32)
    if jit:
        out, _ = step(coords, box, normal, mask, inv_scale=inv)
    else:
        out, _ = step.impl(coords, box, normal, mask, inv_scale=inv)
    return from_reference_rows(np.asarray(out["total"]))


def _no_ch1u(cats, btype):
    """The problem without its CH1u atoms (their samples dropped)."""
    n = {c: len(cats[c]["target"]) * ua.N_HYDROGENS[c] for c in cats}
    keep = np.concatenate([np.full(n[c], c != "ch1u")
                           for c in ua.CATEGORIES if c in cats])
    return ({c: d for c, d in cats.items() if c != "ch1u"}, btype[keep])


@pytest.mark.parametrize("with_ch1u", [False, True])
@pytest.mark.parametrize("handle_pbc", [True, False])
@pytest.mark.parametrize("kind", ["f32", "i16"])
def test_plain_step_matches_xla(monkeypatch, kind, handle_pbc, with_ch1u):
    monkeypatch.setenv("GORDER_TPU_PALLAS", "0")
    coords, box, mask, cats, btype, bmol, T, _ = _ua_problem(
        4 + handle_pbc, B=16, n_mols=40)
    if not with_ch1u:
        cats, btype = _no_ch1u(cats, btype)
    bmol = np.zeros(len(btype), np.int32)
    coords, inv = _inputs(kind, coords)
    got = _port(cats, btype, T, coords, inv, box, mask, handle_pbc)
    op_by_op = _jax_rows(cats, btype, bmol, T, coords, inv, box, mask,
                         handle_pbc, jit=False)
    jitted = _jax_rows(cats, btype, bmol, T, coords, inv, box, mask,
                       handle_pbc, jit=True)
    counts = got[:, 1]
    for want in (op_by_op, jitted):
        np.testing.assert_array_equal(counts, want[:, 1])
        assert (np.abs(got[:, 0] - want[:, 0]) <= counts).all()
    if not with_ch1u:
        np.testing.assert_array_equal(got, op_by_op)
    assert not got[~mask].any() and counts[mask].sum() == mask.sum() * len(
        btype)


def test_plain_step_matches_pallas(monkeypatch):
    """Against the JAX package's Pallas UA kernel in interpret mode."""
    monkeypatch.setenv("GORDER_TPU_PALLAS", "1")
    coords, box, mask, cats, btype, bmol, T, _ = _ua_problem(7)
    step = jua.make_ua_step(cats, btype, bmol, T)
    assert step.pallas_active()
    normal = np.array([0, 0, 1], np.float32)
    for kind in ("f32", "i16"):
        c, inv = _inputs(kind, coords)
        out, _ = step(c, box, normal, mask, inv_scale=inv)
        want = from_reference_rows(np.asarray(out["total"]))
        got = _port(cats, btype, T, c, inv, box, mask, True)
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
        assert (np.abs(got[:, 0] - want[:, 0]) <= want[:, 1]).all()


def test_batch_size_invariance():
    """Frame rows do not depend on the batch they ride in."""
    coords, box, mask, cats, btype, _, T, _ = _ua_problem(9, B=12)
    mask[:] = True
    for kind in ("f32", "i16"):
        c, inv = _inputs(kind, coords)
        whole = _port(cats, btype, T, c, inv, box, mask, True)
        parts = [_port(cats, btype, T, c[s], None if inv is None else inv[s],
                       box[s], mask[s], True)
                 for s in (slice(0, 5), slice(5, 12))]
        np.testing.assert_array_equal(whole, np.concatenate(parts))


def test_wrapper_runs_plain_on_cpu():
    """On CPU tensors the wrapper is the plain version and counts no
    launch."""
    from gorder_tpu_torch.ops import ua as ops_ua

    coords, box, mask, cats, btype, _, T, _ = _ua_problem(11, B=4)
    step = ua.make_ua_step(cats, btype, None, T, device="cpu")
    t = torch.from_numpy
    args = (t(coords), None, t(box), t(np.array([0, 0, 1], np.float32)),
            t(mask), step.indices, step.bond_type, T)
    before = ops_ua.ua_launches
    got = ops_ua.ua_positions(*args, handle_pbc=True, layout=step.layout)
    want = ops_ua.ua_positions_plain(*args, handle_pbc=True,
                                     layout=step.layout)
    assert ops_ua.ua_launches == before
    assert torch.equal(got, want)
    assert step.layout == (("ch3", 12), ("ch2", 36), ("ch1u", 12),
                           ("ch1s", 12))


@pytest.mark.parametrize("option", ["with_leaflets", "normal_mode",
                                    "map_spec", "geom_spec"])
def test_make_ua_step_refuses_unported(option):
    """Leaflets, per-molecule normals, ordermaps and geometry are all
    ported: the factory takes each beside a geometry (it refused geometry
    once), and a geometry step refuses a call without the batch's
    reference."""
    from gorder_tpu_torch.core.geometry import GeometrySpec

    coords, box, mask, cats, btype, bmol, T, _ = _ua_problem(0, B=2,
                                                             n_mols=2)
    spec = GeometrySpec("sphere", radius=1.0)
    kw = {"with_leaflets": True, "normal_mode": "per_molecule",
          "map_spec": object(), "geom_spec": spec}
    step = ua.make_ua_step(cats, btype, bmol, T, device="cpu",
                           **{option: kw[option], "geom_spec": spec})
    assert step.geom_spec is spec
    normal = (torch.zeros((2, 2, 3)) if option == "normal_mode"
              else torch.tensor([0.0, 0.0, 1.0]))
    classes = (torch.zeros((2, 2), dtype=torch.int32)
               if option == "with_leaflets" else None)
    with pytest.raises(ValueError, match="geom_ref"):
        step.positions(torch.from_numpy(coords), torch.from_numpy(box),
                       normal, torch.from_numpy(mask), classes=classes)


@pytest.mark.parametrize("with_leaflets", [False, True])
def test_make_ua_step_runs_per_molecule(monkeypatch, with_leaflets):
    """The step options that used to be refused: the per-molecule UA step
    (with leaflets too) now runs, and equals the JAX package's step op by
    op on the categories without CH1u."""
    monkeypatch.setenv("GORDER_TPU_PALLAS", "0")
    coords, box, mask, cats, btype, bmol, T, n_mols = _ua_problem(
        15, B=8, n_mols=20)
    n = {c: len(cats[c]["target"]) * ua.N_HYDROGENS[c] for c in cats}
    keep = np.concatenate([np.full(n[c], c != "ch1u")
                           for c in ua.CATEGORIES if c in cats])
    cats, btype = _no_ch1u(cats, btype)
    bmol = bmol[keep]
    rng = np.random.default_rng(16)
    normals = rng.normal(0, 1, (len(box), n_mols, 3)).astype(np.float32)
    classes = (rng.integers(0, 2, (len(box), n_mols)).astype(np.int32)
               if with_leaflets else None)
    step = ua.make_ua_step(cats, btype, bmol, T, device="cpu",
                           with_leaflets=with_leaflets,
                           normal_mode="per_molecule")
    t = torch.from_numpy
    got = step.positions(t(coords), t(box), t(normals), t(mask),
                         classes=None if classes is None else t(classes))
    jstep = jua.make_ua_step(cats, btype, bmol, T,
                             with_leaflets=with_leaflets,
                             normal_mode="per_molecule")
    out, _ = jstep.impl(coords, box, normals, mask, leaflet_classes=classes)
    want = np.stack([from_reference_rows(np.asarray(out[c])) for c in
                     (("total", "upper", "lower") if with_leaflets
                      else ("total",))], axis=1)
    np.testing.assert_array_equal(got.numpy(),
                                  want if with_leaflets else want[:, 0])
