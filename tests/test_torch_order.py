"""The PyTorch order step (gorder_tpu_torch/core/order.py) held against the
JAX package's step on the same inputs, on the CPU.

- Against the XLA path (GORDER_TPU_PALLAS=0): equal int64 sums and counts
  per frame and bond type. Both chains are separately rounded f32 steps in
  the same order (d² = dx·dx + dy·dy + dz·dz; the static normal is an
  axis, so the projection is one component exactly), and both quantize
  like the reference, so no tolerance is needed.
- Against the Pallas kernel in interpret mode (GORDER_TPU_PALLAS=1): equal
  counts and |Δsum| ≤ n_samples quanta per (frame, type), the bound the
  JAX package holds its own kernel to (gorder_tpu/ops/pallas_p2.py:14-24).
"""

import numpy as np
import pytest
import torch

from gorder_tpu.core.order import OrderAccumulator as JaxAccumulator
from gorder_tpu.core.order import make_order_step as jax_make_order_step
from gorder_tpu.core.order import quantize_split, recombine_limbs
from gorder_tpu_torch.core.geometry import GeometrySpec
from gorder_tpu_torch.core.order import (
    OrderAccumulator,
    from_reference_rows,
    make_order_step,
    order_step,
    quantize,
)
from gorder_tpu_torch.core.pbc import min_image
from gorder_tpu_torch.ops import p2

from .test_torch_b7 import encode_b7

NORMALS = {"z": [0.0, 0.0, 1.0], "x": [1.0, 0.0, 0.0]}


def _problem(seed=0, B=16, A=64, N=700, T=5, prec=100.0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 10, (B, A, 3)).astype(np.float32)
    box = np.full((B, 3), 10.0, np.float32)
    box[1::2] = 7.5                     # per-frame boxes differ
    atom_a = rng.integers(0, A, N).astype(np.int32)
    atom_b = rng.integers(0, A, N).astype(np.int32)
    btype = rng.integers(0, T, N).astype(np.int32)
    mask = np.ones(B, bool)
    mask[-3:] = False
    q = np.round(coords * prec).astype(np.int16)
    inv = np.full(B, 1.0 / prec, np.float32)
    d = q[:, atom_b].astype(np.int32) - q[:, atom_a].astype(np.int32)
    flat = d.reshape(B, 3 * N)
    base = flat[0].astype(np.int32)      # any exact-int base works
    r = (flat - base[None, :]).astype(np.int16)
    return dict(coords=coords, box=box, atom_a=atom_a, atom_b=atom_b,
                btype=btype, mask=mask, T=T, q=q, inv=inv, r=r, base=base)


def _port(pb, kind, normal, handle_pbc, rows=slice(None)):
    t = torch.as_tensor
    common = (t(pb["box"][rows]), t(np.asarray(normal, np.float32)),
              t(pb["mask"][rows]), t(pb["atom_a"]), t(pb["atom_b"]),
              t(pb["btype"]), pb["T"])
    if kind == "resid":
        return order_step(t(pb["r"][rows]), *common, t(pb["inv"][rows]),
                          t(pb["base"]), handle_pbc=handle_pbc).numpy()
    if kind == "i16":
        return order_step(t(pb["q"][rows]), *common, t(pb["inv"][rows]),
                          handle_pbc=handle_pbc).numpy()
    return order_step(t(pb["coords"][rows]), *common,
                      handle_pbc=handle_pbc).numpy()


def _jax(pb, kind, normal, handle_pbc, monkeypatch, pallas):
    monkeypatch.setenv("GORDER_TPU_PALLAS", "1" if pallas else "0")
    step = jax_make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                               np.zeros(len(pb["atom_a"]), np.int32),
                               pb["T"], 1, handle_pbc=handle_pbc)
    normal = np.asarray(normal, np.float32)
    if kind == "resid":
        out, _ = step.impl((pb["r"], pb["base"]), pb["box"], normal,
                           pb["mask"], inv_scale=pb["inv"],
                           resid_input=True, use_pallas=pallas)
    elif kind == "i16":
        out, _ = step.impl(pb["q"], pb["box"], normal, pb["mask"],
                           inv_scale=pb["inv"], use_pallas=pallas)
    else:
        out, _ = step.impl(pb["coords"], pb["box"], normal, pb["mask"],
                           use_pallas=pallas)
    return from_reference_rows(np.asarray(out["total"]))


@pytest.mark.parametrize("normal", ["z", "x"])
@pytest.mark.parametrize("handle_pbc", [True, False])
@pytest.mark.parametrize("kind", ["resid", "i16", "f32"])
def test_order_step_matches_xla(monkeypatch, kind, handle_pbc, normal):
    pb = _problem(seed=3)
    got = _port(pb, kind, NORMALS[normal], handle_pbc)
    want = _jax(pb, kind, NORMALS[normal], handle_pbc, monkeypatch,
                pallas=False)
    assert got.dtype == np.int64 and got.shape == (16, 2, pb["T"])
    np.testing.assert_array_equal(got, want)
    assert not got[-3:].any()            # masked frames contribute nothing


@pytest.mark.parametrize("kind", ["resid", "i16", "f32"])
def test_order_step_matches_pallas_interpret(monkeypatch, kind):
    pb = _problem(seed=5)
    got = _port(pb, kind, NORMALS["z"], True)
    want = _jax(pb, kind, NORMALS["z"], True, monkeypatch, pallas=True)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    assert (np.abs(got[:, 0] - want[:, 0]) <= want[:, 1]).all()


def test_batch_size_invariance():
    """Per-frame rows do not depend on the batch they ride in."""
    pb = _problem(seed=7)
    full = _port(pb, "resid", NORMALS["z"], True)
    halves = np.concatenate([
        _port(pb, "resid", NORMALS["z"], True, rows=slice(0, 5)),
        _port(pb, "resid", NORMALS["z"], True, rows=slice(5, None))])
    np.testing.assert_array_equal(full, halves)


def _half_quantum_values():
    """f32 values s with s·1e6 exactly on a half quantum (s = m/128 for odd
    m), plus their f32 neighbours."""
    m = np.arange(-63, 128, 2)
    s = (m / 128.0).astype(np.float32)
    return np.concatenate([s, np.nextafter(s, np.float32(2)),
                           np.nextafter(s, np.float32(-2))]).astype(np.float32)


def test_quantize_matches_reference_rounding():
    """Half-quantum samples round away from zero, like the reference's
    f64 product (and the JAX package's f32 two-product split)."""
    rng = np.random.default_rng(0)
    s = np.concatenate([_half_quantum_values(),
                        rng.uniform(-0.5, 1.0, 4000).astype(np.float32),
                        np.array([0.0, -0.5, 1.0, 5e-7, -5e-7], np.float32)])
    got = quantize(torch.as_tensor(s)).numpy()
    l2, l1, l0 = (np.asarray(v) for v in quantize_split(s))
    want = recombine_limbs(np.stack([l2, l1, l0, np.ones_like(l0)],
                                    axis=0))[0]
    np.testing.assert_array_equal(got, want)
    x = s.astype(np.float64) * 1e6
    np.testing.assert_array_equal(got, np.sign(x) * np.floor(np.abs(x)
                                                             + 0.5))
    assert got[0] == -492188                # −63/128 → −492187.5 → away


def _chain_sch(dx):
    """S of the bond vector (dx, 0, 1) against the z normal, with the
    separately rounded f32 steps of both packages."""
    one = np.float32(1.0)
    d2 = dx * dx + np.float32(0.0) * np.float32(0.0) + one * one
    return np.float32(1.5) * ((one * one) / d2) - np.float32(0.5)


def _boundary_vectors():
    """Bond vectors (dx, 0, 1) whose f32 chain gives S exactly on a half
    quantum: for each target S = m/128, walk dx through f32 neighbours of
    the exact solution until the chain hits it."""
    out = []
    for m in (1, 3, -1, -5, 7, 21, 45, -33):
        target = np.float32(m / 128.0)
        dx = np.float32(np.sqrt(1.0 / ((m / 128.0 + 0.5) / 1.5) - 1.0))
        for _ in range(4000):
            s = _chain_sch(dx)
            if s == target:
                out.append([dx, 0.0, 1.0])
                break
            dx = np.nextafter(dx, np.float32(0 if s < target else 10))
    assert len(out) >= 4, "no boundary vectors found"
    return np.asarray(out, np.float32)


def test_order_step_boundary_samples(monkeypatch):
    """Samples exactly on ±0.5 quanta: port and XLA path agree exactly,
    and each rounds half away from zero."""
    v = _boundary_vectors()
    n = len(v)
    B = 8
    coords = np.zeros((B, 2 * n, 3), np.float32)
    coords[:, 1::2] = v[None]
    pb = dict(coords=coords, box=np.full((B, 3), 50.0, np.float32),
              atom_a=np.arange(0, 2 * n, 2, dtype=np.int32),
              atom_b=np.arange(1, 2 * n, 2, dtype=np.int32),
              btype=np.arange(n, dtype=np.int32), mask=np.ones(B, bool),
              T=n)
    got = _port(pb, "f32", NORMALS["z"], True)
    want = _jax(pb, "f32", NORMALS["z"], True, monkeypatch, pallas=False)
    np.testing.assert_array_equal(got, want)
    x = np.array([_chain_sch(dx) for dx in v[:, 0]], np.float64) * 1e6
    assert np.all(np.abs(x - np.trunc(x)) == 0.5)
    np.testing.assert_array_equal(got[0, 0],
                                  np.sign(x) * np.floor(np.abs(x) + 0.5))


def test_min_image_matches_jax():
    """Half-box displacements round half to even in both packages."""
    from gorder_tpu.core.pbc import min_image as jax_min_image

    rng = np.random.default_rng(1)
    box = np.array([[4.0, 6.0, 10.0]], np.float32)
    d = np.concatenate([rng.uniform(-20, 20, (200, 3)),
                        np.array([[2.0, 3.0, 5.0], [-2.0, -3.0, -5.0],
                                  [6.0, 9.0, 15.0], [-6.0, 9.0, -15.0]])]
                       ).astype(np.float32)
    got = min_image(torch.as_tensor(d), torch.as_tensor(box)).numpy()
    want = np.asarray(jax_min_image(d, box))
    np.testing.assert_array_equal(got, want)


def test_accumulator_matches_reference():
    """Sums, counts and timewise series of the port's accumulator equal
    the JAX package's on the same per-frame outputs."""
    rng = np.random.default_rng(2)
    T = 6
    rows = [np.stack([rng.integers(-40, 40, (8, T)),
                      rng.integers(0, 120, (8, T)),
                      rng.integers(0, 128, (8, T)),
                      rng.integers(0, 30, (8, T))], axis=1).astype(np.float32)
            for _ in range(3)]
    ref = JaxAccumulator(T, keep_timewise=True)
    port = OrderAccumulator(T, keep_timewise=True)
    for r, n_valid in zip(rows, (8, 8, 5)):
        ref.add_batch({"total": r}, n_valid)
        port.add_batch({"total": from_reference_rows(r)}, n_valid)
    np.testing.assert_array_equal(port.sums["total"], ref.sums["total"])
    np.testing.assert_array_equal(port.counts["total"], ref.counts["total"])
    assert port.n_frames == ref.n_frames == 21
    for a, b in zip(port.timewise("total"), ref.timewise("total")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.order_values("total"),
                                  ref.order_values("total"))


def test_step_routes_cpu_tensors_to_plain():
    pb = _problem(seed=9)
    step = make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                           np.zeros(len(pb["atom_a"]), np.int32), pb["T"], 1,
                           device="cpu")
    t = torch.as_tensor
    before = p2.p2_launches
    got = step.b7(*map(t, encode_b7(pb["r"])), t(pb["base"]), t(pb["inv"]),
                  t(pb["box"]), t(np.asarray(NORMALS["z"], np.float32)),
                  t(pb["mask"]))
    assert p2.p2_launches == before     # the plain version is no launch
    np.testing.assert_array_equal(got.numpy(),
                                  _port(pb, "resid", NORMALS["z"], True))
    got16 = step.positions(t(pb["q"]), t(pb["box"]),
                           t(np.asarray(NORMALS["z"], np.float32)),
                           t(pb["mask"]), inv_scale=t(pb["inv"]))
    np.testing.assert_array_equal(got16.numpy(), got.numpy())


_SPHERE = GeometrySpec("sphere", radius=1.0)


@pytest.mark.parametrize("option", [
    # leaflets, per-molecule normals, ordermaps and geometry are all
    # ported: the factory takes each (it refused geometry once), and a
    # geometry step refuses a call that gives it neither the batch's
    # bitplane nor its reference
    dict(with_leaflets=True, normal_mode="per_molecule", geom_spec=_SPHERE),
    dict(normal_mode="per_molecule", geom_spec=_SPHERE),
    dict(map_spec=object(), geom_spec=_SPHERE), dict(geom_spec=_SPHERE)])
def test_make_order_step_rejects_unported(option):
    step = make_order_step(np.zeros(2, np.int32), np.ones(2, np.int32),
                           np.zeros(2, np.int32), np.zeros(2, np.int32), 1, 1,
                           device="cpu", **option)
    assert step.geom_spec is _SPHERE
    normal = (torch.zeros((1, 1, 3)) if "normal_mode" in option
              else torch.tensor([0.0, 0.0, 1.0]))
    classes = (torch.zeros((1, 1), dtype=torch.int32)
               if option.get("with_leaflets") else None)
    with pytest.raises(ValueError, match="geom_ref"):
        step.positions(torch.zeros((1, 2, 3)), torch.ones((1, 3)), normal,
                       torch.ones(1, dtype=torch.bool), classes=classes)
    with pytest.raises(ValueError, match="geometry bitplane|ordermap"):
        step.b7(torch.zeros((1, 7), dtype=torch.uint8),
                torch.zeros((1, 1), dtype=torch.int16),
                torch.zeros((1, 1), dtype=torch.int16),
                torch.zeros(6, dtype=torch.int32), torch.ones(1),
                torch.ones((1, 3)), normal,
                torch.ones(1, dtype=torch.bool), classes=classes)


@pytest.mark.parametrize("with_leaflets", [False, True])
def test_make_order_step_runs_per_molecule(monkeypatch, with_leaflets):
    """The step options that used to be refused: the per-molecule step now
    runs, and equals the JAX package's XLA path."""
    monkeypatch.setenv("GORDER_TPU_PALLAS", "0")
    pb = _problem(seed=13)
    M = 6
    rng = np.random.default_rng(14)
    bond_mol = rng.integers(0, M, len(pb["atom_a"])).astype(np.int32)
    normals = rng.normal(0, 1, (len(pb["box"]), M, 3)).astype(np.float32)
    classes = (rng.integers(0, 2, (len(pb["box"]), M)).astype(np.int32)
               if with_leaflets else None)
    step = make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                           bond_mol, pb["T"], M, device="cpu",
                           with_leaflets=with_leaflets,
                           normal_mode="per_molecule")
    t = torch.as_tensor
    got = step.positions(t(pb["q"]), t(pb["box"]), t(normals), t(pb["mask"]),
                         inv_scale=t(pb["inv"]),
                         classes=None if classes is None else t(classes))
    jstep = jax_make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                                bond_mol, pb["T"], M,
                                with_leaflets=with_leaflets,
                                normal_mode="per_molecule")
    out, _ = jstep.impl(pb["q"], pb["box"], normals, pb["mask"],
                        leaflet_classes=classes, inv_scale=pb["inv"])
    want = np.stack([from_reference_rows(np.asarray(out[c])) for c in
                     (("total", "upper", "lower") if with_leaflets
                      else ("total",))], axis=1)
    np.testing.assert_array_equal(got.numpy(),
                                  want if with_leaflets else want[:, 0])
    with pytest.raises(ValueError, match="per_molecule"):
        step.positions(t(pb["q"]), t(pb["box"]),
                       t(np.array([0, 0, 1], np.float32)), t(pb["mask"]),
                       inv_scale=t(pb["inv"]),
                       classes=None if classes is None else t(classes))
