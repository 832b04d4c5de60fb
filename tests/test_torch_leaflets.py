"""Leaflet-wise order parameters in the port (gorder_tpu_torch/core/
leaflets.py, the `with_leaflets` steps, engine/leaflet_runtime.py and the
wire kinds that carry classes) held against `gorder_tpu` on the same
inputs, on the CPU.

- Classifiers: equal int32 classes. The global and local centers are sums
  that torch and XLA reduce in other orders, so the test membranes keep
  every head far (≥ 0.5 nm) from its center; the classes are compared,
  never the centers. With a center given (the decoder's COG channel), the
  arithmetic is elementwise and bit-equal.
- Steps: per-class int64 sums and counts equal to the XLA path op by op
  (the P2 step, and the UA step without CH1u); with CH1u and against the
  jitted UA program, within one 1e-6 quantum a sample (|Δsum| ≤ count),
  the bound of ROADMAP.md's exactness contract.
- The whole slice: `run_analysis(a, "cpu")` against `a.run()`; every
  non-`#` YAML line equal, and the exported leaflet file too. Each run
  asserts the wire it took.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from gorder_tpu.core import leaflets as jl
from gorder_tpu.core import ua as jua
from gorder_tpu.core.order import make_order_step as jax_make_order_step
from gorder_tpu.input import Analysis as JaxAnalysis
from gorder_tpu.input import AnalysisType as JaxAnalysisType
from gorder_tpu.input.config import Frequency, LeafletClassification
from gorder_tpu_torch.core import leaflets as tl
from gorder_tpu_torch.core import ua
from gorder_tpu_torch.core.order import from_reference_rows, order_step
from gorder_tpu_torch.engine import batches
from gorder_tpu_torch.engine.drivers import run_analysis

from .synthetic import make_flat_bilayer
from .test_pallas_ua import _ua_problem

CLASSES = ("total", "upper", "lower")
P_HEADS = "resname POPC and name P"
#: the card's batch (`engine.batches.default_batch_size`; the CPU's is
#: 128): the wire kinds asserted on whole runs here are those the bytes
#: policy picks for batches of 512 frames
CARD_BATCH = 512


# ------------------------------------------------------------ classifiers

def _membrane(seed, B=6, M=24, per=5, box=(6.0, 6.5, 8.0), centers=None):
    """B frames of M molecules of `per` atoms: heads (atom 0) of even
    molecules 1.8 nm above the membrane center along z, odd ones 1.8 nm
    below, tails toward the center. `centers` (B,) places the membrane per
    frame, across the periodic boundary when near 0 or box z."""
    rng = np.random.default_rng(seed)
    box = np.tile(np.asarray(box, np.float32), (B, 1))
    if centers is None:
        centers = rng.uniform(0, box[0, 2], B)
    coords = np.zeros((B, M * per, 3), np.float32)
    for m in range(M):
        side = 1.0 if m % 2 == 0 else -1.0
        xy = rng.uniform(0, box[0, :2], (B, 2))
        for k in range(per):
            z = centers + side * (1.8 - 0.35 * k)
            coords[:, m * per + k, :2] = xy + rng.normal(0, 0.05, (B, 2))
            coords[:, m * per + k, 2] = z + rng.normal(0, 0.05, B)
    coords = np.mod(coords, box[:, None, :]).astype(np.float32)
    heads = np.arange(M) * per
    methyls = np.stack([heads + per - 1, heads + per - 2], 1).ravel()
    methyl_mol = np.repeat(np.arange(M), 2)
    return coords, box, np.arange(M * per), heads, methyls, methyl_mol


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_global_classifier_matches_jax(handle_pbc):
    centers = None if handle_pbc else np.full(6, 4.0)
    coords, box, membrane, heads, _, _ = _membrane(1, centers=centers)
    want = jl.make_global_classifier(membrane, heads, 2, handle_pbc)
    got = tl.GlobalClassifier(membrane, heads, 2, handle_pbc)
    w = np.asarray(want(coords, box))
    assert w.dtype == np.int32 and set(np.unique(w)) == {0, 1}
    np.testing.assert_array_equal(got(_t(coords), _t(box)).numpy(), w)
    for a, b in zip(got.channel_info, want.channel_info):
        np.testing.assert_array_equal(a, b)
    # against a given center (the decoder's COG channel): bit-equal
    cog = np.random.default_rng(2).uniform(0, 8, 6).astype(np.float32)
    hpos = coords[:, heads]
    np.testing.assert_array_equal(
        got.channel(_t(hpos), _t(cog), _t(box)).numpy(),
        np.asarray(want.channel_impl(hpos, cog, box)))
    np.testing.assert_array_equal(
        got.channel_coords(_t(coords), _t(cog), _t(box)).numpy(),
        np.asarray(want.channel_coords_impl(coords, cog, box)))


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_local_classifier_matches_jax(handle_pbc):
    centers = None if handle_pbc else np.full(6, 4.0)
    coords, box, membrane, heads, _, _ = _membrane(3, centers=centers)
    want = np.asarray(jl.make_local_classifier(
        membrane, heads, 2, 2.0, handle_pbc)(coords, box))
    got = tl.LocalClassifier(membrane, heads, 2, 2.0, handle_pbc)
    np.testing.assert_array_equal(got(_t(coords), _t(box)).numpy(), want)
    # chunks of frames: the same classes whatever the chunk size
    small = tl.LocalClassifier(membrane, heads, 2, 2.0, handle_pbc,
                               max_elements=len(heads) * len(membrane) * 4)
    np.testing.assert_array_equal(small(_t(coords), _t(box)).numpy(), want)


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_individual_classifier_matches_jax(handle_pbc):
    centers = None if handle_pbc else np.full(6, 4.0)
    coords, box, _, heads, methyls, mm = _membrane(5, centers=centers)
    want = jl.make_individual_classifier(heads, methyls, mm, len(heads), 2,
                                         handle_pbc)
    got = tl.IndividualClassifier(heads, methyls, mm, len(heads), 2,
                                  handle_pbc)
    w = np.asarray(want(coords, box))
    np.testing.assert_array_equal(got(_t(coords), _t(box)).numpy(), w)
    # the aux channel's atom set, and the classifier rebuilt over it
    np.testing.assert_array_equal(got.aux_atoms, want.aux_info["atoms"])
    lut = np.full(coords.shape[1], -1)
    lut[got.aux_atoms] = np.arange(len(got.aux_atoms))
    aux = got.rebuild(lambda idx: lut[idx])
    np.testing.assert_array_equal(
        aux(_t(coords[:, got.aux_atoms]), _t(box)).numpy(), w)


def test_classifiers_on_another_axis():
    """A membrane normal along x: permuted coordinates, the same classes."""
    coords, box, membrane, heads, methyls, mm = _membrane(7)
    perm = [2, 0, 1]
    cx, bx = coords[..., perm], box[:, perm]
    for got, want in (
            (tl.GlobalClassifier(membrane, heads, 0),
             jl.make_global_classifier(membrane, heads, 0)),
            (tl.LocalClassifier(membrane, heads, 0, 2.0),
             jl.make_local_classifier(membrane, heads, 0, 2.0)),
            (tl.IndividualClassifier(heads, methyls, mm, len(heads), 0),
             jl.make_individual_classifier(heads, methyls, mm, len(heads),
                                           0))):
        np.testing.assert_array_equal(got(_t(cx), _t(bx)).numpy(),
                                      np.asarray(want(cx, bx)))


# ------------------------------------------------------------------ steps

def _classes(seed, B, M):
    """Classes in {0, 1, 2}: 2 is in neither leaflet (total only)."""
    return np.random.default_rng(seed).integers(0, 3, (B, M)).astype(
        np.int32)


@pytest.mark.parametrize("handle_pbc", [True, False])
@pytest.mark.parametrize("kind", ["resid", "i16", "f32"])
def test_order_step_with_leaflets_matches_xla(monkeypatch, kind,
                                              handle_pbc):
    from .test_torch_order import _problem

    monkeypatch.setenv("GORDER_TPU_PALLAS", "0")
    pb = _problem(seed=11)
    B, N, M = len(pb["box"]), len(pb["atom_a"]), 9
    bond_mol = np.random.default_rng(12).integers(0, M, N).astype(np.int32)
    classes = _classes(13, B, M)
    step = jax_make_order_step(pb["atom_a"], pb["atom_b"], pb["btype"],
                               bond_mol, pb["T"], M, handle_pbc=handle_pbc,
                               with_leaflets=True)
    normal = np.array([0, 0, 1], np.float32)
    common = (_t(pb["box"]), _t(normal), _t(pb["mask"]), _t(pb["atom_a"]),
              _t(pb["atom_b"]), _t(pb["btype"]), pb["T"])
    kw = dict(handle_pbc=handle_pbc, classes=_t(classes),
              bond_mol=_t(bond_mol))
    if kind == "resid":
        out, _ = step.impl((pb["r"], pb["base"]), pb["box"], normal,
                           pb["mask"], leaflet_classes=classes,
                           inv_scale=pb["inv"], resid_input=True)
        got = order_step(_t(pb["r"]), *common, _t(pb["inv"]),
                         _t(pb["base"]), **kw)
    elif kind == "i16":
        out, _ = step.impl(pb["q"], pb["box"], normal, pb["mask"],
                           leaflet_classes=classes, inv_scale=pb["inv"])
        got = order_step(_t(pb["q"]), *common, _t(pb["inv"]), **kw)
    else:
        out, _ = step.impl(pb["coords"], pb["box"], normal, pb["mask"],
                           leaflet_classes=classes)
        got = order_step(_t(pb["coords"]), *common, **kw)
    got = got.numpy()
    assert got.dtype == np.int64 and got.shape == (B, 3, 2, pb["T"])
    for k, c in enumerate(CLASSES):
        np.testing.assert_array_equal(got[:, k],
                                      from_reference_rows(out[c]))
    # class 2 counts in total only; masked frames add nothing
    assert (got[:, 1, 1] + got[:, 2, 1] < got[:, 0, 1]).any()
    assert not got[~pb["mask"]].any()


@pytest.mark.parametrize("with_ch1u", [False, True])
@pytest.mark.parametrize("kind", ["f32", "i16"])
def test_ua_step_with_leaflets_matches_jax(monkeypatch, kind, with_ch1u):
    from .test_torch_ua import _inputs, _no_ch1u

    monkeypatch.setenv("GORDER_TPU_PALLAS", "0")
    coords, box, mask, cats, btype, bmol, T, _ = _ua_problem(17, B=12,
                                                             n_mols=30)
    if not with_ch1u:
        keep_cats, btype = _no_ch1u(cats, btype)
        n = {c: len(cats[c]["target"]) * ua.N_HYDROGENS[c] for c in cats}
        bmol = np.concatenate([
            bmol[sum(n[p] for p in ua.CATEGORIES[:i] if p in cats):][:n[c]]
            for i, c in enumerate(ua.CATEGORIES)
            if c in cats and c != "ch1u"])
        cats = keep_cats
    classes = _classes(19, len(box), 30)
    coords, inv = _inputs(kind, coords)
    step = ua.make_ua_step(cats, btype, bmol, T, device="cpu",
                           with_leaflets=True)
    normal = np.array([0, 0, 1], np.float32)
    got = step.positions(_t(coords), _t(box), _t(normal), _t(mask),
                         inv_scale=None if inv is None else _t(inv),
                         classes=_t(classes)).numpy()
    jstep = jua.make_ua_step(cats, btype, bmol, T, with_leaflets=True)
    op_by_op, _ = jstep.impl(coords, box, normal, mask,
                             leaflet_classes=classes, inv_scale=inv)
    jitted, _ = jstep(coords, box, normal, mask, leaflet_classes=classes,
                      inv_scale=inv)
    for k, c in enumerate(CLASSES):
        counts = got[:, k, 1]
        for want in (from_reference_rows(op_by_op[c]),
                     from_reference_rows(jitted[c])):
            np.testing.assert_array_equal(counts, want[:, 1])
            assert (np.abs(got[:, k, 0] - want[:, 0]) <= counts).all()
        if not with_ch1u:
            np.testing.assert_array_equal(
                got[:, k], from_reference_rows(op_by_op[c]))
    assert (got[:, 1, 1] + got[:, 2, 1] < got[:, 0, 1]).any()


def test_ua_plain_reads_bond_mol_and_kernel_mol_alike():
    """The kernel reads each carbon's molecule (`mol`), the plain version
    each sample's (`bond_mol`): the compiled UA topology and the test
    problems carry the same molecules in both."""
    _, _, _, cats, _, bmol, _, _ = _ua_problem(0, n_mols=5)
    per_carbon = np.concatenate([
        np.repeat(cats[c]["mol"], ua.N_HYDROGENS[c]) for c in ua.CATEGORIES])
    np.testing.assert_array_equal(per_carbon, bmol)


# --------------------------------------------------------- the whole slice

AA_LIPIDS = 8
AA_FRAMES = 600          # two batches of 512, the second one padded


@pytest.fixture(scope="module")
def aa_files(tmp_path_factory):
    """A small cut of bench.py's AA membrane (same template and seeds)."""
    d = str(tmp_path_factory.mktemp("aa"))
    gro, bnd, system = chip_smoke.synthesize_structure(
        d, n_lipids=AA_LIPIDS, total_atoms=AA_LIPIDS * 134 + 60)
    return gro, bnd, chip_smoke.synthesize_trajectory(d, system, AA_FRAMES)


@pytest.fixture(scope="module")
def ua_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ua"))
    return chip_smoke.synthesize_ua(d, 600, n_lipids=6,
                                    total_atoms=6 * 51 + 90)


@pytest.fixture(scope="module")
def cg_files(tmp_path_factory):
    return make_flat_bilayer(tmp_path_factory.mktemp("cg"), n_frames=40)


@pytest.fixture
def plans(monkeypatch):
    """The wire plan of every port run."""
    seen = []
    real = batches.plan_wire

    def spy(**kw):
        plan = real(**kw)
        seen.append(plan)
        return plan

    monkeypatch.setattr(batches, "plan_wire", spy)
    return seen


def _kind(plan):
    """The wire kind the run's batches ride."""
    if plan.wire == "b7":
        if plan.ch_heads is not None:
            return "b7g"
        if plan.aux_wire_slots is not None:
            return "b7x"
        if plan.plane_active:
            return "b7m sparse" if plan.plane_sparse else "b7m"
        return "b7"
    return plan.wire + ("g" if plan.chan_coords is not None else "")


def _lines(path):
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines() if not ln.startswith("#")]


def _compare(analysis, tmp_path, plans, **kw):
    """Run `analysis` (gorder_tpu's Analysis) on both and compare; →
    the port's wire kind."""
    collect = analysis.leaflets.collect
    for who in ("jax", "port"):
        analysis.output_yaml = str(tmp_path / f"{who}.yaml")
        if collect.enabled:
            analysis.leaflets.with_collect(
                str(tmp_path / f"{who}_leaflets.yaml"))
        if who == "jax":
            analysis.run().write()
        else:
            run_analysis(analysis, "cpu", **{"batch_size": CARD_BATCH,
                                             **kw}).write()
    want = _lines(tmp_path / "jax.yaml")
    assert _lines(tmp_path / "port.yaml") == want
    assert any("upper" in ln for ln in want)
    if collect.enabled:
        exported = _lines(tmp_path / "port_leaflets.yaml")
        assert exported == _lines(tmp_path / "jax_leaflets.yaml")
        assert len(exported) > 1
    return _kind(plans[-1])


def _aa(files, leaflets, **kw):
    gro, bnd, xtc = files
    return JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                       analysis_type=JaxAnalysisType.aaorder(
                           chip_smoke.HEAVY, chip_smoke.HYDROGENS),
                       leaflets=leaflets, silent=True, overwrite=True, **kw)


def _global():
    return LeafletClassification.global_("resname POPC", P_HEADS)


def _upper_lower_row(n):
    """The synthetic membranes put even molecules in the upper leaflet
    (manual value 1 = upper, 0 = lower)."""
    return [1 - (m % 2) for m in range(n)]


def _ndx(path, system_heads):
    """One NDX file with groups Upper and Lower of the heads (1-based)."""
    upper = [h + 1 for m, h in enumerate(system_heads) if m % 2 == 0]
    lower = [h + 1 for m, h in enumerate(system_heads) if m % 2 == 1]
    with open(path, "w") as fh:
        fh.write("[ Upper ]\n" + " ".join(map(str, upper)) + "\n")
        fh.write("[ Lower ]\n" + " ".join(map(str, lower)) + "\n")
    return str(path)


AA_CASES = {
    "global": (lambda f, t: _global(), "b7g"),
    "global_flip": (lambda f, t: _global().with_flip(True), "b7g"),
    "global_export": (lambda f, t: _global().with_collect(True), "b7g"),
    "global_every2": (lambda f, t: _global().with_frequency(
        Frequency.every(2)), "b7m sparse"),
    "global_once": (lambda f, t: _global().with_frequency(Frequency.once()),
                    "b7m sparse"),
    "local": (lambda f, t: LeafletClassification.local(
        "resname POPC", P_HEADS, 2.5), "s6"),
    "individual": (lambda f, t: LeafletClassification.individual(
        P_HEADS, "resname POPC and name C217 C317"), "b7x"),
    "from_map": (lambda f, t: LeafletClassification.from_map(
        {"POPC": [_upper_lower_row(AA_LIPIDS)] * AA_FRAMES}), "b7m"),
    "from_ndx": (lambda f, t: LeafletClassification.from_ndx(
        [_ndx(t / "leaflets.ndx", np.arange(AA_LIPIDS) * 118 + 6)],
        P_HEADS, "Upper", "Lower").with_frequency(Frequency.once()), "b7m"),
}


@pytest.mark.parametrize("case", sorted(AA_CASES))
def test_aa_leaflets_match_jax(aa_files, tmp_path, plans, case):
    make, kind = AA_CASES[case]
    assert _compare(_aa(aa_files, make(aa_files, tmp_path)), tmp_path,
                    plans) == kind


def test_aa_every_n_longer_than_a_batch(aa_files, tmp_path, plans):
    """`every 100` with batches of 64: most batches hold no assignment
    frame, ship no coordinates and inherit the carried classes; errors
    use the per-class per-frame series."""
    from gorder_tpu.input import EstimateError

    a = _aa(aa_files, _global().with_frequency(Frequency.every(100))
            .with_collect(True), estimate_error=EstimateError(n_blocks=4))
    assert _compare(a, tmp_path, plans, batch_size=64) == "b7m sparse"


def _exported(path):
    """The exported leaflet file as (frames, M) internal classes (the file
    writes 1 = upper; internally 0 = upper)."""
    import yaml

    with open(path) as fh:
        return 1 - np.asarray(yaml.safe_load(fh)["POPC"], np.int32)


def test_on_batch_hands_out_what_each_step_used(aa_files, tmp_path):
    """`run_analysis(..., on_batch=...)` receives every batch once, in
    order, on the run's device, with the classes its step used: those the
    export writes."""
    a = _aa(aa_files, _global().with_collect(str(tmp_path / "l.yaml")))
    a.output_yaml = str(tmp_path / "o.yaml")
    seen = []
    run_analysis(a, "cpu", CARD_BATCH, on_batch=seen.append).write()
    assert [db.index for db in seen] == [0, 1]
    assert {db.kind for db in seen} == {"b7g"}
    assert [int(db.mask.sum()) for db in seen] == [512, AA_FRAMES - 512]
    for db in seen:
        assert db.classes.shape == (512, AA_LIPIDS)
        assert db.box.device.type == db.wire[0].device.type == "cpu"
    used = np.concatenate([db.classes[db.mask].numpy() for db in seen])
    np.testing.assert_array_equal(used, _exported(tmp_path / "l.yaml"))


def _tie_trajectory(gro, path, n_frames=64, seed=5):
    """XTC frames of the structure in `gro`, jittered by up to 12 XTC
    integers, where every third (frame, molecule) pair puts one of the
    molecule's two methyls exactly half the 11 nm box from its head along
    z: a min-image tie. → (heads, methyls, methyl_mol, n_atoms)."""
    from gorder_tpu_torch.io import native
    from gorder_tpu_torch.io.gro import read_gro

    system = read_gro(gro)
    heads = np.nonzero(system.atom_names == "P")[0]
    methyls = np.nonzero(np.isin(system.atom_names, ["C217", "C317"]))[0]
    rng = np.random.default_rng(seed)
    period = np.array([13000, 13000, 11000])
    base = np.round(system.positions * 1000).astype(np.int64)
    coords = np.empty((n_frames, system.n_atoms, 3), np.float32)
    for f in range(n_frames):
        q = base + rng.integers(-12, 13, base.shape)
        for m in range(len(heads)):
            if (f + m) % 3 == 0:
                sign = 1 if (f // 2) % 2 else -1
                q[methyls[2 * m + f % 2], 2] = \
                    (q[heads[m], 2] - sign * 5500) % 11000
        coords[f] = (q % period) / 1000.0
    boxes = np.tile(np.diag(period / 1000.0), (n_frames, 1, 1))
    native.xtc_write(path, coords, boxes.astype(np.float32),
                     np.arange(n_frames, dtype=np.float32),
                     np.arange(n_frames, dtype=np.int32), precision=1000.0)
    return (heads, methyls, np.repeat(np.arange(len(heads)), 2),
            system.n_atoms)


def test_individual_leaflets_at_min_image_ties(aa_files, tmp_path, plans):
    """Where a head and a methyl are exactly half the box apart along the
    normal, the sign of the wrapped distance rests on the last bit of the
    f32 difference. The port's individual classes (b7x) equal those of
    `gorder_tpu`'s standalone classifier on every frame. The JAX engine,
    whose per-batch XLA:CPU program fuses the classifier, breaks some of
    these ties the other way, and differs nowhere else: the source of the
    print-quantum differences of `aa-individual-leaflets` against its
    golden, which the JAX engine wrote."""
    from gorder_tpu_torch.io.traj import Trajectory

    gro, bnd, _ = aa_files
    xtc = str(tmp_path / "ties.xtc")
    heads, methyls, mm, n_atoms = _tie_trajectory(gro, xtc)
    n_mols = len(heads)
    classes = {}
    for who in ("jax", "port"):
        a = _aa((gro, bnd, xtc), LeafletClassification.individual(
            P_HEADS, "resname POPC and name C217 C317").with_collect(
                str(tmp_path / f"{who}_leaflets.yaml")))
        a.output_yaml = str(tmp_path / f"{who}.yaml")
        if who == "jax":
            a.run().write()
        else:
            run_analysis(a, "cpu").write()
        classes[who] = _exported(tmp_path / f"{who}_leaflets.yaml")
    assert _kind(plans[-1]) == "b7x"
    q, inv, boxes, _, _ = Trajectory(xtc).read_frames_quantized(
        np.arange(64), n_atoms)
    standalone = np.asarray(jl.make_individual_classifier(
        heads, methyls, mm, n_mols, 2)(
            q.astype(np.float32) * inv[:, None, None],
            np.ascontiguousarray(boxes[:, [0, 1, 2], [0, 1, 2]])))
    dz = q[:, heads[mm], 2].astype(np.int64) - q[:, methyls, 2]
    tie = (np.abs(dz) == 5500).reshape(64, n_mols, 2).any(-1)
    assert tie.sum() > 100
    np.testing.assert_array_equal(classes["port"], standalone)
    engine_off = classes["jax"] != standalone
    assert engine_off.any() and not (engine_off & ~tie).any()


def test_cg_global_leaflets_match_jax(cg_files, tmp_path, plans):
    gro, bnd, xtc = cg_files
    a = JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                    analysis_type=JaxAnalysisType.cgorder("resname POPC"),
                    leaflets=LeafletClassification.global_(
                        "resname POPC", "resname POPC and name PO4"),
                    silent=True, overwrite=True)
    assert _compare(a, tmp_path, plans) == "b7g"


def test_cg_global_leaflets_on_a_gro_trajectory(cg_files, tmp_path, plans):
    """Non-XTC input: the f32 wire, the membrane center computed on the
    device (circular mean of the membrane, not the decoder's COG)."""
    from gorder_tpu_torch.io.gro import read_gro, write_gro
    from gorder_tpu_torch.io.traj import Trajectory

    gro, bnd, xtc = cg_files
    system = read_gro(gro)
    coords, boxes, _, _ = Trajectory([xtc]).read_frames(
        np.arange(12), system.n_atoms)
    traj = tmp_path / "frames.gro"
    with open(traj, "w") as out:
        for c, b in zip(coords, boxes):
            write_gro(str(tmp_path / "one.gro"), system, positions=c, box=b)
            out.write((tmp_path / "one.gro").read_text())
    a = JaxAnalysis(structure=gro, bonds=bnd, trajectory=str(traj),
                    analysis_type=JaxAnalysisType.cgorder("resname POPC"),
                    leaflets=LeafletClassification.global_(
                        "resname POPC", "resname POPC and name PO4"),
                    silent=True, overwrite=True)
    assert _compare(a, tmp_path, plans) == "f32"


def _ua(files, leaflets):
    port = chip_smoke.ua_analysis("ua", *files)
    at = port.analysis_type
    return JaxAnalysis(
        structure=port.structure, bonds=port.bonds,
        trajectory=port.trajectory,
        analysis_type=JaxAnalysisType.uaorder(
            saturated=at.saturated, unsaturated=at.unsaturated),
        leaflets=leaflets, silent=True, overwrite=True)


@pytest.mark.parametrize("case", ["global", "every2", "from_map"])
def test_ua_leaflets_match_jax(ua_files, tmp_path, plans, case):
    """Global rides s6 with the decoder's COG (s6g); frequency-gated
    classification of the s6 coordinates and a manual table ship host
    classes with the s6 wire."""
    if case == "global":
        lf, kind = LeafletClassification.global_("resname POPC",
                                                 P_HEADS), "s6g"
    elif case == "every2":
        lf, kind = LeafletClassification.global_(
            "resname POPC", P_HEADS).with_frequency(Frequency.every(2)), \
            "s6"
    else:
        lf, kind = LeafletClassification.from_map(
            {"POPC": [_upper_lower_row(6)] * 600}), "s6"
    assert _compare(_ua(ua_files, lf), tmp_path, plans) == kind


def test_manual_table_must_cover_the_run(aa_files, tmp_path):
    from gorder_tpu_torch.errors import ManualLeafletError

    a = _aa(aa_files, LeafletClassification.from_map(
        {"POPC": [_upper_lower_row(AA_LIPIDS)] * 7}))
    a.output_yaml = str(tmp_path / "x.yaml")
    with pytest.raises(ManualLeafletError, match="'7'"):
        run_analysis(a, "cpu")
    assert not os.path.exists(tmp_path / "x.yaml")
