"""The s6, d8 and i12 wires of the port (gorder_tpu_torch/engine/wire.py,
engine/channels.py, engine/batches.py, engine/fused.py) and the int32
positions variants of the P2 and UA steps they feed, against `gorder_tpu`
on the same inputs, on the CPU.

- Decoders: `s6_ints`, `d8_ints` and `unpack12` equal `_s6_ints_impl`,
  `_d8_ints_impl` and `_unpack12_impl` integer for integer, on wires the
  native codec encoded from a synthetic XTC whose integers overflow int16
  (a 40 nm box at precision 1000), with an s6 escape gap of 32,768 or
  more, a padded d8 batch, and an i12 file at precision 100.
- The entries: each wire of `wire.WIRES` ships, in one padded batch,
  the bytes a frame it counts for the pick, and its positions on the
  device are the int16 decode's.
- The pick: `pick_wire_format` equals `_pick_wire_format(...,
  link_mbps=None)` wire for wire and cap for cap, with and without bond
  slots, on a small box, the 36 nm vesicle and the precision-100 file,
  for every value of GORDER_TPU_WIRE.
- The int32 steps: the plain P2 step on int32 positions (single rounding
  and pair difference, with classes, normals, a geometry bitplane and a
  map) equals `gorder_tpu`'s XLA step op by op and its Pallas kernel in
  interpret mode within a quantum a sample; the UA step likewise.
- End to end: YAMLs equal under every forced wire and `g`/`G` kind, the
  s6 → int16 fallback mid-run, and d8 in shards merged byte for byte;
  the 36 nm vesicle through `compat`, every view equal to `gorder_tpu`'s
  op by op (tests/test_torch_pyapi.py).
"""

import logging
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorder_tpu.core import geometry as jgeom
from gorder_tpu.core import ordermap as jom
from gorder_tpu.core import ua as jua
from gorder_tpu.core.order import make_order_step as jax_make_order_step
from gorder_tpu.engine import wire as jwire
from gorder_tpu.input import Analysis as JaxAnalysis
from gorder_tpu.input import AnalysisType as JaxAnalysisType
from gorder_tpu.input.config import (Geometry, LeafletClassification,
                                     OrderMapParams)
from gorder_tpu.io.traj import AtomSubset as JaxSubset
from gorder_tpu.io.traj import Trajectory as JaxTrajectory
from gorder_tpu_torch.core import geometry, ua
from gorder_tpu_torch.core import ordermap as om
from gorder_tpu_torch.core.order import from_reference_rows
from gorder_tpu_torch.engine import wire
from gorder_tpu_torch.engine.drivers import run_analysis
from gorder_tpu_torch.engine.fused import decode_positions
from gorder_tpu_torch.io import native
from gorder_tpu_torch.io.traj import AtomSubset, Trajectory
from gorder_tpu_torch.ops import p2
from gorder_tpu_torch.ops import ua as ua_ops

from . import synthetic
from .test_pallas_ua import _ua_problem
from .test_torch_leaflets import _lines, plans  # noqa: F401
from .test_torch_ua import _no_ch1u

t = torch.as_tensor

#: the wide box: 12,000 atoms in residues of 4 in a 40 nm box, 20 frames
N_ATOMS = 12_000
N_FRAMES = 20
PAD = 12              # padding rows of the last batch
WIDE_BOX = 40.0
#: the s6 wire keeps each residue's position a frame as int16 medians, so
#: it fits boxes below 32.767 nm only (a wider one rides d8): its decoder
#: is held on the same residues in a 30 nm box
S6_BOX = 30.0
#: the atom that jumps 0.3 nm against its residue every other frame: an
#: s6 escape and a d8 correction past value index 32,767
JUMPER = 11_500


def _write(path, frames, box, precision):
    n = len(frames)
    native.xtc_write(str(path), np.asarray(frames, np.float32),
                     np.tile(np.diag([box] * 3).astype(np.float32), (n, 1, 1)),
                     np.arange(n, dtype=np.float32) * 10.0,
                     np.arange(n, dtype=np.int32) * 100, precision=precision)
    return str(path)


def _residues(path, box):
    """(xtc, resids): rigid residues of 4 drifting and jittering in a
    cubic box (none crosses its edge), one atom jumping."""
    rng = np.random.default_rng(41)
    centers = rng.uniform(1.0, box - 1.0, (N_ATOMS // 4, 3))
    shape = rng.normal(0, 0.15, (N_ATOMS // 4, 4, 3))
    frames = []
    for f in range(N_FRAMES):
        drift = rng.normal(0, 0.02, (N_ATOMS // 4, 1, 3)) + 0.01 * f
        x = (centers[:, None] + shape + drift).reshape(N_ATOMS, 3)
        x += rng.normal(0, 0.003, x.shape)
        if f % 2:
            x[JUMPER] += 0.3
        frames.append(x % box)
    return (_write(path, frames, box, 1000.0),
            np.repeat(np.arange(1, N_ATOMS // 4 + 1), 4))


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """Residues whose integers overflow int16 (a 40 nm box)."""
    return _residues(tmp_path_factory.mktemp("wide") / "wide.xtc", WIDE_BOX)


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """The same residues in a 30 nm box, where s6 fits."""
    return _residues(tmp_path_factory.mktemp("dense") / "dense.xtc", S6_BOX)


@pytest.fixture(scope="module")
def coarse(tmp_path_factory):
    """An XTC at precision 100 (Martini's compressed-x-precision) in a
    9 nm box: its integers fit 12 bits."""
    rng = np.random.default_rng(43)
    base = rng.uniform(0.5, 8.5, (300, 3))
    frames = [(base + rng.normal(0, 0.05, base.shape)) % 9.0
              for _ in range(12)]
    d = tmp_path_factory.mktemp("coarse")
    return (_write(d / "coarse.xtc", frames, 9.0, 100.0),
            np.repeat(np.arange(1, 101), 3))


def _space(n):
    return AtomSubset.prefix(n), JaxSubset.prefix(n)


def test_wide_box_overflows_int16(wide):
    xtc, _ = wide
    traj = Trajectory(xtc)
    idx = traj.select_frames(None, None, 1)
    assert traj.read_frames_quantized(idx, N_ATOMS) is None
    assert traj.read_frames_packed12(idx, N_ATOMS) is None


def test_wire_groups_match_jax(wide):
    xtc, resids = wide
    system = SimpleNamespace(resids=resids)
    for sel in (None, np.arange(0, N_ATOMS, 3, dtype=np.int64)):
        if sel is None:
            space, jspace = _space(N_ATOMS)
        else:
            space = AtomSubset.from_indices(sel)
            jspace = JaxSubset.from_indices(sel)
        for got, want in zip(wire.wire_groups(system, space),
                             jwire._wire_groups(system, jspace)):
            np.testing.assert_array_equal(got, want)


def _s6_payload(xtc, resids, rows):
    traj = Trajectory(xtc)
    idx = traj.select_frames(None, None, 1)
    space, _ = _space(N_ATOMS)
    group_of, n_groups, vgidx = wire.wire_groups(
        SimpleNamespace(resids=resids), space)
    cap = 1024
    pk = np.zeros((rows, native.s6_stride(N_ATOMS)), np.uint8)
    eg = np.zeros((rows, cap), np.uint16)
    ev = np.zeros((rows, cap), np.int16)
    gm = np.zeros((rows, (n_groups + 1) * 3), np.int16)
    res, nesc = traj.read_frames_s6(idx, space, group_of, n_groups, pk, eg,
                                    ev, gm)
    assert res is not None, f"escape demand {nesc} over {cap}"
    return pk, eg, ev, res[0], gm, vgidx, res[1]


def _f32_frames(xtc):
    traj = Trajectory(xtc)
    coords, _, _, _ = traj.read_frames(traj.select_frames(None, None, 1),
                                       N_ATOMS)
    return coords


def test_s6_decoder_matches_jax(dense):
    """A gap of 32,768 or more, and padding rows."""
    xtc, resids = dense
    pk, eg, ev, base, gm, vgidx, inv = _s6_payload(xtc, resids,
                                                   N_FRAMES + PAD)
    assert (eg.astype(np.int64) >= 32768).any(), "no gap of 32,768 or more"
    got = wire.s6_ints(t(pk), t(eg.view(np.int16)), t(ev), t(base), t(gm),
                       t(vgidx)).numpy()
    want = np.asarray(jwire._s6_ints_impl(pk, eg, ev, base, gm, vgidx))
    assert got.dtype == np.int32 and got.shape == (N_FRAMES + PAD, N_ATOMS,
                                                   3)
    np.testing.assert_array_equal(got, want)
    # the integers are the XTC's, the int16 decode's
    q16, inv16, _, _, _ = Trajectory(xtc).read_frames_quantized(
        np.arange(N_FRAMES), N_ATOMS)
    np.testing.assert_array_equal(got[:N_FRAMES], q16)
    np.testing.assert_array_equal(inv, inv16)


def _d8_payload(xtc, rows):
    traj = Trajectory(xtc)
    idx = traj.select_frames(None, None, 1)
    space, _ = _space(N_ATOMS)
    cap = 256
    lo = np.zeros((rows, N_ATOMS, 3), np.int8)
    ci = np.zeros((rows, cap), np.int32)
    ch = np.zeros((rows, cap), np.int16)
    # padding rows as the batch loop leaves them: no delta, no correction
    ci[N_FRAMES:] = N_ATOMS * 3
    res, ncorr = traj.read_frames_delta8(idx, space, lo, ci, ch)
    assert res is not None, f"correction demand {ncorr} over {cap}"
    return lo, ci, ch, res[0], res[1]


def test_d8_decoder_matches_jax(wide):
    """A padded batch: the padding rows repeat the last frame."""
    xtc, _ = wide
    lo, ci, ch, abs0, inv = _d8_payload(xtc, N_FRAMES + PAD)
    assert (ci[:N_FRAMES] < N_ATOMS * 3).any(), "no correction exercised"
    got = wire.d8_ints(t(lo), t(ci), t(ch), t(abs0)).numpy()
    want = np.asarray(jwire._d8_ints_impl(lo, ci, ch, abs0))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    deq = got[:N_FRAMES].astype(np.float32) * inv[:, None, None]
    np.testing.assert_array_equal(deq, _f32_frames(xtc))
    np.testing.assert_array_equal(got[N_FRAMES:],
                                  np.broadcast_to(got[N_FRAMES - 1],
                                                  got[N_FRAMES:].shape))


def test_s6_and_d8_give_the_same_integers(dense):
    xtc, resids = dense
    pk, eg, ev, base, gm, vgidx, _ = _s6_payload(xtc, resids, N_FRAMES)
    s6 = wire.s6_ints(t(pk), t(eg.view(np.int16)), t(ev), t(base), t(gm),
                      t(vgidx))
    lo, ci, ch, abs0, _ = _d8_payload(xtc, N_FRAMES)
    assert torch.equal(s6, wire.d8_ints(t(lo), t(ci), t(ch), t(abs0)))


def test_s6_does_not_fit_the_wide_box(wide):
    """Its int16 residue medians overflow past 32.767 nm: such a box rides
    d8 (gorder_tpu picks the same, test_pick_matches_jax)."""
    xtc, resids = wide
    traj = Trajectory(xtc)
    space, _ = _space(N_ATOMS)
    group_of, n_groups, _ = wire.wire_groups(SimpleNamespace(resids=resids),
                                             space)
    src = wire.Source(traj, space, 1, 512, group_of, n_groups)
    assert wire.WIRES["s6"].probe(src, traj.select_frames(None, None,
                                                          1)) is None


def test_unpack12_matches_jax(coarse):
    xtc, _ = coarse
    traj = Trajectory(xtc)
    idx = traj.select_frames(None, None, 1)
    packed, inv, _, _, _ = traj.read_frames_packed12(idx, 300)
    got = wire.unpack12(t(packed), 300).numpy()
    want = np.asarray(jwire._unpack12_impl(jnp.asarray(packed), 300))
    assert got.dtype == np.int16 and got.shape == (len(idx), 300, 3)
    np.testing.assert_array_equal(got, want)
    q16, inv16, _, _, _ = traj.read_frames_quantized(idx, 300)
    np.testing.assert_array_equal(got, q16)
    np.testing.assert_array_equal(inv, inv16)
    assert got.max() > 255       # values across the byte boundaries


def test_decode_positions_of_each_kind(dense):
    """The batch loop's reconstruction of a coordinate kind, with a
    trailing COG or bitplane, is the decoder's."""
    xtc, resids = dense
    pk, eg, ev, base, gm, vgidx, _ = _s6_payload(xtc, resids, N_FRAMES)
    w = (t(pk), t(eg.view(np.int16)), t(ev), t(base), t(gm), t(vgidx))
    want = wire.s6_ints(*w)
    for kind, extra in (("s6", ()), ("s6g", (t(np.zeros(N_FRAMES)),)),
                        ("s6G", (t(np.zeros((N_FRAMES, 2), np.uint8)),))):
        assert torch.equal(decode_positions(kind, w + extra, N_ATOMS), want)
    lo, ci, ch, abs0, _ = _d8_payload(xtc, N_FRAMES)
    assert torch.equal(decode_positions("d8g", (t(lo), t(ci), t(ch),
                                                t(abs0), None), N_ATOMS),
                       want)


ENTRY_BATCH = 16      # 12 frames of the precision-100 file and 4 padding


@pytest.mark.parametrize("name", ["b7", "s6", "d8", "i12", "i16", "f32",
                                  "xtc"])
def test_each_wire_entry_ships_its_bytes_and_positions(coarse, name):
    """Each entry of `wire.WIRES` on one padded batch of a real file: its
    bytes a frame are what its ring slot ships (the frame arrays' rows,
    plus the per-batch base spread over the batch as the pick counts it:
    as in gorder_tpu's pick, not d8's first frame), and its positions on
    the device are the int16 decode's integers (f32: the f32 decode's
    positions; b7: the int16 decode's bond differences)."""
    xtc, resids = coarse
    traj = Trajectory(xtc)
    idx = traj.select_frames(None, None, 1)
    space, _ = _space(300)
    group_of, n_groups, _ = wire.wire_groups(SimpleNamespace(resids=resids),
                                             space)
    bonds = (np.arange(0, 299, 2, dtype=np.int32),
             np.arange(1, 300, 2, dtype=np.int32))
    src = wire.Source(traj, space, 1, ENTRY_BATCH, group_of, n_groups, bonds,
                      traj.xtc_layout(idx)[0])
    entry = wire.WIRES[name]
    cap = entry.probe(src, idx)
    assert cap is not None, name
    arrays, inv, _ = entry.read(src, idx, entry.slot(src, ENTRY_BATCH, cap))
    rows = sum(a.nbytes for j, a in enumerate(arrays) if j != entry.base)
    base = 0 if entry.base is None or entry.chain else arrays[entry.base]\
        .nbytes
    assert rows % ENTRY_BATCH == 0
    assert entry.frame_bytes(src, cap) == (rows + base) // ENTRY_BATCH

    const = entry.constants(src)
    w = entry.attach(tuple(t(a) for a in arrays),
                     None if const is None else t(const),
                     torch.empty(ENTRY_BATCH, dtype=torch.int32)
                     if entry.status else None)
    got = entry.positions(w, 300)[:len(idx)]
    q16, inv16, _, _, _ = traj.read_frames_quantized(idx, space)
    if name == "f32":
        assert inv is None
        assert torch.equal(got, t(traj.read_frames(idx, space)[0]))
        return
    want = (q16[:, bonds[1]].astype(np.int32) - q16[:, bonds[0]]
            if name == "b7" else q16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(inv, inv16)


# --- the pick -------------------------------------------------------------

FORCED = ["", "b7", "s6", "d8", "i12", "i16", "f32"]


@pytest.fixture(scope="module")
def pick_inputs(tmp_path_factory, wide, dense, coarse):
    """{name: (xtc, n atoms, resids, bond slots)}: the CG flat bilayer
    (a small box), the 36 nm vesicle, the precision-100 file and the
    residues in the wide box and in the 30 nm one."""
    from gorder_tpu_torch.io.gro import read_gro

    d = tmp_path_factory.mktemp("pick")
    out = {}
    for name, make in (
            ("flat", lambda p: synthetic.make_flat_bilayer(
                p, n_per_leaflet=200, n_frames=24)),
            ("vesicle", lambda p: synthetic.make_vesicle(
                p, r_outer=16.5, r_inner=12.0, n_frames=24))):
        (d / name).mkdir()
        gro, bnd, xtc = make(d / name)[:3]
        system = read_gro(gro)
        bonds = np.loadtxt(bnd, dtype=np.int32).reshape(-1, 2) - 1
        out[name] = (xtc, system.n_atoms, np.asarray(system.resids),
                     (bonds[:, 0].copy(), bonds[:, 1].copy()))
    for name, (xtc, resids) in (("coarse", coarse), ("wide", wide),
                                ("dense", dense)):
        n = len(resids)
        out[name] = (xtc, n, resids,
                     (np.arange(0, n - 1, 2, dtype=np.int32),
                      np.arange(1, n, 2, dtype=np.int32)))
    return out


@pytest.mark.parametrize("forced", FORCED)
def test_pick_matches_jax(pick_inputs, monkeypatch, forced):
    if forced:
        monkeypatch.setenv("GORDER_TPU_WIRE", forced)
    else:
        monkeypatch.delenv("GORDER_TPU_WIRE", raising=False)
    picks = {}
    for name, (xtc, n, resids, slots) in pick_inputs.items():
        space, jspace = _space(n)
        system = SimpleNamespace(resids=resids)
        group_of, n_groups, _ = wire.wire_groups(system, space)
        traj, jtraj = Trajectory(xtc), JaxTrajectory(xtc)
        idx = traj.select_frames(None, None, 1)
        for bonds in (slots, None):
            got = wire.pick_wire_format(traj, idx, space, 1, group_of,
                                        n_groups, 8, bond_slots=bonds)
            want = jwire._pick_wire_format(jtraj, idx, jspace, 1, group_of,
                                           n_groups, 8, bond_slots=bonds,
                                           link_mbps=None)
            assert got == want, (name, bonds is not None)
            picks[name, bonds is not None] = got[0]
    if forced == "":
        # the defaults the tests above rely on: b7 for bond runs on small
        # boxes, s6 or d8 for the rest, never int16 or f32 on the wide box
        assert picks["flat", True] == "b7"
        assert picks["flat", False] in ("s6", "d8")
        assert picks["vesicle", False] in ("s6", "d8")
        assert picks["wide", False] == "d8"
        assert picks["dense", False] in ("s6", "d8")
    if forced == "i12":
        assert picks["coarse", False] == "i12"
        assert picks["wide", False] == "f32"


# --- the int32 steps --------------------------------------------------------

CLASSES = ("total", "upper", "lower")
#: an ordermap over the wide box (manual spans: 4 x 4 nm tiles)
WIDE_MAP = OrderMapParams(bin_size=(4.0, 4.0), plane="xy")


def _wide_problem(seed, B=10, A=80, N=900, T=5, M=7):
    """Random int32 XTC integers in a 40 nm box, at precision 1000: bonds
    between atoms up to a box apart, so min-image matters."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 40_000, (B, A, 3)).astype(np.int32)
    box = np.full((B, 3), WIDE_BOX, np.float32)
    mask = np.ones(B, bool)
    mask[-2:] = False
    return dict(q=q, inv=np.full(B, 1e-3, np.float32), box=box, mask=mask,
                atom_a=rng.integers(0, A, N).astype(np.int32),
                atom_b=rng.integers(0, A, N).astype(np.int32),
                btype=rng.integers(0, T, N).astype(np.int32),
                bond_mol=rng.integers(0, M, N).astype(np.int32), T=T, M=M,
                classes=rng.integers(0, 2, (B, M)).astype(np.int32),
                normals=rng.normal(0, 1, (B, M, 3)).astype(np.float32),
                plane=rng.random((B, N)) < 0.6)


P2_CASES = {
    "plain": dict(), "classes": dict(classes=True),
    "normals": dict(normals=True),
    "classes_normals_plane": dict(classes=True, normals=True, plane=True),
    "pair_map": dict(pair=True, map=True),
    "pair_map_classes_normals": dict(pair=True, map=True, classes=True,
                                     normals=True),
    # the TPU kernel takes no map with a geometry: XLA only
    "pair_map_plane": dict(pair=True, map=True, plane=True),
}


def _p2_port(pb, o, spec):
    normal = pb["normals"] if o.get("normals") else np.array([0, 0, 1],
                                                             np.float32)
    classes = o.get("classes")
    state = (om.init_map_state(3 if classes else 1, pb["T"], spec, "cpu")
             if o.get("map") else None)
    by_mol = classes or o.get("normals")
    out = p2.p2_positions(
        t(pb["q"]), t(pb["atom_a"]), t(pb["atom_b"]), t(pb["inv"]),
        t(pb["box"]), t(normal), t(pb["mask"]), t(pb["btype"]), pb["T"],
        handle_pbc=True, classes=t(pb["classes"]) if classes else None,
        bond_mol=t(pb["bond_mol"]) if by_mol else None,
        pair=bool(o.get("pair")), map_spec=spec if state is not None
        else None, map_state=state,
        geo=wire.pack_geo_bits(t(pb["plane"])) if o.get("plane") else None)
    out = out.numpy()
    return (out if classes else out[:, None],
            None if state is None else state.numpy())


def _p2_jax(pb, o, jspec, monkeypatch, pallas):
    monkeypatch.setenv("GORDER_TPU_PALLAS", "1" if pallas else "0")
    classes = o.get("classes")
    names = CLASSES if classes else CLASSES[:1]
    normals = o.get("normals")
    step = jax_make_order_step(
        pb["atom_a"], pb["atom_b"], pb["btype"], pb["bond_mol"], pb["T"],
        pb["M"], with_leaflets=bool(classes),
        normal_mode="per_molecule" if normals else "static",
        map_spec=jspec if o.get("map") else None,
        geom_spec=jgeom.GeometrySpec("sphere") if o.get("plane") else None)
    assert step.pallas_active() == pallas
    out, state = step.impl(
        pb["q"], pb["box"], pb["normals"] if normals
        else np.array([0, 0, 1], np.float32), pb["mask"],
        leaflet_classes=pb["classes"] if classes else None,
        inv_scale=pb["inv"],
        map_state=(jom.init_map_state(names, pb["T"], jspec)
                   if o.get("map") else None),
        geom_plane=(pb["plane"].astype(np.float32) if o.get("plane")
                    else None), use_pallas=pallas)
    sums = np.stack([from_reference_rows(np.asarray(out[c])) for c in names],
                    axis=1)
    maps = (np.stack([from_reference_rows(np.asarray(state[c]))
                      for c in names]) if o.get("map") else None)
    return sums, maps


@pytest.mark.parametrize("case", list(P2_CASES))
def test_p2_int32_positions_match_jax(monkeypatch, case):
    """The plain P2 step on int32 positions (what `p2_positions_i32` and
    `_i32_pair` run on the card): op by op against the XLA step, bit for
    bit, maps included; against the Pallas kernel in interpret mode,
    equal counts and |Δsum| ≤ n_samples (its map, from XLA, equal)."""
    o = P2_CASES[case]
    pb = _wide_problem(len(case))
    box = np.diag(pb["box"][0])
    spec = om.build_map_spec(WIDE_MAP, box)
    jspec = jom.build_map_spec(WIDE_MAP, box)
    got, got_map = _p2_port(pb, o, spec)
    want, want_map = _p2_jax(pb, o, jspec, monkeypatch, pallas=False)
    np.testing.assert_array_equal(got, want)
    if o.get("map"):
        np.testing.assert_array_equal(got_map, want_map)
        # the map holds every counted sample: per class, Σ map == Σ sums
        np.testing.assert_array_equal(got_map.sum(-1), got.sum((0, 3)))
    if not (o.get("map") and o.get("plane")):
        kernel, kernel_map = _p2_jax(pb, o, jspec, monkeypatch, pallas=True)
        # the TPU kernel leaves padding frames' rows undefined
        valid, kernel = got[pb["mask"]], kernel[pb["mask"]]
        np.testing.assert_array_equal(valid[:, :, 1], kernel[:, :, 1])
        assert (np.abs(valid[:, :, 0] - kernel[:, :, 0])
                <= kernel[:, :, 1]).all()
        if o.get("map"):
            np.testing.assert_array_equal(got_map, kernel_map)
    assert not got[~pb["mask"]].any() and got[:, 0, 1].sum() > 0


def test_p2_int32_equals_int16_on_small_integers():
    """The same integers as int16 and as int32: the same sums."""
    pb = _wide_problem(5)
    pb["q"] = (pb["q"] % 30_000).astype(np.int32)
    spec = om.build_map_spec(WIDE_MAP, np.diag(pb["box"][0]))
    for o in (P2_CASES["classes_normals_plane"],
              P2_CASES["pair_map_classes_normals"]):
        wide32 = _p2_port(pb, o, spec)
        pb16 = dict(pb, q=pb["q"].astype(np.int16))
        narrow = _p2_port(pb16, o, spec)
        for a, b in zip(wide32, narrow):
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("options", ["static", "classes_normals",
                                     "map_geometry"])
def test_ua_int32_positions_match_jax(monkeypatch, options):
    """The plain UA step on int32 XTC integers past int16's range (what
    `ua_positions_i32` runs on the card) against `_ua_step_impl` op by op
    without CH1u, bit for bit, map included; and against the Pallas kernel
    in interpret mode (static normal, classes and normals: the variants it
    has) within a quantum a sample."""
    coords, box, mask, cats, btype, bmol, T, n_mols = _ua_problem(
        47, B=10, n_mols=24)
    n = {c: len(cats[c]["target"]) * ua.N_HYDROGENS[c] for c in cats}
    keep = np.concatenate([np.full(n[c], c != "ch1u")
                           for c in ua.CATEGORIES if c in cats])
    cats, btype = _no_ch1u(cats, btype)
    bmol = bmol[keep]
    # the system moved 35 nm along x in a 60 nm box
    q = np.round(coords * 1000.0).astype(np.int32)
    q[..., 0] += 35_000
    big = np.array([60.0, box[0, 1], box[0, 2]], np.float32)
    box = np.tile(big, (len(q), 1))
    inv = np.full(len(q), 1e-3, np.float32)
    rng = np.random.default_rng(3)
    leaflets = options == "classes_normals"
    classes = (rng.integers(0, 2, (len(q), n_mols)).astype(np.int32)
               if leaflets else None)
    normal = (rng.normal(0, 1, (len(q), n_mols, 3)).astype(np.float32)
              if leaflets else np.array([0, 0, 1], np.float32))
    mode = "per_molecule" if leaflets else "static"
    spec = jspec = geo = jgeo = ref = None
    if options == "map_geometry":
        params = OrderMapParams(bin_size=(1.0, 1.0), plane="xy")
        spec = om.build_map_spec(params, np.diag(big))
        jspec = jom.build_map_spec(params, np.diag(big))
        geo = geometry.GeometrySpec("cuboid", zdim=(0.0, 2.0))
        jgeo = jgeom.GeometrySpec("cuboid", zdim=(0.0, 2.0))
        ref = np.tile(big * 0.5, (len(q), 1))
    step = ua.make_ua_step(cats, btype, bmol, T, device="cpu",
                           with_leaflets=leaflets, normal_mode=mode,
                           map_spec=spec, geom_spec=geo)
    state = om.init_map_state(1, T, spec, "cpu") if spec else None
    got = step.positions(
        t(q), t(box), t(normal), t(mask), inv_scale=t(inv),
        classes=None if classes is None else t(classes), map_state=state,
        geom_ref=None if ref is None else t(ref)).numpy()
    got = got if leaflets else got[:, None]
    names = CLASSES if leaflets else CLASSES[:1]

    def jax_rows(pallas):
        monkeypatch.setenv("GORDER_TPU_PALLAS", "1" if pallas else "0")
        jstep = jua.make_ua_step(cats, btype, bmol, T,
                                 with_leaflets=leaflets, normal_mode=mode,
                                 map_spec=jspec, geom_spec=jgeo)
        assert jstep.pallas_active() == pallas
        fn = jstep if pallas else jstep.impl
        kw = {}
        if jspec is not None:
            kw = dict(map_state=jom.init_map_state(names, T, jspec),
                      geom_ref=jnp.asarray(ref))
        out, jstate = fn(q, box, normal, mask, leaflet_classes=classes,
                         inv_scale=inv, **kw)
        return (np.stack([from_reference_rows(np.asarray(out[c]))
                          for c in names], axis=1), jstate)

    want, jstate = jax_rows(pallas=False)
    np.testing.assert_array_equal(got, want)
    if state is not None:
        np.testing.assert_array_equal(
            state.numpy()[0],
            from_reference_rows(np.asarray(jstate["total"])))
        assert 0 < got[:, 0, 1].sum() < mask.sum() * len(btype)
    else:
        kernel, _ = jax_rows(pallas=True)
        np.testing.assert_array_equal(got[:, :, 1], kernel[:, :, 1])
        assert (np.abs(got[:, :, 0] - kernel[:, :, 0])
                <= kernel[:, :, 1]).all()
        assert got[:, 0, 1].sum() == mask.sum() * len(btype)


def test_int32_wrappers_run_plain_on_cpu():
    """On CPU tensors the int32 inputs run the plain version and count no
    launch."""
    pb = _wide_problem(9)
    p2.p2_i32_launches = p2.p2_i32_pair_launches = 0
    ua_ops.ua_i32_launches = 0
    _p2_port(pb, P2_CASES["plain"], None)
    _p2_port(pb, dict(pair=True), None)
    assert p2.p2_i32_launches == p2.p2_i32_pair_launches == 0
    assert ua_ops.ua_i32_launches == 0


# --- end to end -------------------------------------------------------------

E2E_FRAMES = 40
E2E_BATCH = 16        # 16, 16 and a padded 8
WIRE_OPTIONS = ("", "g", "G")


def _e2e_analysis(files, option, output):
    gro, bnd, xtc = files
    kw = {}
    if option == "g":
        kw["leaflets"] = LeafletClassification.global_("resname POPC",
                                                       "name PO4")
    elif option == "G":
        kw["geometry"] = Geometry("cylinder", reference=(4.0, 4.0, 4.0),
                                  radius=2.0, span=(-1.0, 1.0),
                                  orientation="z")
    return JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                       analysis_type=JaxAnalysisType.cgorder("resname POPC"),
                       output_yaml=str(output), silent=True, overwrite=True,
                       **kw)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """tests/synthetic.py's flat CG bilayer re-encoded at precision 100,
    so that every wire fits it, and `gorder_tpu`'s YAML for each option:
    alone, with global leaflets (the `g` kinds: the decoder's COG), with
    a geometry alone (the `G` kinds: the decoder's bitplane)."""
    d = tmp_path_factory.mktemp("e2e")
    gro, bnd, xtc = synthetic.make_flat_bilayer(d, n_frames=E2E_FRAMES)
    traj = Trajectory(xtc)
    coords, boxes, times, steps = traj.read_frames(
        traj.select_frames(None, None, 1), traj.files[0].natoms[0])
    coarse_xtc = str(d / "coarse.xtc")
    native.xtc_write(coarse_xtc, coords, boxes, times,
                     steps.astype(np.int32), precision=100.0)
    files = (gro, bnd, coarse_xtc)
    want = {}
    for option in WIRE_OPTIONS:
        a = _e2e_analysis(files, option, d / f"jax{option}.yaml")
        a.run().write()
        want[option] = _lines(a.output_yaml)
    return files, want


@pytest.mark.parametrize("forced", ["b7", "s6", "d8", "i12", "i16", "f32"])
def test_forced_wires_match_jax(e2e, tmp_path, plans, monkeypatch, forced):
    """Every wire, alone and in its `g` and `G` kinds, gives `gorder_tpu`'s
    YAML; every batch rides the kind forced."""
    files, want = e2e
    monkeypatch.setenv("GORDER_TPU_WIRE", forced)
    for option in WIRE_OPTIONS:
        a = _e2e_analysis(files, option, tmp_path / f"port{option}.yaml")
        kinds = set()
        run_analysis(a, "cpu", batch_size=E2E_BATCH,
                     on_batch=lambda db: kinds.add(db.kind)).write()
        assert _lines(a.output_yaml) == want[option], option
        if forced == "b7":
            expect = {"": "b7", "g": "b7g", "G": "b7geo"}[option]
        else:
            expect = forced + option
        assert kinds == {expect}, option
        assert plans[-1].wire == forced


def test_s6_mid_run_fallback_matches_jax(e2e, tmp_path, monkeypatch,
                                         caplog):
    """A batch that stops fitting s6 mid-run rides int16; the output does
    not change (gorder_tpu/engine/batches.py:535-549)."""
    files, want = e2e
    real = Trajectory.read_frames_s6
    calls = []

    def flaky(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 3:              # probe, batch 0, then batch 1
            return None, 0
        return real(self, *args, **kwargs)

    monkeypatch.setenv("GORDER_TPU_WIRE", "s6")
    monkeypatch.setattr(Trajectory, "read_frames_s6", flaky)
    a = _e2e_analysis(files, "g", tmp_path / "port.yaml")
    kinds = []
    with caplog.at_level(logging.WARNING, logger="gorder"):
        run_analysis(a, "cpu", batch_size=E2E_BATCH,
                     on_batch=lambda db: kinds.append(db.kind)).write()
    assert "wire fallback: batch 1 exceeds the s6 format" in caplog.text
    assert kinds == ["s6g", "i16g", "s6g"]
    assert _lines(a.output_yaml) == want["g"]


def test_d8_shards_merge_byte_for_byte(e2e, tmp_path, monkeypatch, caplog):
    """d8 restarts from each batch's first frame: three shards, each one
    padded batch, merge into the single run's YAML byte for byte."""
    from gorder_tpu_torch.input.config import Analysis, AnalysisType

    from .test_torch_sharding import _assert_merge_identical, cg

    monkeypatch.setenv("GORDER_TPU_WIRE", "d8")
    with caplog.at_level(logging.INFO, logger="gorder"):
        _assert_merge_identical(cg(e2e[0], Analysis, AnalysisType),
                                tmp_path, 3, "d8")
    wires = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("wire format")]
    assert len(wires) == 4 and all("wire format: d8" in w for w in wires)


def test_profiled_run_writes_a_trace(e2e, tmp_path, monkeypatch):
    """GORDER_TPU_PROFILE names a directory: the run is traced with
    torch.profiler into a Chrome trace there (the port of
    gorder_tpu/utils/timers.py:75-118), and timed as "total"."""
    import json

    from gorder_tpu_torch.utils.timers import timers

    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("GORDER_TPU_PROFILE", str(trace_dir))
    monkeypatch.setenv("GORDER_TPU_WIRE", "d8")
    a = _e2e_analysis(e2e[0], "", tmp_path / "port.yaml")
    run_analysis(a, "cpu", batch_size=E2E_BATCH).write()
    assert _lines(a.output_yaml) == e2e[1][""]
    assert timers.get("total") > 0
    traces = list(trace_dir.glob("trace-*.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    # the d8 decoder's cumulative sum ran inside the traced run
    assert "aten::cumsum" in names
