"""The xtc wire: each frame's compressed record shipped as it lies in the
file and decoded on the device (`gorder_tpu_torch/ops/xtc.py`,
`csrc/xtc.cu`), against the host codec (native/xdr.cpp).

On the CPU:
- the kernel's division (multiply-high by a reciprocal, one correction)
  equals divmod at the edges of its range;
- the plain stepper equals `native.xtc_decode_i32` integer for integer on
  frames from the native encoder that take runs of every length with
  smallidx moving both ways, water-pair swaps and the bitsize == 0 path,
  at two precisions, stopping at every first_n inside runs and gathering
  a sparse slot map;
- the raw read copies each record byte for byte with the boxes and scales
  of `xtc_decode`, and refuses a plain frame;
- a corrupt record sets the frame's status, and the run raises naming the
  frame when its batch drains; a batch the read refuses rides int16;
- the pick weighs the wire by the modeled rate, never for runs with a
  decoder side channel, TRR input or plain frames, and obeys
  GORDER_TPU_WIRE=xtc, falling back where the run is not eligible;
- whole analyses forced onto the wire write the int16 run's YAML (and map
  files) byte for byte: AA, UA and an AA ordermap.

Neither the plain stepper nor, on the card, the kernel reads a row's
bytes past its record: 0x00 and 0xFF there give the same integers, as the
decode ring's reused rows need (`engine/ring.py`).

On the card (`-m cuda`): the kernel equals the host codec bit for bit on
those frames and on a 512-frame batch of the benchmark's aa-bilayer-256,
where the int32 P2 output equals the int16 one; a corrupt record raises
at drain.
"""

import logging
import os

import numpy as np
import pytest
import torch

import chip_smoke
from gorder_tpu_torch.engine import channels, wire
from gorder_tpu_torch.engine.drivers import run_analysis
from gorder_tpu_torch.errors import AnalysisError
from gorder_tpu_torch.input.config import (Analysis, AnalysisType, Frequency,
                                           Geometry, LeafletClassification,
                                           MembraneNormal, OrderMapParams)
from gorder_tpu_torch.io import native
from gorder_tpu_torch.io.traj import AtomSubset, Trajectory
from gorder_tpu_torch.ops import xtc as xtc_ops

from .synthetic import make_flat_bilayer

P_HEADS = "resname POPC and name P"
AA_LIPIDS = 18           # a 3 x 3 grid a leaflet: every cloud holds 3 heads
UA_LIPIDS = 6
FRAMES = 40
BATCH = 16                # 16, 16 and a padded 8


# --- frames from the native encoder ------------------------------------------

def _runs(rng):
    """Clusters of 1 to 10 atoms, tight (a few integer units apart at
    precision 1000), middling and loose, so that runs of every length
    form and smallidx steps up and down."""
    atoms = []
    for rep in range(4):
        for k in range(1, 11):
            center = rng.uniform(0.5, 9.5, 3)
            spread = (0.002, 0.03, 0.3)[(rep + k) % 3]
            atoms += list(center + rng.normal(0, spread, (k, 3)))
    return np.asarray(atoms)


def _water(rng):
    """Waters: an O and two Hs 0.1 nm from it, the pairs the encoder
    swaps."""
    o = rng.uniform(0.2, 9.8, (60, 1, 3))
    h = o + rng.normal(0, 0.06, (60, 2, 3))
    return np.concatenate([o, h], axis=1).reshape(-1, 3)


def _wide(rng):
    """Atoms spread over 200,000 nm on x, an integer span above 2^24 at
    either precision: the decoder reads each coordinate on its own
    (bitsize == 0), runs included."""
    atoms = _runs(rng)[:120]
    atoms[::7, 0] += rng.uniform(0, 200000, len(atoms[::7]))
    return atoms


CASES = {"runs": _runs, "water": _water, "wide": _wide}


def _write(path, base, rng, precision, n_frames=3):
    frames = (base[None] + rng.normal(0, 0.001, (n_frames,) + base.shape)
              ).astype(np.float32)
    boxes = np.tile(np.diag([10.0, 10.0, 10.0]).astype(np.float32),
                    (n_frames, 1, 1))
    native.xtc_write(str(path), frames, boxes,
                     np.arange(n_frames, dtype=np.float32),
                     np.arange(n_frames, dtype=np.int32),
                     precision=precision)
    return str(path)


@pytest.fixture(scope="module", params=[(c, p) for c in CASES
                                        for p in (1000.0, 100.0)],
                ids=lambda cp: f"{cp[0]}-{int(cp[1])}")
def edge(request, tmp_path_factory):
    """(xtc path, atoms) of one case at one precision."""
    case, precision = request.param
    rng = np.random.default_rng(len(case) + int(precision))
    base = CASES[case](rng)
    path = tmp_path_factory.mktemp("edge") / f"{case}.xtc"
    return _write(path, base, rng, precision), len(base), case


def _rows(path):
    """The xtc wire of every frame of `path`: (traj, raw, lengths)."""
    traj = Trajectory(path)
    idx = traj.select_frames(None, None, 1)
    stride, _ = traj.xtc_layout(idx)
    raw = np.zeros((len(idx), stride), np.uint8)
    lengths = np.zeros(len(idx), np.int32)
    assert traj.read_frames_xtc(idx, raw, lengths) is not None
    return traj, raw, lengths


def _decode(raw, lengths, slot_of, first_n, n_out, device="cpu"):
    """xtc_ints on `device` → ((B, n_out, 3) int32, (B,) status) on the
    CPU."""
    t = [torch.as_tensor(a, device=device) for a in (raw, lengths)]
    slots = (torch.as_tensor(slot_of, device=device)
             if slot_of is not None else None)
    status = torch.full((raw.shape[0],), -1, dtype=torch.int32,
                        device=device)
    out = xtc_ops.xtc_ints(*t, slots, first_n, n_out, status)
    return out.cpu().numpy(), status.cpu().numpy()


def _host(path, traj, first_n, slot_of=None, n_out=None):
    return native.xtc_decode_i32(path, traj.files[0].offsets, first_n,
                                 slot_of=slot_of, n_out=n_out)[0]


def _sparse(n_atoms, rng):
    """A sorted selection of about half the atoms → (slot_of, n_sel),
    slot_of of the selection's first_n atoms."""
    sel = np.sort(rng.choice(n_atoms, n_atoms // 2, replace=False))
    sub = AtomSubset.from_indices(sel)
    return sub.slot_of, sub.first_n, len(sel)


def _check_edge(edge, device="cpu"):
    path, n_atoms, case = edge
    traj, raw, lengths = _rows(path)
    rng = np.random.default_rng(5)
    # every first_n over the first 60 atoms (inside runs of every length),
    # then the whole frame with 12 padding columns
    for first_n in list(range(1, 61)) + [n_atoms]:
        n_out = first_n + 12
        got, status = _decode(raw, lengths, None, first_n, n_out, device)
        assert (status == 0).all()
        np.testing.assert_array_equal(got[:, :first_n],
                                      _host(path, traj, first_n))
        assert not got[:, first_n:].any()
    slot_of, first_n, n_sel = _sparse(n_atoms, rng)
    got, status = _decode(raw, lengths, slot_of, first_n, n_sel + 5, device)
    assert (status == 0).all()
    np.testing.assert_array_equal(
        got, _host(path, traj, first_n, slot_of=slot_of, n_out=n_sel + 5))


def test_division_matches_divmod():
    rng = np.random.default_rng(3)
    top = (1 << 64) - 1
    for d in [1, 2, 3, 8, 10, 1290, 4096, 7501, 9126, 0xFFFFFF, 16777216]:
        values = [0, 1, d - 1, d, d + 1, top, top - 1, top - d,
                  (top // d) * d, (top // d) * d - 1]
        values += [int(v) for v in rng.integers(0, 1 << 62, 50)]
        for v in values:
            assert xtc_ops.divide(v, d) == divmod(v, d), (v, d)


def test_plain_stepper_matches_the_host_codec(edge):
    _check_edge(edge)


def test_the_frames_take_every_rule(edge):
    """What the cases are for: runs of every length and smallidx both ways
    (runs), swapped water pairs, the bitsize == 0 path (wide)."""
    path, n_atoms, case = edge
    _, raw, lengths = _rows(path)
    seen = set()
    for row, length in zip(raw, lengths):
        out = np.zeros((n_atoms, 3), np.int32)
        assert xtc_ops.decode_frame(row.tobytes(), int(length), None,
                                    n_atoms, out, seen) == 0
    runs = {n for (rule, *n) in seen if rule == "run" for n in n}
    if case == "runs":
        assert runs >= set(range(1, 9)), runs
        assert {("smallidx", 1), ("smallidx", -1)} <= seen
    if case == "water":
        assert runs
    assert (("wide",) in seen) == (case == "wide")


def test_padding_rows_are_zero_and_corrupt_records_set_the_status(edge):
    path, n_atoms, _ = edge
    _, raw, lengths = _rows(path)
    lengths[1] = 0                         # padding
    bad = raw.copy()
    # a payload shorter than its stream: a read past the end
    bad[0, 88:92] = np.frombuffer(np.int32(8).byteswap().tobytes(), np.uint8)
    # a smallidx outside the table
    bad[2, 84:88] = np.frombuffer(np.int32(80).byteswap().tobytes(),
                                  np.uint8)
    got, status = _decode(bad, lengths, None, n_atoms, n_atoms)
    assert status.tolist() == [3, 0, 1]
    assert not got[1].any()
    assert xtc_ops.STATUS[3] == "XTC payload overrun"


def _tails(edge, device):
    """The decoder's (integers, statuses) of the edge frames in rows 64
    bytes wider than the layout's, every byte past a record 0x00, then
    0xFF: what a reused ring row holds past a shorter record."""
    path, n_atoms, _ = edge
    _, raw, lengths = _rows(path)
    outs = []
    for fill in (0x00, 0xFF):
        rows = np.full((raw.shape[0], raw.shape[1] + 64), fill, np.uint8)
        for k, n in enumerate(lengths):
            rows[k, :n] = raw[k, :n]
        outs.append(_decode(rows, lengths, None, n_atoms, n_atoms, device))
    return outs


def test_the_plain_decoder_reads_nothing_past_a_record(edge):
    (zeros, s0), (ones, s1) = _tails(edge, "cpu")
    assert (s0 == 0).all() and (s1 == 0).all()
    np.testing.assert_array_equal(zeros, ones)


def test_wrapper_refuses_bad_rows():
    status = torch.zeros(2, dtype=torch.int32)
    lengths = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        xtc_ops.xtc_ints(torch.zeros((2, 100), dtype=torch.uint8), lengths,
                         None, 4, 4, status)
    with pytest.raises(TypeError):
        xtc_ops.xtc_ints(torch.zeros((2, 96), dtype=torch.int32), lengths,
                         None, 4, 4, status)
    out = xtc_ops.xtc_ints(torch.zeros((2, 96), dtype=torch.uint8), lengths,
                           None, 4, 4, status)
    assert out.shape == (2, 4, 3) and not out.any()
    assert xtc_ops.xtc_decode_launches == 0   # the plain version


# --- the raw read ------------------------------------------------------------

def test_raw_read_copies_the_records(edge):
    path, n_atoms, _ = edge
    traj, raw, lengths = _rows(path)
    f = traj.files[0]
    data = open(path, "rb").read()
    assert lengths.tolist() == f.sizes.tolist()
    for k, off in enumerate(f.offsets):
        assert raw[k, :lengths[k]].tobytes() == data[off:off + lengths[k]]
    idx = traj.select_frames(None, None, 1)
    inv, boxes, times, steps = traj.read_frames_xtc(idx, raw, lengths)
    _, want_boxes, want_times, want_steps = native.xtc_decode(
        path, f.offsets, n_atoms)
    np.testing.assert_array_equal(boxes, want_boxes)
    np.testing.assert_array_equal(times, want_times)
    np.testing.assert_array_equal(steps, want_steps)
    _, want_inv, _, _, _ = native.xtc_decode_i32(path, f.offsets, n_atoms)
    np.testing.assert_array_equal(inv, want_inv)
    stride, mean = traj.xtc_layout(idx)
    assert stride % 16 == 0 and stride >= lengths.max()
    assert mean == lengths.mean()


def test_raw_read_refuses_a_plain_frame(tmp_path):
    """A frame of 9 atoms or fewer is stored plain: neither the layout nor
    the read takes it."""
    rng = np.random.default_rng(1)
    path = _write(tmp_path / "t.xtc", _water(rng)[:12], rng, 1000.0)
    small = rng.uniform(0, 5, (1, 5, 3)).astype(np.float32)
    native.xtc_write(path, small, np.eye(3, dtype=np.float32)[None],
                     np.array([9.0], np.float32), np.array([9], np.int32),
                     append=True)
    traj = Trajectory(path, expected_atoms=12)
    idx = traj.select_frames(None, None, 1)
    assert traj.xtc_layout(idx[:3]) is not None
    assert traj.xtc_layout(idx) is None
    raw = np.zeros((4, 512), np.uint8)
    lengths = np.zeros(4, np.int32)
    assert traj.read_frames_xtc(idx[:3], raw, lengths) is not None
    assert traj.read_frames_xtc(idx, raw, lengths) is None


# --- whole analyses ----------------------------------------------------------

@pytest.fixture(scope="module")
def aa_files(tmp_path_factory):
    """A small cut of the AA membrane of `chip_smoke.py` (bench.py's)."""
    d = str(tmp_path_factory.mktemp("aa"))
    gro, bnd, system = chip_smoke.synthesize_structure(
        d, n_lipids=AA_LIPIDS, total_atoms=AA_LIPIDS * 134 + 60)
    return gro, bnd, chip_smoke.synthesize_trajectory(d, system, FRAMES)


@pytest.fixture(scope="module")
def ua_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ua"))
    return chip_smoke.synthesize_ua(d, FRAMES, n_lipids=UA_LIPIDS,
                                    total_atoms=UA_LIPIDS * 51 + 90)


@pytest.fixture(scope="module")
def cg_files(tmp_path_factory):
    return make_flat_bilayer(tmp_path_factory.mktemp("cg"), n_frames=FRAMES)


def _aa(files, out, **kw):
    gro, bnd, xtc = files
    return Analysis(structure=gro, bonds=bnd, trajectory=xtc,
                    analysis_type=AnalysisType.aaorder(chip_smoke.HEAVY,
                                                       chip_smoke.HYDROGENS),
                    output_yaml=str(out), silent=True, overwrite=True, **kw)


def _cg(files, out, **kw):
    gro, bnd, xtc = files
    return Analysis(structure=gro, bonds=bnd, trajectory=xtc,
                    analysis_type=AnalysisType.cgorder("resname POPC"),
                    output_yaml=str(out), silent=True, overwrite=True, **kw)


def _lines(path):
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines() if not ln.startswith("#")]


def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            p = os.path.join(d, name)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _forced(make, tmp_path, monkeypatch, wire_name, device="cpu"):
    """Run `make(output YAML, map directory)` with `wire_name` forced →
    (YAML lines, map files, batch kinds, results)."""
    monkeypatch.setenv("GORDER_TPU_WIRE", wire_name)
    maps = tmp_path / f"maps_{wire_name}"
    a = make(tmp_path / f"{wire_name}.yaml", maps)
    kinds = []
    results = run_analysis(a, device, batch_size=BATCH,
                           on_batch=lambda db: kinds.append(db.kind))
    results.write()
    return (_lines(a.output_yaml), _tree(maps) if maps.exists() else {},
            kinds, results)


RUNS = {
    "aa": lambda f: lambda out, maps: _aa(f["aa"], out),
    "ua": lambda f: lambda out, maps: chip_smoke.ua_analysis(
        "ua", *f["ua"], output_yaml=str(out)),
    "aa-map": lambda f: lambda out, maps: _aa(
        f["aa"], out, map=OrderMapParams.parse(dict(
            bin_size=[0.5, 0.5], output_directory=str(maps)))),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_forced_xtc_writes_the_int16_yaml(name, aa_files, ua_files, tmp_path,
                                          monkeypatch):
    from gorder_tpu_torch.utils.timers import timers

    make = RUNS[name]({"aa": aa_files, "ua": ua_files})
    timers.reset()
    lines, maps, kinds, results = _forced(make, tmp_path, monkeypatch, "xtc")
    decoded = timers.counters()["device_decode_frames"]
    want_lines, want_maps, want_kinds, want = _forced(make, tmp_path,
                                                      monkeypatch, "i16")
    assert kinds == ["xtc"] * 3 and want_kinds == ["i16"] * 3
    assert decoded == FRAMES
    assert lines == want_lines
    assert maps == want_maps and (name != "aa-map" or maps)
    assert results.n_analyzed_frames == want.n_analyzed_frames == FRAMES


def test_a_refused_batch_rides_int16(aa_files, tmp_path, monkeypatch, caplog):
    real = Trajectory.read_frames_xtc
    calls = []

    def flaky(self, *args, **kwargs):
        calls.append(1)
        return None if len(calls) == 2 else real(self, *args, **kwargs)

    monkeypatch.setattr(Trajectory, "read_frames_xtc", flaky)
    with caplog.at_level(logging.WARNING, logger="gorder"):
        lines, _, kinds, _ = _forced(lambda out, maps: _aa(aa_files, out),
                                     tmp_path, monkeypatch, "xtc")
    monkeypatch.setattr(Trajectory, "read_frames_xtc", real)
    assert "wire fallback: batch 1 exceeds the xtc format" in caplog.text
    assert kinds == ["xtc", "i16", "xtc"]
    assert lines == _forced(lambda out, maps: _aa(aa_files, out), tmp_path,
                            monkeypatch, "i16")[0]


def _corrupting(frame):
    """A `read_frames_xtc` that shortens the payload of the batch's row
    `frame`: the card reads past it."""
    real = Trajectory.read_frames_xtc

    def read(self, frame_indices, raw, lengths, n_threads=1):
        res = real(self, frame_indices, raw, lengths, n_threads=n_threads)
        if frame < len(frame_indices):
            raw[frame, 88:92] = np.frombuffer(
                np.int32(8).byteswap().tobytes(), np.uint8)
        return res
    return read


def test_a_corrupt_record_raises_at_drain(aa_files, tmp_path, monkeypatch):
    monkeypatch.setattr(Trajectory, "read_frames_xtc", _corrupting(5))
    with pytest.raises(AnalysisError, match=r"could not decode frame 5 of "
                       r"xtc file .* on the device: XTC payload overrun"):
        _forced(lambda out, maps: _aa(aa_files, out), tmp_path, monkeypatch,
                "xtc")


# --- the pick ----------------------------------------------------------------

FAST = 1e9               # MiB/s: no wire binds


def _space(n):
    return AtomSubset.prefix(n)


def test_rate_pick_takes_xtc_where_it_models_faster(cg_files, monkeypatch):
    """min(host read, link ÷ row stride) against min(int16 decode, link ÷
    int16 bytes): xtc where its host read is the faster and the link does
    not bind it, else the host wires as before. Its rows cross the link
    whole, so the stride, not the mean record, and the row's 4-byte length
    are its bytes a frame."""
    monkeypatch.delenv("GORDER_TPU_WIRE", raising=False)
    traj = Trajectory(cg_files[2])
    idx = traj.select_frames(None, None, 1)
    n = int(traj.files[0].natoms[0])
    space = _space(n)
    stride, mean = traj.xtc_layout(idx)
    assert stride >= mean
    monkeypatch.setattr(wire, "host_i16_rate", lambda *a: 1000.0)
    monkeypatch.setattr(wire, "host_xtc_rate", lambda *a: 5000.0)

    def pick(link, xtc=True):
        return wire.pick_wire_format(traj, idx, space, 1, link_mbps=link,
                                     xtc=xtc)

    assert pick(FAST) == ("xtc", stride)
    assert pick(FAST, xtc=False) == ("i16", 0)
    # the link binds xtc at 2000 frames/s: still above int16's 1000
    assert pick(2000 * stride / 2**20) == ("xtc", stride)
    # links that bind every wire: the model's maximum over all of them
    candidates = wire.rate_candidates(wire.Source(traj, space, 1, 512,
                                                  stride=stride), idx)
    assert candidates["xtc"] == (stride, stride + 4)
    host = {f: 1000.0 * wire._WIRE_HOST_FACTOR.get(f, 0) for f in candidates}
    host["xtc"] = 5000.0
    for f in (500, 50, 5):
        link = f * stride / 2**20
        best = max(candidates, key=lambda w: (min(
            host[w], link * 2**20 / candidates[w][1]), -candidates[w][1]))
        assert pick(link) == (best, candidates[best][0]), f
    # a host read slower than the int16 decode: int16, as before
    monkeypatch.setattr(wire, "host_xtc_rate", lambda *a: 900.0)
    assert pick(FAST) == ("i16", 0)


@pytest.mark.parametrize("card, want", [(None, "xtc"), (5000.0, "xtc"),
                                        (2000.0, "xtc"), (900.0, "i16")])
def test_the_card_decoder_caps_the_xtc_rate(cg_files, monkeypatch, card,
                                            want):
    """The xtc wire's modeled rate is at most the card decoder's: a card
    slower than the int16 decode sends the run back to int16; with no
    card rate (the CPU) the host read alone decides."""
    monkeypatch.delenv("GORDER_TPU_WIRE", raising=False)
    traj = Trajectory(cg_files[2])
    idx = traj.select_frames(None, None, 1)
    space = _space(int(traj.files[0].natoms[0]))
    monkeypatch.setattr(wire, "host_i16_rate", lambda *a: 1000.0)
    monkeypatch.setattr(wire, "host_xtc_rate", lambda *a: 5000.0)
    monkeypatch.setattr(wire, "card_xtc_rate", lambda *a: card)
    got = wire.pick_wire_format(traj, idx, space, 1, link_mbps=FAST,
                                xtc=True, device="cuda")
    assert got[0] == want


def test_the_card_decoder_rate_is_none_off_the_card(cg_files):
    """On the CPU there is no card to time: no cap, nothing cached."""
    traj = Trajectory(cg_files[2])
    idx = traj.select_frames(None, None, 1)
    space = _space(int(traj.files[0].natoms[0]))
    stride, _ = traj.xtc_layout(idx)
    before = dict(wire._CARD_XTC_RATES)
    for device in (None, "cpu", torch.device("cpu")):
        assert wire.card_xtc_rate(traj, idx, stride, space, 1, device,
                                  512) is None
    assert wire._CARD_XTC_RATES == before


def test_the_card_path_measures_the_xtc_read(cg_files, tmp_path,
                                             monkeypatch):
    """With a link rate, the pick times the xtc read twice over up to 64
    frames (`pick.xtc`; here the run's 40) beside the int16 anchor's 16,
    and the wire it logs is the one the batches ride."""
    from gorder_tpu_torch.utils.timers import timers

    monkeypatch.delenv("GORDER_TPU_WIRE", raising=False)
    monkeypatch.setattr(channels.wires, "measure_link_mbps",
                        lambda device: FAST)
    plans = []
    real = channels.plan_wire
    monkeypatch.setattr("gorder_tpu_torch.engine.batches.plan_wire",
                        lambda **kw: plans.append(real(**kw)) or plans[-1])
    a = _cg(cg_files, tmp_path / "o.yaml")
    kinds = set()
    timers.reset()
    run_analysis(a, "cpu", batch_size=BATCH,
                 on_batch=lambda db: kinds.add(db.kind)).write()
    snap = timers.snapshot()
    assert "pick.xtc" in snap and "pick.host_rate" in snap
    assert snap["probe_frames"] == 16 + 2 * FRAMES
    assert kinds == {plans[0].wire} and plans[0].wire in ("i16", "xtc")


def _side_channel_runs(files, maps):
    """Runs in each decoder channel class: b7g, b7m, b7x (individual
    leaflets; dynamic normals), b7geo / G (a geometry alone) and g (a map
    with global leaflets)."""
    glob = LeafletClassification.global_("resname POPC", P_HEADS)
    return {
        "b7g": dict(leaflets=glob),
        "b7m": dict(leaflets=LeafletClassification.global_(
            "resname POPC", P_HEADS).with_frequency(Frequency.every(2))),
        "b7x": dict(leaflets=LeafletClassification.individual(
            P_HEADS, "resname POPC and name C217 C317")),
        "b7x-normals": dict(membrane_normal=MembraneNormal.dynamic(
            P_HEADS, 5.0)),
        "geo": dict(geometry=Geometry("cylinder", reference=(2.0, 2.0, 2.0),
                                      radius=2.0, span=(-3.0, 3.0),
                                      orientation="z")),
        "g": dict(leaflets=glob, map=OrderMapParams.parse(dict(
            bin_size=[0.5, 0.5], output_directory=str(maps)))),
    }


@pytest.mark.parametrize("forced", ["", "xtc"])
def test_side_channel_runs_never_ride_xtc(aa_files, tmp_path, monkeypatch,
                                          caplog, forced):
    """However fast the xtc read models, a run that reads a decoder side
    channel keeps a host wire; forced, it warns and picks one."""
    monkeypatch.setenv("GORDER_TPU_WIRE", forced)
    monkeypatch.setattr(channels.wires, "measure_link_mbps",
                        lambda device: FAST)
    monkeypatch.setattr(wire, "host_i16_rate", lambda *a: 1.0)
    monkeypatch.setattr(wire, "host_xtc_rate", lambda *a: 1e12)
    for name, kw in _side_channel_runs(aa_files, tmp_path / "maps").items():
        a = _aa(aa_files, tmp_path / f"{name}.yaml", **kw)
        kinds = set()
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="gorder"):
            run_analysis(a, "cpu", batch_size=BATCH,
                         on_batch=lambda db: kinds.add(db.kind))
        assert kinds and not any(k.startswith("xtc") for k in kinds), name
        assert ("GORDER_TPU_WIRE=xtc requested" in caplog.text) == bool(
            forced), name
    # the same fast models put a run with no side channel on xtc
    kinds = set()
    run_analysis(_aa(aa_files, tmp_path / "plain.yaml"), "cpu",
                 batch_size=BATCH, on_batch=lambda db: kinds.add(db.kind))
    assert kinds == {"xtc"}


def test_trr_input_never_rides_xtc(aa_files, tmp_path, monkeypatch, caplog):
    traj = Trajectory(aa_files[2])
    idx = traj.select_frames(None, None, 1)
    coords, boxes, times, steps = traj.read_frames(
        idx, int(traj.files[0].natoms[0]))
    trr = str(tmp_path / "t.trr")
    chip_smoke.write_trr(trr, coords, boxes, times, steps)
    trr_traj = Trajectory(trr)
    assert trr_traj.xtc_layout(idx) is None
    assert trr_traj.read_frames_xtc(idx, np.zeros((len(idx), 512), np.uint8),
                                    np.zeros(len(idx), np.int32)) is None
    monkeypatch.setenv("GORDER_TPU_WIRE", "xtc")
    files = (aa_files[0], aa_files[1], trr)
    kinds = set()
    with caplog.at_level(logging.WARNING, logger="gorder"):
        run_analysis(_aa(files, tmp_path / "o.yaml"), "cpu",
                     batch_size=BATCH, on_batch=lambda db: kinds.add(db.kind))
    assert kinds == {"f32"}
    assert "GORDER_TPU_WIRE=xtc requested" in caplog.text


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_the_host_codec_on_edge_frames(card, edge):
    before = xtc_ops.xtc_decode_launches
    _check_edge(edge, card)
    assert xtc_ops.xtc_decode_launches == before + 62


@pytest.mark.cuda
def test_kernel_sets_the_status_of_corrupt_records(card, edge):
    path, n_atoms, _ = edge
    _, raw, lengths = _rows(path)
    lengths[1] = 0
    raw[0, 88:92] = np.frombuffer(np.int32(8).byteswap().tobytes(), np.uint8)
    raw[2, 84:88] = np.frombuffer(np.int32(80).byteswap().tobytes(),
                                  np.uint8)
    got, status = _decode(raw, lengths, None, n_atoms, n_atoms, card)
    assert status.tolist() == [3, 0, 1] and not got[1].any()


@pytest.mark.cuda
def test_the_kernel_reads_nothing_past_a_record(card, edge):
    (zeros, s0), (ones, s1) = _tails(edge, card)
    assert (s0 == 0).all() and (s1 == 0).all()
    np.testing.assert_array_equal(zeros, ones)
    path, n_atoms, _ = edge
    traj, _, _ = _rows(path)
    np.testing.assert_array_equal(zeros, _host(path, traj, n_atoms))


def aa_bilayer_batch(directory, n_frames=512, seed=2718281828):
    """The first `n_frames` frames of the benchmark's aa-bilayer-256 from
    `seed`, written by the benchmark's encoder → (xtc path, System)."""
    import json
    from pathlib import Path

    from benchmark import synth
    from benchmark import xtc as bench_xtc

    cfg = json.loads((Path(synth.HERE) / "configs" / "aa-bilayer-256.json")
                     .read_text())
    device = "cuda" if torch.cuda.is_available() else "cpu"
    system = synth.make_system(cfg, seed, device)
    path = Path(directory) / "aa.xtc"
    for start, ints in synth.trajectory_chunks(system, seed, n_frames):
        boxes, times, steps = synth.frame_meta(cfg, start, ints.shape[0])
        bench_xtc.append_frames(path, ints.cpu().numpy(), boxes, times,
                                steps, cfg["precision"], 8,
                                append=start > 0)
    return str(path), system


@pytest.mark.cuda
def test_kernel_matches_the_host_codec_on_an_aa_bilayer_batch(card,
                                                               tmp_path):
    """512 frames of aa-bilayer-256: the C and H atoms of the lipids, as
    the benchmark's analysis selects them, integer for integer the host
    codec's; and the int32 P2 step on them equals the int16 one."""
    from gorder_tpu_torch.ops import p2

    path, system = aa_bilayer_batch(tmp_path)
    names = np.asarray(system.names)
    lipid = np.asarray(system.resnames) == system.config["resname"]
    names = names.astype(str)
    sel = np.flatnonzero(lipid & (np.char.startswith(names, "C")
                                  | np.char.startswith(names, "H")))
    sub = AtomSubset.from_indices(sel, n_out=(len(sel) + 255) // 256 * 256)
    traj, raw, lengths = _rows(path)
    got, status = _decode(raw, lengths, sub.slot_of, sub.first_n, sub.n_out,
                          card)
    assert (status == 0).all()
    want = _host(path, traj, sub.first_n, sub.slot_of, sub.n_out)
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() <= 32767

    slot = np.full(system.n_atoms, -1)
    slot[sel] = np.arange(len(sel))
    a, b = system.bonds.T
    ch = (slot[a] >= 0) & (slot[b] >= 0) & (
        np.char.startswith(names[a].astype(str), "C")
        != np.char.startswith(names[b].astype(str), "C"))
    atom_a = torch.as_tensor(slot[a[ch]], dtype=torch.int32, device=card)
    atom_b = torch.as_tensor(slot[b[ch]], dtype=torch.int32, device=card)
    n_bonds = atom_a.shape[0]
    bond_type = torch.as_tensor(np.arange(n_bonds) % 82, dtype=torch.int32,
                                device=card)
    scale = torch.full((512,), 1e-3, device=card)
    box = torch.as_tensor(np.tile(system.box, (512, 1)), device=card)
    normal = torch.tensor([0.0, 0.0, 1.0], device=card)
    mask = torch.ones(512, dtype=torch.bool, device=card)
    outs = [p2.p2_positions(torch.as_tensor(q, device=card), atom_a, atom_b,
                            scale, box, normal, mask, bond_type, 82,
                            handle_pbc=True)
            for q in (got, got.astype(np.int16))]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_a_corrupt_record_raises_at_drain_on_the_card(card, aa_files,
                                                      tmp_path, monkeypatch):
    monkeypatch.setattr(Trajectory, "read_frames_xtc", _corrupting(5))
    with pytest.raises(AnalysisError, match=r"could not decode frame 5 of "
                       r"xtc file .* on the device: XTC payload overrun"):
        _forced(lambda out, maps: _aa(aa_files, out), tmp_path, monkeypatch,
                "xtc", device="cuda")


@pytest.mark.cuda
def test_the_card_decoder_rate_is_timed_once_a_layout(card, aa_files):
    """On the card the pick times the decoder once a process for a layout
    (`pick.xtc_card`, two launches: one on padding rows, one timed), and
    takes the cached rate after."""
    from gorder_tpu_torch.utils.timers import timers

    traj = Trajectory(aa_files[2])
    idx = traj.select_frames(None, None, 1)
    space = _space(int(traj.files[0].natoms[0]))
    stride, _ = traj.xtc_layout(idx)
    key = (str(card), stride, space.first_n, space.n_out, 64)
    wire._CARD_XTC_RATES.pop(key, None)
    timers.reset()
    before = xtc_ops.xtc_decode_launches
    rate = wire.card_xtc_rate(traj, idx, stride, space, 1, card, 64)
    assert rate > 0 and wire._CARD_XTC_RATES[key] == rate
    assert xtc_ops.xtc_decode_launches == before + 2
    assert "pick.xtc_card" in timers.snapshot()
    assert wire.card_xtc_rate(traj, idx, stride, space, 1, card, 64) == rate
    assert xtc_ops.xtc_decode_launches == before + 2
