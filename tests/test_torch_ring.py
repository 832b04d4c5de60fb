"""The decode ring's pool of host buffers (`gorder_tpu_torch/engine/ring.py`).

On the CPU, where the buffers are plain numpy and lent by the same rules:
- two consecutive runs of one layout are lent the same buffers, and the
  second allocates none (`ring_allocations` 0);
- a larger stride or a deeper ring (`GORDER_TPU_PREFETCH`) grows the set,
  and the pool keeps the larger;
- overlapping borrowers, nested or on many threads, get distinct buffers;
- every wire, alone and in its channel kinds, writes the same YAML on
  buffers filled with 0xFF as on fresh ones: each entry's `pad` and
  `read` set every byte a step reads;
- an xtc run after a run with longer records, which leaves stale bytes in
  the rows, writes the YAML of the same run in a fresh process;
- where pinning fails the ring falls back to pageable numpy, with one
  warning a process.

On the card (`-m cuda`): the ring's buffers and the link probe's are
page-locked, the probe's made once a process; the device copy of every
batch still holds what was shipped after its slot was refilled; an xtc
run counts `pinned_transfer_bytes`.
"""

import logging
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from gorder_tpu_torch.engine import ring, wire
from gorder_tpu_torch.engine.drivers import run_analysis
from gorder_tpu_torch.input.config import (Analysis, AnalysisType, Frequency,
                                           Geometry, LeafletClassification)
from gorder_tpu_torch.io import native
from gorder_tpu_torch.io.traj import Trajectory
from gorder_tpu_torch.utils.timers import timers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIPIDS = 18
FRAMES = 40
BATCH = 16                # 16, 16 and a padded 8: a ring of 3 slots


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A cut of the AA membrane of `chip_smoke.py` → (gro, bnd, its XTC at
    precision 1000, the same frames at precision 100, which every wire
    fits and whose records are shorter)."""
    d = tmp_path_factory.mktemp("aa")
    gro, bnd, system = chip_smoke.synthesize_structure(
        str(d), n_lipids=LIPIDS, total_atoms=LIPIDS * 134 + 60)
    fine = chip_smoke.synthesize_trajectory(str(d), system, FRAMES)
    traj = Trajectory(fine)
    coords, boxes, times, steps = traj.read_frames(
        traj.select_frames(None, None, 1), traj.files[0].natoms[0])
    coarse = str(d / "coarse.xtc")
    native.xtc_write(coarse, coords, boxes, times, steps.astype(np.int32),
                     precision=100.0)
    return gro, bnd, fine, coarse


@pytest.fixture
def pool(monkeypatch):
    """The process's pool, emptied for the test and restored after."""
    monkeypatch.setattr(ring.RING_POOL, "_sets", {})
    return ring.RING_POOL


OPTIONS = {
    "": {},
    "g": {"leaflets": LeafletClassification.global_("resname POPC",
                                                    "name P")},
    "G": {"geometry": Geometry("cylinder", reference=(4.0, 4.0, 4.0),
                               radius=2.0, span=(-1.0, 1.0),
                               orientation="z")},
    "m": {"leaflets": LeafletClassification.global_(
        "resname POPC", "name P").with_frequency(Frequency.every(5))},
}


def _analysis(files, out, coarse=True, option=""):
    gro, bnd, fine, coarse_xtc = files
    return Analysis(structure=gro, bonds=bnd,
                    trajectory=coarse_xtc if coarse else fine,
                    analysis_type=AnalysisType.aaorder(chip_smoke.HEAVY,
                                                       chip_smoke.HYDROGENS),
                    output_yaml=str(out), silent=True, overwrite=True,
                    **OPTIONS[option])


def _run(a, device="cpu", batch_size=BATCH, on_batch=None):
    """Run and write `a` → (YAML lines, batch kinds, counters)."""
    kinds = []

    def seen(db):
        kinds.append(db.kind)
        if on_batch is not None:
            on_batch(db)
    run_analysis(a, device, batch_size=batch_size, on_batch=seen).write()
    counters = timers.counters()
    with open(a.output_yaml) as fh:
        lines = [ln for ln in fh.read().splitlines()
                 if not ln.startswith("#")]
    return lines, kinds, counters


def _idle(pool, kind="cpu"):
    return list(pool._sets[kind])


# --- lending -----------------------------------------------------------------

def test_a_second_run_of_one_layout_is_lent_the_same_buffers(files, pool,
                                                             tmp_path):
    lines, kinds, counters = _run(_analysis(files, tmp_path / "a.yaml"))
    assert counters["ring_allocations"] == 3 == len(kinds)
    first = _idle(pool)
    again, _, counters = _run(_analysis(files, tmp_path / "b.yaml"))
    assert counters["ring_allocations"] == 0
    assert all(a is b for a, b in zip(_idle(pool), first, strict=True))
    assert again == lines
    # no card: nothing crossed from page-locked memory
    assert counters["pinned_transfer_bytes"] == 0
    assert counters["transfer_bytes"] > 0


@pytest.mark.parametrize("grow", ["stride", "prefetch"])
def test_a_larger_stride_or_a_deeper_ring_grows_the_set(files, pool,
                                                        tmp_path,
                                                        monkeypatch, grow):
    """int16 rows, then f32 rows twice their size; or a ring of 2 slots,
    then of 4 (5 batches of 8 frames): the pool allocates a set of the
    larger of each, and keeps it."""
    monkeypatch.setenv("GORDER_TPU_WIRE", "i16")
    if grow == "prefetch":
        monkeypatch.setenv("GORDER_TPU_PREFETCH", "2")
    _run(_analysis(files, tmp_path / "a.yaml"), batch_size=8)
    small = _idle(pool)
    if grow == "stride":
        monkeypatch.setenv("GORDER_TPU_WIRE", "f32")
    else:
        monkeypatch.setenv("GORDER_TPU_PREFETCH", "4")
    _, kinds, counters = _run(_analysis(files, tmp_path / "b.yaml"),
                              batch_size=8)
    large = _idle(pool)
    assert len(kinds) == 5
    if grow == "stride":
        assert len(small) == len(large) == 4
        assert len(large[0]) >= 2 * len(small[0]) - ring.ALIGN
    else:
        assert (len(small), len(large)) == (2, 4)
        assert len(large[0]) == len(small[0])
    assert counters["ring_allocations"] == len(large)
    assert not any(a is b for a in small for b in large)


def test_overlapping_borrowers_get_distinct_buffers():
    pool = ring.RingPool()
    with pool.lend("cpu", 2, 100) as a, pool.lend("cpu", 3, 100) as b:
        assert not any(np.shares_memory(x, y) for x in a for y in b)
    # the larger set is kept, and lent to the next run that fits it
    with pool.lend("cpu", 2, 60) as c:
        assert all(x is y for x, y in zip(c, b))
    with pool.lend("cpu", 1, 100) as d:
        assert len(d) == 3 and len(d[0]) == 100


def test_concurrent_runs_never_share_a_buffer():
    """16 threads, more than the cores, each borrowing 50 times with the
    interpreter switching threads every microsecond: each fills its set
    with its own mark, yields, and finds the mark whole."""
    pool = ring.RingPool()
    errors = []

    def borrow(mark):
        try:
            for k in range(50):
                with pool.lend("cpu", 2, 4096 * (1 + (mark + k) % 3)) as bufs:
                    for b in bufs:
                        b[:] = mark
                    threading.Event().wait(0.0001)
                    if any((b != mark).any() for b in bufs):
                        errors.append(mark)
        except Exception as e:                     # noqa: BLE001
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=borrow, args=(m,))
                   for m in range(1, 17)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_slots_are_laid_aligned_in_their_buffer():
    carve = ring._Carve()
    carve((3, 5), np.int16)
    carve(7, np.float32)
    assert carve.size == 64 + 28
    buf = np.zeros(carve.size, np.uint8)
    lay = ring._Carve(buf)
    a, b = lay((3, 5), np.int16), lay(7, np.float32)
    assert a.shape == (3, 5) and b.shape == (7,) and b.dtype == np.float32
    assert np.shares_memory(a, buf) and np.shares_memory(b, buf)
    assert b.ctypes.data - buf.ctypes.data == 64


def test_a_failing_allocator_falls_back_to_pageable_memory(monkeypatch,
                                                           caplog):
    def refuse(nbytes):
        raise RuntimeError("no page-locked memory")

    monkeypatch.setattr(ring, "_pinned_zeros", refuse)
    monkeypatch.setattr(ring, "_pin_warned", False)
    pool = ring.RingPool()
    with caplog.at_level(logging.WARNING, logger="gorder"):
        with pool.lend("cuda", 2, 256) as bufs:
            assert all(isinstance(b, np.ndarray) and len(b) == 256
                       and not b.any() for b in bufs)
        assert len(ring.host_buffer("cuda", 64)) == 64
    warned = [r for r in caplog.records if "cannot pin" in r.message]
    assert len(warned) == 1


# --- stale bytes -------------------------------------------------------------

CASES = ([(w, o) for o in ("", "g", "G")
          for w in ("b7", "s6", "d8", "i12", "i16", "f32")]
         + [("xtc", ""), ("b7", "m")])


@pytest.mark.parametrize("forced,option", CASES,
                         ids=[f"{w}{o}" for w, o in CASES])
def test_every_wire_reads_the_same_from_stale_buffers(files, pool, tmp_path,
                                                      monkeypatch, forced,
                                                      option):
    monkeypatch.setenv("GORDER_TPU_WIRE", forced)
    want, kinds, _ = _run(_analysis(files, tmp_path / "a.yaml",
                                    option=option))
    kind = {"b7": "b7geo" if option == "G" else "b7" + option}.get(
        forced, forced + option)
    assert set(kinds) == {kind}
    for buf in _idle(pool):
        buf.fill(0xFF)
    got, kinds, counters = _run(_analysis(files, tmp_path / "b.yaml",
                                          option=option))
    assert counters["ring_allocations"] == 0 and set(kinds) == {kind}
    assert got == want


_FRESH = """
import sys
import chip_smoke
from gorder_tpu_torch.engine.drivers import run_analysis
from gorder_tpu_torch.input.config import Analysis, AnalysisType
gro, bnd, xtc, out = sys.argv[1:]
a = Analysis(structure=gro, bonds=bnd, trajectory=xtc,
             analysis_type=AnalysisType.aaorder(chip_smoke.HEAVY,
                                                chip_smoke.HYDROGENS),
             output_yaml=out, silent=True, overwrite=True)
run_analysis(a, "cpu", batch_size=16).write()
"""


def test_an_xtc_run_after_longer_records_writes_a_fresh_process_yaml(
        files, pool, tmp_path, monkeypatch):
    """Precision 1000's records, then precision 100's shorter ones in the
    same, larger, set: the rows hold the first run's bytes past each
    record."""
    monkeypatch.setenv("GORDER_TPU_WIRE", "xtc")
    gro, bnd, fine, coarse = files
    layout = [Trajectory(x).xtc_layout(np.arange(FRAMES))[0]
              for x in (fine, coarse)]
    assert layout[0] > layout[1]
    _, kinds, _ = _run(_analysis(files, tmp_path / "a.yaml", coarse=False))
    stale = _idle(pool)
    assert set(kinds) == {"xtc"} and all(b.any() for b in stale)
    got, kinds, counters = _run(_analysis(files, tmp_path / "b.yaml"))
    assert set(kinds) == {"xtc"} and counters["ring_allocations"] == 0
    assert all(a is b for a, b in zip(_idle(pool), stale))
    out = tmp_path / "fresh.yaml"
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _FRESH, gro, bnd, coarse,
                           str(out)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with open(out) as fh:
        assert got == [ln for ln in fh.read().splitlines()
                       if not ln.startswith("#")]


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: page-locked memory and its DMA")
    return torch.device("cuda")


def _pinned(a):
    return torch.from_numpy(a).is_pinned()


@pytest.mark.cuda
def test_the_ring_and_the_link_probe_are_page_locked(card, files, pool,
                                                     tmp_path):
    _run(_analysis(files, tmp_path / "a.yaml"), device=card)
    assert all(_pinned(b) for b in _idle(pool, "cuda"))
    assert wire.measure_link_mbps(card) > 0
    probe = wire._LINK_PROBE["cuda"]
    assert _pinned(probe)
    assert wire.measure_link_mbps(card) > 0
    assert wire._LINK_PROBE["cuda"] is probe


@pytest.mark.cuda
def test_a_batch_on_the_card_outlives_its_slot(card, files, pool, tmp_path,
                                               monkeypatch):
    """A ring of 2 slots over 5 batches: each slot is refilled after its
    batch's copy, and every batch's rows on the card still hold the
    records of its own frames. The run counts the rows as pinned bytes."""
    monkeypatch.setenv("GORDER_TPU_WIRE", "xtc")
    monkeypatch.setenv("GORDER_TPU_PREFETCH", "2")
    shipped = []
    _, kinds, counters = _run(_analysis(files, tmp_path / "a.yaml"),
                              device=card, batch_size=8,
                              on_batch=lambda db: shipped.append(
                                  (db.wire[0], db.wire[1])))
    assert kinds == ["xtc"] * 5
    traj = Trajectory(files[3])
    idx = traj.select_frames(None, None, 1)
    stride, _ = traj.xtc_layout(idx)
    for b, (raw, lengths) in enumerate(shipped):
        rows = np.zeros((8, stride), np.uint8)
        want = np.zeros(8, np.int32)
        traj.read_frames_xtc(idx[b * 8:(b + 1) * 8], rows, want)
        got, n = raw.cpu().numpy(), lengths.cpu().numpy()
        np.testing.assert_array_equal(n, want)
        for k in range(8):
            assert got[k, :n[k]].tobytes() == rows[k, :n[k]].tobytes()
    rows_bytes = sum(r.numel() + n.numel() * 4 for r, n in shipped)
    assert counters["pinned_transfer_bytes"] == rows_bytes
    assert counters["transfer_bytes"] > rows_bytes
