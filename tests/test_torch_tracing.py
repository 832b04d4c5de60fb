"""The port's spans and counters (gorder_tpu_torch/utils/timers.py), where
the work happens (engine/drivers.py, engine/batches.py, engine/wire.py,
engine/channels.py, engine/fused.py), and the reader that names the
card's idle time by them (gorder_tpu_torch/diagnostics/spans.py), on the
CPU.

- A run records every phase of set-up, the pick and the batch loop, and
  `prepare` holds its parts; the counters count what the loop ships and
  what the pick's probes decode, and reset with the timers.
- Off, no phase enters `record_function`; under `traced()` each does, and
  a `GORDER_TPU_PROFILE` trace holds the phases nested in `gorder.total`,
  the decode on its own thread, and the YAML is the untraced run's.
- The idle cut: a gap splits at nested span boundaries into pieces that
  add up to it, each named by the innermost span open over it.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from gorder_tpu_torch.diagnostics import spans as idle
from gorder_tpu_torch.engine import channels
from gorder_tpu_torch.engine.drivers import run_analysis
from gorder_tpu_torch.input.config import (Analysis, AnalysisType,
                                           LeafletClassification,
                                           MembraneNormal)
from gorder_tpu_torch.utils.timers import PhaseTimers, timers

from .synthetic import make_flat_bilayer

FRAMES = 40
BATCH = 16            # 16, 16 and a padded 8
BATCHES = 3


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    return make_flat_bilayer(tmp_path_factory.mktemp("flat"),
                             n_frames=FRAMES)


def _analysis(files, output, **kw):
    gro, bnd, xtc = files
    return Analysis(structure=gro, bonds=bnd, trajectory=xtc,
                    analysis_type=AnalysisType.cgorder("resname POPC"),
                    output_yaml=str(output), silent=True, overwrite=True,
                    **kw)


def _run(files, output, **kw):
    """One CPU run → (its batches, the timers' snapshot after it)."""
    seen = []
    run_analysis(_analysis(files, output, **kw), "cpu", batch_size=BATCH,
                 on_batch=seen.append).write()
    return seen, timers.snapshot()


def _lines(path):
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines()
                if not ln.startswith("#")]


def test_a_run_records_set_up_pick_and_loop(flat, tmp_path):
    _, snap = _run(flat, tmp_path / "o.yaml")
    for phase in ("prepare", "structure", "topology", "atom_space",
                  "runtimes", "steps", "open", "pick", "pick.link",
                  "decode", "wait", "transfer", "dispatch", "trajectory",
                  "total"):
        assert phase in snap, phase
    parts = sum(snap[p] for p in ("structure", "topology", "atom_space",
                                  "runtimes", "steps", "open"))
    assert snap["prepare"] >= parts
    assert snap["pick"] >= sum(v for k, v in snap.items()
                               if k.startswith("pick.")
                               and isinstance(v, float))
    assert snap["total"] >= snap["prepare"] + snap["pick"]
    summary = timers.summary()
    assert "transfer_bytes " in summary and "probe_frames " in summary


def test_the_card_path_of_the_pick(flat, tmp_path, monkeypatch):
    """With a link rate (the card's path), the pick anchors its host model
    on 16 int16 frames and times the xtc wire's read twice over up to 64
    (here the run's 40), and a link that does not bind probes no other
    wire.
    The xtc read's rate is then set below the int16 decode's, so that
    int16 models faster."""
    monkeypatch.delenv("GORDER_TPU_WIRE", raising=False)
    monkeypatch.setattr(channels.wires, "measure_link_mbps",
                        lambda device: 1e9)
    real = channels.wires.host_xtc_rate
    monkeypatch.setattr(channels.wires, "host_xtc_rate",
                        lambda *a: real(*a) and 1e-3)
    seen, snap = _run(flat, tmp_path / "o.yaml")
    assert {db.kind for db in seen} == {"i16"}
    assert "pick.host_rate" in snap and "pick.xtc" in snap
    assert not [k for k in snap if k.startswith("pick.")
                and k not in ("pick.link", "pick.host_rate", "pick.xtc")]
    assert snap["probe_frames"] == 16 + 2 * FRAMES


def test_transfer_bytes_of_the_int16_wire(flat, tmp_path, monkeypatch):
    """Every batch ships its (B, n, 3) int16 positions, (B, 3) f32 box,
    (B,) mask and (B,) f32 scale, and nothing else."""
    monkeypatch.setenv("GORDER_TPU_WIRE", "i16")
    seen, snap = _run(flat, tmp_path / "o.yaml")
    assert [db.kind for db in seen] == ["i16"] * BATCHES
    n_out = seen[0].wire[0].shape[1]
    B = BATCH
    assert snap["transfer_bytes"] == BATCHES * (B * n_out * 6 + B * 12
                                                + B + B * 4)
    # the pick's 3-frame int16 probe, and no link probe on the CPU
    assert snap["probe_frames"] == 3


@pytest.mark.parametrize("wire, probe", [("b7", "pick.b7"),
                                         ("s6", "pick.s6"),
                                         ("d8", "pick.d8")])
def test_probe_frames_of_a_forced_wire(flat, tmp_path, monkeypatch, wire,
                                       probe):
    monkeypatch.setenv("GORDER_TPU_WIRE", wire)
    seen, snap = _run(flat, tmp_path / "o.yaml")
    assert {db.kind for db in seen} == {wire}
    assert probe in snap
    # one batch-sized window (b7, s6) or two 8-frame windows (d8), each
    # probed once: these frames need no retry
    assert snap["probe_frames"] == 16


def test_counters_reset_with_the_timers():
    t = PhaseTimers()
    t.count("transfer_bytes", 5)
    t.count("transfer_bytes", 7)
    with t.phase("a"):
        pass
    assert t.counters() == {"transfer_bytes": 12}
    assert t.snapshot()["transfer_bytes"] == 12
    assert t.summary().endswith("| transfer_bytes 12")
    t.reset()
    assert t.counters() == {} and t.snapshot() == {}
    assert t.summary() == "no phases recorded"


def test_phases_and_counters_from_many_threads():
    """No update is lost when more threads than cores time and count at
    once."""
    t = PhaseTimers()
    n_threads, n = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with t.phase("decode"):
                    t.count("probe_frames", 1)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert t.counters() == {"probe_frames": n_threads * n}
    assert t.get("decode") > 0


class _Spans:
    """A stand-in for `record_function` that records the names entered."""

    def __init__(self):
        self.names = []

    def __call__(self, name, args=None):
        self.names.append(name)
        return torch.autograd.profiler.record_function(name, args)


def test_off_no_span_is_entered(flat, tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.delenv("GORDER_TPU_PROFILE", raising=False)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, snap = _run(flat, tmp_path / "o.yaml")
    assert snap["total"] > 0


def test_traced_every_phase_is_a_span(flat, tmp_path, monkeypatch):
    monkeypatch.delenv("GORDER_TPU_PROFILE", raising=False)
    spy = _Spans()
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with timers.traced():
        with timers.traced():
            pass
        _, snap = _run(flat, tmp_path / "o.yaml")
    assert {"gorder." + k for k, v in snap.items()
            if isinstance(v, float)} == set(spy.names)
    # the switch is off again: no more spans
    entered = len(spy.names)
    _run(flat, tmp_path / "o.yaml")
    assert len(spy.names) == entered


def test_a_profile_holds_the_phases_nested(flat, tmp_path, monkeypatch):
    """GORDER_TPU_PROFILE: the Chrome trace holds the phases, each inside
    `gorder.total` on the run's thread, `gorder.decode` once a batch on
    the decode thread; the YAML is the untraced run's; every idle second
    of the window (all of it: no device on the CPU) is cut into pieces
    that add up to it."""
    _run(flat, tmp_path / "plain.yaml")
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("GORDER_TPU_PROFILE", str(trace_dir))
    _run(flat, tmp_path / "traced.yaml")
    assert _lines(tmp_path / "traced.yaml") == _lines(tmp_path / "plain.yaml")
    (path,) = trace_dir.glob("trace-*.json")
    with open(path) as fh:
        events = [ev for ev in json.load(fh)["traceEvents"]
                  if ev.get("cat") == "user_annotation"
                  and ev["name"].startswith("gorder.")]
    (total,) = [ev for ev in events if ev["name"] == "gorder.total"]
    main = [ev for ev in events if ev["tid"] == total["tid"]]
    names = {ev["name"] for ev in main}
    assert {"gorder.prepare", "gorder.pick", "gorder.transfer",
            "gorder.open", "gorder.pick.link"} <= names
    end = total["ts"] + total["dur"]
    for ev in main:
        assert total["ts"] <= ev["ts"] and ev["ts"] + ev["dur"] <= end
    decodes = [ev for ev in events if ev["name"] == "gorder.decode"]
    assert len(decodes) == BATCHES
    assert {ev["tid"] for ev in decodes} != {total["tid"]}

    spans, device = idle.load(str(path))
    assert device == []
    run, by_label = idle.attribute(spans, device)
    assert run["idle_s"] == pytest.approx(run["window_s"])
    assert sum(by_label.values()) == pytest.approx(run["idle_s"])
    assert {"gorder.prepare", "gorder.open", "gorder.pick"} <= set(by_label)
    assert idle.main([str(path)]) == 0


@pytest.mark.parametrize("option, phase", [("dynamic", "normals"),
                                           ("global", "classify")])
def test_spans_of_the_passes(flat, tmp_path, monkeypatch, option, phase):
    """Dynamic normals and the fused leaflet classifiers are timed in the
    batch's program."""
    monkeypatch.delenv("GORDER_TPU_WIRE", raising=False)
    kw = ({"membrane_normal": MembraneNormal.dynamic(
        "resname POPC and name PO4", 2.0)} if option == "dynamic" else
          {"leaflets": LeafletClassification.global_("resname POPC",
                                                     "name PO4")})
    _, snap = _run(flat, tmp_path / "o.yaml", **kw)
    assert snap[phase] > 0
    assert snap["dispatch"] >= snap[phase]


# --- the idle cut -------------------------------------------------------------

def test_a_gap_is_cut_at_nested_span_boundaries():
    """A 0.8 s idle gap in a run: prepare [0.1, 0.5) holding atom_space
    [0.2, 0.3), then pick [0.5, 0.75) holding pick.link [0.55, 0.6), then
    a kernel at [0.85, 0.9); µs."""
    us = 1e6
    spans = [(0.0, 1.0 * us, "gorder.total"),
             (0.1 * us, 0.5 * us, "gorder.prepare"),
             (0.2 * us, 0.3 * us, "gorder.atom_space"),
             (0.5 * us, 0.75 * us, "gorder.pick"),
             (0.55 * us, 0.6 * us, "gorder.pick.link")]
    device = [(0.8 * us, 0.9 * us)]
    gaps = idle.idle_gaps(device, 0.0, 1.0 * us)
    assert gaps == [(0.0, 0.8 * us), (0.9 * us, 1.0 * us)]
    pieces = idle.cut(gaps, idle.innermost(spans, 0.0, 1.0 * us))
    got = [(name, round(length / us, 6)) for name, length in pieces]
    assert got == [("gorder.total", 0.1), ("gorder.prepare", 0.1),
                   ("gorder.atom_space", 0.1), ("gorder.prepare", 0.2),
                   ("gorder.pick", 0.05), ("gorder.pick.link", 0.05),
                   ("gorder.pick", 0.15), ("gorder.total", 0.05),
                   ("gorder.total", 0.1)]
    assert sum(length for _, length in pieces) == pytest.approx(0.9 * us)
    run, by_label = idle.attribute(spans, device)
    assert run["busy_s"] == pytest.approx(0.1)
    assert run["window_s"] == pytest.approx(1.0)
    assert by_label["gorder.prepare"] == pytest.approx(0.3)
    assert by_label["gorder.total"] == pytest.approx(0.25)


def test_innermost_outside_every_span():
    pieces = idle.innermost([(2.0, 3.0, "a")], 0.0, 5.0)
    assert pieces == [(0.0, 2.0, None), (2.0, 3.0, "a"), (3.0, 5.0, None)]
    assert np.isclose(sum(b - a for a, b, _ in pieces), 5.0)
