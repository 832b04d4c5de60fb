"""The link-rate wire pick of the port (gorder_tpu_torch/engine/wire.py
`measure_link_mbps`, `_pick_wire_by_rate`, engine/channels.py) against
`gorder_tpu`'s (gorder_tpu/engine/wire.py:273-422), on the CPU.

- `measure_link_mbps` is None on the CPU, as `gorder_tpu`'s is on its CPU
  backend: a CPU run takes the bytes policy.
- With a link rate given, the two picks are equal on every system of
  tests/test_torch_wires.py at both extremes: a link of 1e-3 MiB/s binds
  every wire, so the fewest bytes a frame win; at 1e9 MiB/s no link binds
  and the short-circuit gives int16. The 36 nm vesicle and the 40 nm box
  overflow int16, which sends both packages to the bytes policy.
- In between, the pick depends on the host's int16 decode rate, a clock:
  with it pinned, the pick is the candidate of the highest modeled rate
  min(host rate · factor, link ÷ bytes a frame), the fewer bytes on a tie.
- `GORDER_TPU_WIRE` still wins over any rate.
- End to end, with the measured rate replaced in both packages, the runs
  ride the same wire and write the same YAML.
- The port alone forced onto its xtc wire, which `gorder_tpu` lacks,
  writes `gorder_tpu`'s YAML; runs with a decoder side channel keep a
  host wire.
"""

import logging
from types import SimpleNamespace

import pytest
import torch

import gorder_tpu.analysis
from gorder_tpu.engine import batches as jax_batches
from gorder_tpu.engine import wire as jwire
from gorder_tpu.io.traj import Trajectory as JaxTrajectory
from gorder_tpu_torch.engine import wire
from gorder_tpu_torch.engine.drivers import run_analysis
from gorder_tpu_torch.io.traj import Trajectory

from .test_torch_leaflets import _lines
from .test_torch_wires import (  # noqa: F401
    FORCED, WIRE_OPTIONS, _e2e_analysis, _space, coarse, dense, e2e,
    pick_inputs, wide)

SLOW, FAST = 1e-3, 1e9        # MiB/s


def test_no_link_rate_on_the_cpu():
    assert wire.measure_link_mbps(torch.device("cpu")) is None
    assert wire.measure_link_mbps("cpu") is None


def _systems(pick_inputs):
    """(name, traj, jax traj, idx, space, jax space, groups, n groups,
    bonds or None) of every pick system, with and without bond slots."""
    for name, (xtc, n, resids, slots) in pick_inputs.items():
        space, jspace = _space(n)
        group_of, n_groups, _ = wire.wire_groups(
            SimpleNamespace(resids=resids), space)
        traj, jtraj = Trajectory(xtc), JaxTrajectory(xtc)
        idx = traj.select_frames(None, None, 1)
        for bonds in (slots, None):
            yield (name, traj, jtraj, idx, space, jspace, group_of,
                   n_groups, bonds)


@pytest.mark.parametrize("link", [SLOW, FAST])
def test_rate_pick_matches_jax_at_the_extremes(pick_inputs, monkeypatch,
                                               link):
    monkeypatch.delenv("GORDER_TPU_WIRE", raising=False)
    picks = {}
    for (name, traj, jtraj, idx, space, jspace, group_of, n_groups,
         bonds) in _systems(pick_inputs):
        got = wire.pick_wire_format(traj, idx, space, 1, group_of, n_groups,
                                    8, bond_slots=bonds, link_mbps=link)
        want = jwire._pick_wire_format(jtraj, idx, jspace, 1, group_of,
                                       n_groups, 8, bond_slots=bonds,
                                       link_mbps=link)
        assert got == want, (name, bonds is not None)
        picks[name, bonds is not None] = got[0]
        bytes_pick = wire.pick_wire_format(traj, idx, space, 1, group_of,
                                           n_groups, 8, bond_slots=bonds)
        if name in ("wide", "vesicle"):
            # int16 cannot hold these boxes: the bytes policy
            assert got == bytes_pick
        elif link == SLOW:
            candidates = wire.rate_candidates(wire.Source(
                traj, space, 1, 8, group_of, n_groups, bonds), idx)
            assert got[0] == min(candidates,
                                 key=lambda w: candidates[w][1])
    if link == FAST:
        assert {w for (name, _), w in picks.items()
                if name not in ("wide", "vesicle")} == {"i16"}


def _modeled(candidates, host, link):
    """The candidate of the highest min(host · factor, link ÷ bytes), the
    fewer bytes on a tie, computed here on its own."""
    best = None
    for fmt, (cap, bpf) in candidates.items():
        key = (min(host * wire._WIRE_HOST_FACTOR[fmt],
                   link * 1024 * 1024 / bpf), -bpf)
        if best is None or key > best[0]:
            best = (key, (fmt, cap))
    return best[1]


@pytest.mark.parametrize("host", [500.0, 20000.0])
def test_mid_range_pick_with_the_host_rate_pinned(pick_inputs, monkeypatch,
                                                  host):
    """Links from where int16 binds down to where every wire does: the
    pick is the model's maximum, and more than one wire wins."""
    monkeypatch.delenv("GORDER_TPU_WIRE", raising=False)
    monkeypatch.setattr(wire, "host_i16_rate", lambda *a: host)
    winners = set()
    for (name, traj, _, idx, space, _, group_of, n_groups,
         bonds) in _systems(pick_inputs):
        if name in ("wide", "vesicle"):
            continue
        candidates = wire.rate_candidates(wire.Source(
            traj, space, 1, 8, group_of, n_groups, bonds), idx)
        assert {"i16", "f32", "d8"} <= set(candidates)
        i16_binds = host * space.n_out * 6 / (1024 * 1024)
        for f in (0.98, 0.7, 0.4, 0.2, 0.05, 0.01):
            link = i16_binds * f
            got = wire.pick_wire_format(traj, idx, space, 1, group_of,
                                        n_groups, 8, bond_slots=bonds,
                                        link_mbps=link)
            assert got == _modeled(candidates, host, link), (name, f)
            winners.add(got[0])
        # a link that int16 does not saturate: the short-circuit
        assert wire.pick_wire_format(
            traj, idx, space, 1, group_of, n_groups, 8, bond_slots=bonds,
            link_mbps=i16_binds * 1.01) == ("i16", 0)
    assert len(winners) >= 3, winners


@pytest.mark.parametrize("forced", [f for f in FORCED if f])
def test_forced_wire_wins_over_the_rate(pick_inputs, monkeypatch, forced):
    monkeypatch.setenv("GORDER_TPU_WIRE", forced)
    for (name, traj, jtraj, idx, space, jspace, group_of, n_groups,
         bonds) in _systems(pick_inputs):
        for link in (SLOW, FAST):
            got = wire.pick_wire_format(traj, idx, space, 1, group_of,
                                        n_groups, 8, bond_slots=bonds,
                                        link_mbps=link)
            assert got == wire.pick_wire_format(
                traj, idx, space, 1, group_of, n_groups, 8,
                bond_slots=bonds), (name, link)
            assert got == jwire._pick_wire_format(
                jtraj, idx, jspace, 1, group_of, n_groups, 8,
                bond_slots=bonds, link_mbps=link), (name, link)


@pytest.mark.parametrize("link", [SLOW, FAST])
@pytest.mark.parametrize("option", ["", "g"])
def test_runs_ride_the_rate_pick_as_jax(e2e, tmp_path, monkeypatch, caplog,
                                        link, option):
    """The measured rate replaced in both packages: the same wire, and
    the same YAML. The port's xtc wire, which `gorder_tpu` lacks, is held
    out by setting its read's rate below the int16 decode's
    (tests/test_torch_xtc.py has the runs that take it)."""
    files, want = e2e
    monkeypatch.delenv("GORDER_TPU_WIRE", raising=False)
    monkeypatch.setattr(gorder_tpu.analysis, "_measure_link_mbps",
                        lambda: link)
    monkeypatch.setattr(wire, "measure_link_mbps", lambda device: link)
    monkeypatch.setattr(wire, "host_xtc_rate", lambda *a: 1e-3)
    a = _e2e_analysis(files, option, tmp_path / "jax.yaml")
    a.run().write()
    jax_wire = jax_batches._LAST_WIRE[0]
    port = _e2e_analysis(files, option, tmp_path / "port.yaml")
    kinds = set()
    with caplog.at_level(logging.INFO, logger="gorder"):
        run_analysis(port, "cpu", on_batch=lambda db: kinds.add(db.kind)) \
            .write()
    assert _lines(port.output_yaml) == _lines(a.output_yaml) == want[option]
    picked = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("wire format:")]
    assert len(picked) == 1 and picked[0].split()[2] == jax_wire
    if link == FAST:
        assert jax_wire == "i16"
        assert any(r.getMessage().startswith("wire: i16 (link")
                   for r in caplog.records)
    base = jax_wire if jax_wire != "b7" else None
    assert kinds == ({base + option} if base else
                     {"b7g" if option == "g" else "b7"})


@pytest.mark.parametrize("option", WIRE_OPTIONS)
def test_forced_xtc_on_the_port_matches_jax(e2e, tmp_path, monkeypatch,
                                            caplog, option):
    """GORDER_TPU_WIRE=xtc on the port only: alone, every batch rides xtc
    (the records decoded by `ops/xtc.py`) and the YAML is `gorder_tpu`'s
    line for line; with global leaflets or a geometry (a decoder side
    channel) the port warns, rides a host wire and writes it too."""
    files, want = e2e
    monkeypatch.setenv("GORDER_TPU_WIRE", "xtc")
    port = _e2e_analysis(files, option, tmp_path / "port.yaml")
    kinds = set()
    with caplog.at_level(logging.WARNING, logger="gorder"):
        run_analysis(port, "cpu", on_batch=lambda db: kinds.add(db.kind)) \
            .write()
    assert _lines(port.output_yaml) == want[option]
    if option:
        assert kinds and not any(k.startswith("xtc") for k in kinds)
        assert "GORDER_TPU_WIRE=xtc requested" in caplog.text
    else:
        assert kinds == {"xtc"}
