"""Every output file and every input form of the port against `gorder_tpu`
on the CPU: the same analysis through `gorder_tpu.Analysis(...).run()`
and `gorder_tpu_torch.run(..., device="cpu")`, every file each writes
compared line for line but its `#` header lines.

- YAML, TAB, CSV, XVG (one file per molecule type) and the convergence
  XVG of error estimation, with and without global leaflets, for AA, CG
  and UA;
- a list of two XTC files, split by the frame offsets of
  `native.xtc_scan` (`chip_smoke.copy_frames`), with and without a
  duplicated boundary frame, also equal to the single file's run;
- `begin`/`end`/`step`: the frames the port selects are
  `gorder_tpu`'s `Trajectory.select_frames` and `chip_smoke
  .select_window`'s, and the run equals one over an XTC that holds just
  those frames;
- a single-precision TRR that `chip_smoke.write_trr` writes from the
  XTC's frames as read back, read by both packages (the f32 wire).
"""

import os

import numpy as np
import pytest

import chip_smoke
import gorder_tpu
import gorder_tpu_torch
from gorder_tpu.io.traj import Trajectory as JaxTrajectory
from gorder_tpu_torch.io import traj as port_traj

from .test_torch_pipeline import aa_files, cg_files, ua_files  # noqa: F401

P_HEADS = "resname POPC and name P"
HEADS = {"aa": P_HEADS, "ua": P_HEADS, "cg": "name PO4"}


def _atype(g, system):
    if system == "aa":
        return g.AnalysisType.aaorder(chip_smoke.HEAVY, chip_smoke.HYDROGENS)
    if system == "cg":
        return g.AnalysisType.cgorder("resname POPC")
    return g.AnalysisType.uaorder(
        saturated="resname POPC and name r'^CA\\d+$' or (resname POPC and "
                  "name r'^CB\\d+$' and not name CB9 CB10)",
        unsaturated="resname POPC and name CB9 CB10")


def _analysis(g, system, files, out, trajectory=None, leaflets=False,
              every_file=True, **kw):
    """The analysis of `system` over `files` (or `trajectory`) with the
    package namespace `g` and `EstimateError(n_blocks=4)`, writing into
    the directory `out`: the YAML, and with `every_file` also TAB, CSV,
    XVG and the convergence XVG."""
    gro, bnd, xtc = files
    os.makedirs(out, exist_ok=True)
    outputs = dict(output_yaml=os.path.join(out, "order.yaml"))
    if every_file:
        outputs.update(output_tab=os.path.join(out, "order.tab"),
                       output_csv=os.path.join(out, "order.csv"),
                       output_xvg=os.path.join(out, "order.xvg"))
    kw["estimate_error"] = g.EstimateError(
        n_blocks=4, output_convergence=(
            os.path.join(out, "convergence.xvg") if every_file else None))
    if leaflets:
        kw["leaflets"] = g.LeafletClassification.global_("resname POPC",
                                                         HEADS[system])
    return g.Analysis(structure=gro, bonds=bnd,
                      trajectory=xtc if trajectory is None else trajectory,
                      analysis_type=_atype(g, system), silent=True,
                      overwrite=True, **outputs, **kw)


def _files(out):
    """{file name: its lines but the `#` header lines} of a run's
    directory."""
    got = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name)) as fh:
            got[name] = [ln for ln in fh.read().splitlines()
                         if not ln.startswith("#")]
    return got


def _jax(system, files, out, **kw):
    results = _analysis(gorder_tpu, system, files, out, **kw).run()
    results.write()
    return results


def _port(system, files, out, **kw):
    results = gorder_tpu_torch.run(
        _analysis(gorder_tpu_torch, system, files, out, **kw), device="cpu")
    results.write()
    return results


@pytest.mark.parametrize("leaflets", [False, True],
                         ids=["no-leaflets", "global-leaflets"])
@pytest.mark.parametrize("system", ["aa", "cg", "ua"])
def test_every_output_file_matches_jax(request, tmp_path, system, leaflets):
    files = request.getfixturevalue(f"{system}_files")
    _jax(system, files, str(tmp_path / "jax"), leaflets=leaflets)
    _port(system, files, str(tmp_path / "port"), leaflets=leaflets)
    want = _files(str(tmp_path / "jax"))
    assert sorted(want) == ["convergence.xvg", "order.csv", "order.tab",
                            "order.yaml", "order_POPC.xvg"]
    assert _files(str(tmp_path / "port")) == want
    series = [ln for ln in want["convergence.xvg"] if "legend" in ln]
    assert len(series) == (3 if leaflets else 1)


@pytest.mark.parametrize("overlap", [0, 1], ids=["split", "shared-frame"])
def test_trajectory_list_matches_jax(aa_files, tmp_path, overlap):
    """Two XTC files cut from one at frame 250, byte copies of their frame
    records; with `overlap` the second also starts with the first's last
    frame, which the concatenation drops (same time). Both packages give
    the single file's output."""
    gro, bnd, xtc = aa_files
    n = len(port_traj.Trajectory(xtc).times)
    parts = [chip_smoke.copy_frames(xtc, str(tmp_path / "a.xtc"),
                                    range(250)),
             chip_smoke.copy_frames(xtc, str(tmp_path / "b.xtc"),
                                    range(250 - overlap, n))]
    _jax("aa", aa_files, str(tmp_path / "jax"), trajectory=parts)
    results = _port("aa", aa_files, str(tmp_path / "port"), trajectory=parts)
    _port("aa", aa_files, str(tmp_path / "single"))
    assert results.n_analyzed_frames == n
    want = _files(str(tmp_path / "jax"))
    assert _files(str(tmp_path / "port")) == want
    assert _files(str(tmp_path / "single")) == want


@pytest.mark.parametrize("system,window", [
    ("aa", (2000.0, 4990.0, 3)),
    ("aa", (1234.5, None, 1)),
    ("aa", (None, 3000.0, 7)),
    ("cg", (700.0, 3100.0, 2)),
    ("ua", (0.0, 5990.0, 5)),
])
def test_time_window_matches_jax(request, tmp_path, monkeypatch, system,
                                 window):
    """`begin`, `end` and `step`: the frames the port selects are
    gorder_tpu's and `chip_smoke.select_window`'s; its output equals
    gorder_tpu's, and the output of a run over an XTC holding just those
    frames (byte copies of their records)."""
    files = request.getfixturevalue(f"{system}_files")
    begin, end, step = window
    kw = dict(step=step, **({} if begin is None else dict(begin=begin)),
              **({} if end is None else dict(end=end)))
    selected = []
    real = port_traj.Trajectory.select_frames

    def spy(self, *args):
        selected.append(real(self, *args))
        return selected[-1]

    monkeypatch.setattr(port_traj.Trajectory, "select_frames", spy)
    _jax(system, files, str(tmp_path / "jax"), **kw)
    results = _port(system, files, str(tmp_path / "port"), **kw)
    want = JaxTrajectory(files[2]).select_frames(begin, end, step)
    times = JaxTrajectory(files[2]).times
    assert len(selected) == 1
    np.testing.assert_array_equal(selected[0], want)
    np.testing.assert_array_equal(chip_smoke.select_window(
        times, -np.inf if begin is None else begin,
        np.inf if end is None else end, step), want)
    assert results.n_analyzed_frames == len(want) > 0
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))
    # the same frames as a file of their own, analyzed whole; the
    # convergence curve's x axis counts in `step`s, so it is left out
    window_xtc = chip_smoke.copy_frames(files[2], str(tmp_path / "w.xtc"),
                                        want)
    for who, kw_files in (("port", kw), ("cut", {})):
        _port(system, files, str(tmp_path / f"{who}-yaml"),
              trajectory=window_xtc if who == "cut" else None,
              every_file=False, **kw_files)
    assert _files(str(tmp_path / "cut-yaml")) == \
        _files(str(tmp_path / "port-yaml"))


@pytest.mark.parametrize("system", ["cg", "aa"])
def test_trr_matches_jax(request, tmp_path, system):
    """A single-precision TRR holding the XTC's frames as read back: both
    packages read the same positions, boxes, times and steps from it, and
    give the same output files on the f32 wire."""
    gro, bnd, xtc = request.getfixturevalue(f"{system}_files")
    source = port_traj.Trajectory(xtc)
    frames = source.select_frames(None, None, 1)
    n_atoms = int(source.files[0].natoms[0])
    coords, boxes, times, steps = source.read_frames(frames, n_atoms)
    trr = chip_smoke.write_trr(str(tmp_path / "traj.trr"), coords, boxes,
                               times, steps)
    for traj in (port_traj.Trajectory(trr), JaxTrajectory(trr)):
        got = traj.read_frames(traj.select_frames(None, None, 1), n_atoms)
        for a, b in zip(got, (coords, boxes, times, steps)):
            np.testing.assert_array_equal(a, b)
    files = (gro, bnd, trr)
    _jax(system, files, str(tmp_path / "jax"))
    results = _port(system, files, str(tmp_path / "port"))
    assert results.n_analyzed_frames == len(frames)
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))


def test_convergence_ends_at_the_average(tmp_path):
    """On a cut of the CG benchmark membrane (tools/bench_modes.py
    `synth_cg`), the last point of each molecule's convergence curve (an
    f32 sample-weighted prefix mean) prints at the YAML's 4 decimals as
    the molecule's average order, in both packages, and the curves are
    equal."""
    files = chip_smoke.synthesize_cg(str(tmp_path), 600, n_lipids=32,
                                     total_atoms=32 * 12 + 400)
    curves = []
    for run in (_jax, _port):
        results = run("cg", files, str(tmp_path / run.__name__),
                      every_file=False)
        for mol in results.molecules:
            last = float(mol.convergence["total"][-1])
            value = mol.average_order.total.value
            assert f"{last:.4f}" == f"{value:.4f}", (mol.name, last, value)
            assert abs(last - value) < 1e-6
        curves.append([mol.convergence["total"] for mol in results.molecules])
    for a, b in zip(*curves):
        np.testing.assert_array_equal(a, b)
