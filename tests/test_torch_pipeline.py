"""The port's main path end to end on the CPU (`gorder_tpu_torch.run(a,
device="cpu")`) against `gorder_tpu`'s `a.run()`: both write YAML, and
every line but the `#` header must be equal."""

import logging

import numpy as np
import pytest
import torch

import bench
import chip_smoke
import gorder_tpu_torch
from gorder_tpu.input import Analysis as JaxAnalysis
from gorder_tpu.input import AnalysisType as JaxAnalysisType
from gorder_tpu_torch.io.traj import Trajectory
from gorder_tpu_torch.engine.drivers import run_analysis

from .synthetic import make_flat_bilayer
from .test_torch_clustering_pipeline import files, plans  # noqa: F401

AA_LIPIDS = 4
AA_FRAMES = 600          # two batches of 512, the second one padded
UA_LIPIDS = 6
UA_FRAMES = 600


@pytest.fixture(scope="module")
def aa_files(tmp_path_factory):
    """A small cut of bench.py's AA membrane (same template and seeds)."""
    d = str(tmp_path_factory.mktemp("aa"))
    gro, bnd, system = chip_smoke.synthesize_structure(
        d, n_lipids=AA_LIPIDS, total_atoms=AA_LIPIDS * 134 + 60)
    return gro, bnd, chip_smoke.synthesize_trajectory(d, system, AA_FRAMES)


@pytest.fixture(scope="module")
def ua_files(tmp_path_factory):
    """A small cut of tools/bench_modes.py's UA membrane (same template and
    seed)."""
    d = str(tmp_path_factory.mktemp("ua"))
    return chip_smoke.synthesize_ua(d, UA_FRAMES, n_lipids=UA_LIPIDS,
                                    total_atoms=UA_LIPIDS * 51 + 90)


@pytest.fixture(scope="module")
def cg_files(tmp_path_factory):
    return make_flat_bilayer(tmp_path_factory.mktemp("cg"), n_frames=40)


def _aa(files, out, cls=JaxAnalysis, atype=JaxAnalysisType, **kw):
    gro, bnd, xtc = files
    return cls(structure=gro, bonds=bnd, trajectory=xtc,
               analysis_type=atype.aaorder(chip_smoke.HEAVY,
                                           chip_smoke.HYDROGENS),
               output_yaml=str(out), silent=True, overwrite=True, **kw)


def _cg(files, out, cls=JaxAnalysis, atype=JaxAnalysisType, **kw):
    gro, bnd, xtc = files
    return cls(structure=gro, bonds=bnd, trajectory=xtc,
               analysis_type=atype.cgorder("resname POPC"),
               output_yaml=str(out), silent=True, overwrite=True, **kw)


def _ua(files, out, mode, **kw):
    """bench_modes' UA analysis for `mode`, as gorder_tpu's Analysis."""
    port = chip_smoke.ua_analysis(mode, *files)
    at = port.analysis_type
    return JaxAnalysis(
        structure=port.structure, bonds=port.bonds,
        trajectory=port.trajectory,
        analysis_type=JaxAnalysisType.uaorder(
            saturated=at.saturated, unsaturated=at.unsaturated),
        output_yaml=str(out), silent=True, overwrite=True, **kw)


def _lines(path):
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines() if not ln.startswith("#")]


def _jax_lines(analysis):
    analysis.run().write()
    return _lines(analysis.output_yaml)


def _port_lines(analysis, **kw):
    run_analysis(analysis, "cpu", **kw).write()
    return _lines(analysis.output_yaml)


def test_aa_matches_jax(aa_files, tmp_path):
    """AA with error estimation (per-frame series), from gorder_tpu's own
    Analysis object (read by attribute)."""
    from gorder_tpu.input import EstimateError

    kw = dict(estimate_error=EstimateError(n_blocks=4))
    want = _jax_lines(_aa(aa_files, tmp_path / "jax.yaml", **kw))
    port = _aa(aa_files, tmp_path / "port.yaml", **kw)
    results = gorder_tpu_torch.run(port, device="cpu")
    results.write()
    assert results.n_analyzed_frames == AA_FRAMES
    assert _lines(port.output_yaml) == want
    assert len(want) > 100


def test_cg_matches_jax(cg_files, tmp_path):
    want = _jax_lines(_cg(cg_files, tmp_path / "jax.yaml"))
    got = _port_lines(_cg(cg_files, tmp_path / "port.yaml",
                          cls=gorder_tpu_torch.Analysis,
                          atype=gorder_tpu_torch.AnalysisType))
    assert got == want


def test_aa_i16_wire_matches_jax(aa_files, tmp_path, monkeypatch, caplog):
    """The int16 wire, forced by GORDER_TPU_WIRE=i16 (a trajectory that
    does not fit b7 now rides s6 or d8: tests/test_torch_wires.py)."""
    want = _jax_lines(_aa(aa_files, tmp_path / "jax.yaml"))
    monkeypatch.setenv("GORDER_TPU_WIRE", "i16")
    with caplog.at_level(logging.INFO, logger="gorder"):
        got = _port_lines(_aa(aa_files, tmp_path / "port.yaml"))
    assert "wire format: i16" in caplog.text
    assert got == want


def test_cg_f32_wire_matches_jax(cg_files, tmp_path):
    """Non-XTC input (a multi-frame GRO) rides the f32 wire."""
    gro, bnd, xtc = cg_files
    from gorder_tpu.io.gro import read_gro, write_gro

    system = read_gro(gro)
    traj = Trajectory(xtc)
    coords, boxes, _, _ = traj.read_frames(traj.select_frames(None, None, 1),
                                           system.n_atoms)
    multi = tmp_path / "traj.gro"
    with open(multi, "w") as out:
        for i in range(8):
            one = tmp_path / f"f{i}.gro"
            write_gro(str(one), system, positions=coords[i], box=boxes[i],
                      comment=f"frame t= {float(i)}")
            out.write(one.read_text())
    files = (gro, bnd, str(multi))
    want = _jax_lines(_cg(files, tmp_path / "jax.yaml"))
    assert _port_lines(_cg(files, tmp_path / "port.yaml")) == want


def test_aa_mid_run_fallback_matches_jax(aa_files, tmp_path, monkeypatch,
                                         caplog):
    """A batch that stops fitting b7 mid-run falls back to int16 for that
    batch; the output does not change. GORDER_TPU_WIRE=b7: on this small
    cut s6 ships fewer bytes a frame, and both packages would pick it."""
    monkeypatch.setenv("GORDER_TPU_WIRE", "b7")
    real = Trajectory.read_frames_b7
    calls = []

    def flaky(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == 3:              # probe, batch 0, then batch 1
            return None, 0
        return real(self, *args, **kwargs)

    want = _jax_lines(_aa(aa_files, tmp_path / "jax.yaml"))
    monkeypatch.setattr(Trajectory, "read_frames_b7", flaky)
    with caplog.at_level(logging.WARNING, logger="gorder"):
        got = _port_lines(_aa(aa_files, tmp_path / "port.yaml"),
                          batch_size=256)
    assert "wire fallback" in caplog.text
    assert got == want


def _geometry_matches_jax(aa_files, tmp_path, option):
    """A cuboid around the box center, and with it an export of dynamic
    normals (radius 10 nm: each of the 4 lipids' clouds holds every head):
    the YAML equals gorder_tpu's (the dynamic normals agree to float noise,
    so there the rule of `bench.validate_output`, one 4-dp print quantum
    on at most 10 % of the values, holds), and the exported normals are
    NaN for the same molecules and frames, the rest equal up to sign
    within 1e-5."""
    import yaml
    from gorder_tpu.input.config import Geometry, MembraneNormal

    kw = dict(geometry=Geometry(kind="cuboid", xdim=(0.0, 5.0)))
    if option == "dynamic_normal":
        kw["membrane_normal"] = MembraneNormal.dynamic(
            "resname POPC and name P", 10.0,
            collect=str(tmp_path / "jax_n.yaml"))
    want = _jax_lines(_aa(aa_files, tmp_path / "jax.yaml", **kw))
    port = _aa(aa_files, tmp_path / "port.yaml", **kw)
    if option == "dynamic_normal":
        port.membrane_normal.collect = type(port.membrane_normal.collect)(
            True, str(tmp_path / "port_n.yaml"))
    got = _port_lines(port)
    if option == "geometry":
        assert got == want
        return
    off = sum(a != b for a, b in zip(got, want))
    assert len(got) == len(want) and off <= len(want) // 10
    exported = []
    for who in ("jax", "port"):
        with open(tmp_path / f"{who}_n.yaml") as fh:
            exported.append(np.asarray(yaml.safe_load(fh)["POPC"],
                                       np.float64))
    j, p = exported
    assert j.shape == p.shape == (AA_FRAMES, AA_LIPIDS, 3)
    np.testing.assert_array_equal(np.isnan(p), np.isnan(j))
    assert np.isnan(p).any() and not np.isnan(p).all()
    keep = ~np.isnan(j)
    assert np.minimum(np.abs(p - j), np.abs(p + j))[keep].max() <= 1e-5


@pytest.mark.parametrize("option", ["leaflets", "ua_leaflets", "geometry",
                                    "dynamic_normal"])
def test_unported_option_raises(aa_files, tmp_path, request, option):
    """Options the port once refused with its "not yet ported" error, each
    now equal to gorder_tpu's output: geometry, an export of dynamic
    normals restricted to a geometry, and the clustering leaflet methods
    (spectral and spherical) for AA and CG, and for UA, on systems where
    clustering is well posed (tests/test_torch_clustering_pipeline.py)."""
    from gorder_tpu.input.config import LeafletClassification

    from .test_torch_clustering_pipeline import _analysis, compare

    if option in ("geometry", "dynamic_normal"):
        _geometry_matches_jax(aa_files, tmp_path, option)
        return
    files = request.getfixturevalue("files")
    plans = request.getfixturevalue("plans")
    runs = ([("aa", "resname POPC and name P", "s6"),
             ("vesicle", "name PO4", "d8")]
            if option == "leaflets" else
            [("ua", "resname POPC and name P", "d8")] * 2)
    for (system, heads, wire), method in zip(runs, ("clustering",
                                                    "spherical")):
        leaflets = getattr(LeafletClassification, method)(heads)
        out = tmp_path / f"{system}_{method}"
        out.mkdir()
        assert compare(_analysis(files, system, leaflets), out,
                       plans) == wire


def test_default_device_without_card_raises(aa_files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    a = _aa(aa_files, tmp_path / "x.yaml", cls=gorder_tpu_torch.Analysis,
            atype=gorder_tpu_torch.AnalysisType)
    with pytest.raises(gorder_tpu_torch.AnalysisError, match="cuda"):
        gorder_tpu_torch.run(a)


def test_cli_matches_jax(aa_files, tmp_path):
    from gorder_tpu_torch.__main__ import main

    gro, bnd, xtc = aa_files
    out = tmp_path / "cli.yaml"
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f"structure: {gro}\nbonds: {bnd}\ntrajectory: {xtc}\n"
        f"type: !AAOrder\n  heavy_atoms: \"{chip_smoke.HEAVY}\"\n"
        f"  hydrogens: \"{chip_smoke.HYDROGENS}\"\n"
        f"output: {out}\nsilent: true\noverwrite: true\n")
    assert main([str(cfg), "--device", "cpu"]) == 0
    want = _jax_lines(_aa(aa_files, tmp_path / "jax.yaml"))
    assert _lines(out) == want


def test_synthesis_matches_bench(tmp_path, monkeypatch):
    """chip_smoke's AA synthesis writes bench.py's files byte for byte."""
    n_lipids, total, frames = 3, 3 * 134 + 30, 5
    monkeypatch.setattr(bench, "N_LIPIDS", n_lipids)
    monkeypatch.setattr(bench, "TOTAL_ATOMS", total)
    monkeypatch.setattr(bench, "N_FRAMES", frames)
    (tmp_path / "b").mkdir()
    (tmp_path / "p").mkdir()
    _, _, sys_b = bench.synthesize_structure(str(tmp_path / "b"))
    bench.synthesize_trajectory(str(tmp_path / "b"), sys_b)
    _, _, sys_p = chip_smoke.synthesize_structure(str(tmp_path / "p"),
                                                  n_lipids, total)
    chip_smoke.synthesize_trajectory(str(tmp_path / "p"), sys_p, frames)
    for name in ("bench.gro", "bench.bnd", f"bench_{frames}.xtc"):
        assert (tmp_path / "b" / name).read_bytes() \
            == (tmp_path / "p" / name).read_bytes(), name
    np.testing.assert_array_equal(sys_b.positions, sys_p.positions)


def test_ua_palmitoyl_matches_jax(ua_files, tmp_path):
    """The saturated palmitoyl chain (CH3 and CH2 only): line-identical."""
    want = _jax_lines(_ua(ua_files, tmp_path / "jax.yaml", "ua-palmitoyl"))
    port = chip_smoke.ua_analysis("ua-palmitoyl", *ua_files,
                                  str(tmp_path / "port.yaml"))
    results = gorder_tpu_torch.run(port, device="cpu")
    results.write()
    assert results.n_analyzed_frames == UA_FRAMES
    assert _lines(port.output_yaml) == want
    assert len(want) > 50


def test_ua_matches_jax(ua_files, tmp_path):
    """The full UA analysis (CH3, CH2 and CH1u) with error estimation.
    CH1u samples may differ from the JAX package's by one 1e-6 quantum
    (tests/test_torch_ua.py), which `bench.validate_output` admits as at
    most one 4-dp print quantum on a few values; on this input every line
    is identical."""
    from gorder_tpu.input import EstimateError

    kw = dict(estimate_error=EstimateError(n_blocks=4))
    want = _jax_lines(_ua(ua_files, tmp_path / "jax.yaml", "ua", **kw))
    port = _ua(ua_files, tmp_path / "port.yaml", "ua", **kw)
    assert _port_lines(port) == want
    assert len(want) > 300


def test_ua_f32_wire_matches_jax(ua_files, tmp_path, monkeypatch, caplog):
    """The f32 wire, forced by GORDER_TPU_WIRE=f32 (a trajectory that does
    not fit int16 now rides s6 or d8: tests/test_torch_wires.py)."""
    want = _jax_lines(_ua(ua_files, tmp_path / "jax.yaml", "ua"))
    monkeypatch.setenv("GORDER_TPU_WIRE", "f32")
    with caplog.at_level(logging.INFO, logger="gorder"):
        got = _port_lines(_ua(ua_files, tmp_path / "port.yaml", "ua"))
    assert "wire format: f32" in caplog.text
    assert got == want


def test_ua_synthesis_matches_bench_modes(tmp_path, monkeypatch):
    """chip_smoke's UA synthesis writes tools/bench_modes.py's files byte
    for byte."""
    from tools import bench_modes

    n_lipids, total, frames = 3, 3 * 51 + 30, 5
    (tmp_path / "b").mkdir()
    (tmp_path / "p").mkdir()
    monkeypatch.setattr(bench_modes, "CACHE", str(tmp_path / "b"))
    bench_modes._synthesize("ua", bench_modes._ua_template, n_lipids, total,
                            bench_modes.UA_BOX, "POPC",
                            ["OW", "HW1", "HW2"], frames, seed=29)
    chip_smoke.synthesize_ua(str(tmp_path / "p"), frames, n_lipids, total)
    for name in ("ua_bench.gro", "ua_bench.bnd", f"ua_bench_{frames}.xtc"):
        assert (tmp_path / "b" / name).read_bytes() \
            == (tmp_path / "p" / name).read_bytes(), name


def test_cg_synthesis_matches_bench_modes(tmp_path, monkeypatch):
    """chip_smoke's CG synthesis writes tools/bench_modes.py's files byte
    for byte (the 0.3 nm walk, water resname W, unbonded one-bead
    water)."""
    from tools import bench_modes

    n_lipids, total, frames = 3, 3 * 12 + 30, 5
    (tmp_path / "b").mkdir()
    (tmp_path / "p").mkdir()
    monkeypatch.setattr(bench_modes, "CACHE", str(tmp_path / "b"))
    bench_modes._synthesize("cg", bench_modes._cg_template, n_lipids, total,
                            bench_modes.CG_BOX, "POPC", ["W"], frames,
                            seed=23)
    chip_smoke.synthesize_cg(str(tmp_path / "p"), frames, n_lipids, total)
    for name in ("cg_bench.gro", "cg_bench.bnd", f"cg_bench_{frames}.xtc"):
        assert (tmp_path / "b" / name).read_bytes() \
            == (tmp_path / "p" / name).read_bytes(), name
