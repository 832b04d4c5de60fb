"""Membrane normals through the port's whole path on the CPU
(`run_analysis(a, "cpu")`) against `gorder_tpu`'s `a.run()` on small cuts
of the benchmark membranes, each run asserting the wire it took.

- Manual normals (an inline map or a file): every non-`#` YAML line equal,
  and the exported normals too.
- Dynamic normals: the normals agree with `gorder_tpu`'s to float noise
  and up to sign (tests/test_torch_normals.py), so a sample may differ by
  one 1e-6 quantum; the YAML must pass `bench.validate_output`'s rule
  against `gorder_tpu`'s (one 4-dp print quantum on at most 10 % of the
  values), and the lines off are counted. The exported normals agree up
  to sign within 1e-5.

The cuts are small, so the radius is raised until every molecule's cloud
holds ≥ 3 heads (the benchmark's 256 lipids fill a 2 nm radius).
"""

import os

import numpy as np
import pytest

import bench
import chip_smoke
from gorder_tpu.input import Analysis as JaxAnalysis
from gorder_tpu.input import AnalysisType as JaxAnalysisType
from gorder_tpu.input.config import LeafletClassification, MembraneNormal
from gorder_tpu_torch.engine.drivers import run_analysis

from .synthetic import make_flat_bilayer
from .test_torch_leaflets import (  # noqa: F401
    CARD_BATCH, _kind, _lines, plans)

P_HEADS = "resname POPC and name P"
AA_LIPIDS = 18           # a 3 x 3 grid per leaflet, 4.33 nm apart
AA_RADIUS = 5.0
UA_LIPIDS = 18           # 3.07 nm apart
UA_RADIUS = 3.8
FRAMES = 600             # two batches of 512, the second one padded


@pytest.fixture(scope="module")
def aa_files(tmp_path_factory):
    """A small cut of bench.py's AA membrane (same template and seeds)."""
    d = str(tmp_path_factory.mktemp("aa"))
    gro, bnd, system = chip_smoke.synthesize_structure(
        d, n_lipids=AA_LIPIDS, total_atoms=AA_LIPIDS * 134 + 60)
    return gro, bnd, chip_smoke.synthesize_trajectory(d, system, FRAMES)


@pytest.fixture(scope="module")
def ua_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ua"))
    return chip_smoke.synthesize_ua(d, FRAMES, n_lipids=UA_LIPIDS,
                                    total_atoms=UA_LIPIDS * 51 + 90)


def _aa(files, normal, **kw):
    gro, bnd, xtc = files
    return JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                       analysis_type=JaxAnalysisType.aaorder(
                           chip_smoke.HEAVY, chip_smoke.HYDROGENS),
                       membrane_normal=normal, silent=True, overwrite=True,
                       **kw)


def _ua(files, normal, **kw):
    port = chip_smoke.ua_analysis("ua", *files)
    at = port.analysis_type
    return JaxAnalysis(
        structure=port.structure, bonds=port.bonds,
        trajectory=port.trajectory,
        analysis_type=JaxAnalysisType.uaorder(
            saturated=at.saturated, unsaturated=at.unsaturated),
        membrane_normal=normal, silent=True, overwrite=True, **kw)


def _exported(path):
    """The exported normals file as {molecule type: (frames, M, 3)}."""
    import yaml

    with open(path) as fh:
        return {k: np.asarray(v, np.float64)
                for k, v in yaml.safe_load(fh).items()}


def _run_both(analysis, tmp_path, **kw):
    """Run `analysis` on both engines; → (jax YAML path, port YAML path,
    exported normals paths or None)."""
    collect = analysis.membrane_normal.collect
    out = {}
    for who in ("jax", "port"):
        analysis.output_yaml = str(tmp_path / f"{who}.yaml")
        if collect.enabled:
            analysis.membrane_normal.collect = type(collect)(
                True, str(tmp_path / f"{who}_normals.yaml"))
        if who == "jax":
            analysis.run().write()
        else:
            run_analysis(analysis, "cpu", **{"batch_size": CARD_BATCH,
                                             **kw}).write()
        out[who] = (analysis.output_yaml,
                    str(tmp_path / f"{who}_normals.yaml")
                    if collect.enabled else None)
    return out["jax"], out["port"]


def _validate(port_yaml, jax_yaml, tmp_path, monkeypatch):
    """`bench.validate_output` with `gorder_tpu`'s YAML as the golden →
    (status, lines off)."""
    golden = tmp_path / "golden"
    golden.mkdir(exist_ok=True)
    (golden / f"run_{FRAMES}.yaml").write_text(open(jax_yaml).read())
    monkeypatch.setattr(bench, "GOLDEN_DIR", str(golden))
    status = bench.validate_output(port_yaml, "run", FRAMES)
    assert status is not None
    off = sum(a != b for a, b in zip(_lines(port_yaml), _lines(jax_yaml)))
    return status, off


def _unit_rows(rng, n_frames, n_mols):
    v = rng.normal(0, 1, (n_frames, n_mols, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return np.round(v, 4).tolist()


@pytest.mark.parametrize("source", ["map", "file", "map_export"])
def test_aa_manual_normals_match_jax(aa_files, tmp_path, plans, source):
    """Manual normals ride s6, the wire `gorder_tpu` picks for this
    coordinate run (the table is host data), and the output equals
    `gorder_tpu`'s line for line."""
    rows = _unit_rows(np.random.default_rng(3), FRAMES, AA_LIPIDS)
    if source == "file":
        import yaml

        path = tmp_path / "normals.yaml"
        path.write_text(yaml.safe_dump({"POPC": rows}))
        normal = MembraneNormal.from_file(str(path))
    else:
        normal = MembraneNormal.from_map(
            {"POPC": rows}, collect=source == "map_export")
    (jy, jn), (py, pn) = _run_both(_aa(aa_files, normal), tmp_path)
    assert _kind(plans[-1]) == "s6"
    assert _lines(py) == _lines(jy) and len(_lines(jy)) > 100
    if pn is not None:
        assert _lines(pn) == _lines(jn)
        assert _exported(pn)["POPC"].shape == (FRAMES, AA_LIPIDS, 3)


@pytest.mark.parametrize("case", ["dynamic", "export", "individual",
                                  "global", "every2"])
def test_aa_dynamic_normals_match_jax(aa_files, tmp_path, plans,
                                      monkeypatch, case):
    """Dynamic normals alone, or with individual leaflets, ride b7x (the
    aux channel ships the union of the normal-heads cloud and the
    classifier's atoms); beside global leaflets they ride s6 with the
    decoder's COG; with every-2 leaflets, s6 with host classes."""
    kw = {}
    normal = MembraneNormal.dynamic(P_HEADS, AA_RADIUS,
                                    collect=case == "export")
    if case == "individual":
        kw["leaflets"] = LeafletClassification.individual(
            P_HEADS, "resname POPC and name C217 C317")
    elif case in ("global", "every2"):
        kw["leaflets"] = LeafletClassification.global_("resname POPC",
                                                       P_HEADS)
        if case == "every2":
            from gorder_tpu.input.config import Frequency

            kw["leaflets"].with_frequency(Frequency.every(2))
    if "leaflets" in kw:
        # leaflets beside a normal that is not static need their own axis
        kw["leaflets"].with_membrane_normal("z")
    (jy, jn), (py, pn) = _run_both(_aa(aa_files, normal, **kw), tmp_path)
    assert _kind(plans[-1]) == {"dynamic": "b7x", "export": "b7x",
                                "individual": "b7x", "global": "s6g",
                                "every2": "s6"}[case]
    status, off = _validate(py, jy, tmp_path, monkeypatch)
    print(f"aa dynamic {case}: {status}, {off} lines off")
    if "leaflets" in kw:
        assert any("upper" in ln for ln in _lines(py))
    if pn is not None:
        got, want = _exported(pn)["POPC"], _exported(jn)["POPC"]
        assert got.shape == want.shape == (FRAMES, AA_LIPIDS, 3)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=2e-6)
        dots = np.abs((got * want).sum(-1))
        assert dots.min() >= 1 - 1e-5


@pytest.mark.parametrize("case", ["dynamic", "manual"])
def test_ua_normals_match_jax(ua_files, tmp_path, plans, monkeypatch, case):
    """UA runs ride s6: dynamic normals within the print-quantum rule,
    manual ones line for line."""
    if case == "dynamic":
        normal = MembraneNormal.dynamic(P_HEADS, UA_RADIUS)
    else:
        normal = MembraneNormal.from_map(
            {"POPC": _unit_rows(np.random.default_rng(5), FRAMES,
                                UA_LIPIDS)})
    (jy, _), (py, _) = _run_both(_ua(ua_files, normal), tmp_path)
    assert _kind(plans[-1]) == "s6"
    if case == "manual":
        assert _lines(py) == _lines(jy)
    status, off = _validate(py, jy, tmp_path, monkeypatch)
    print(f"ua {case}: {status}, {off} lines off")
    assert len(_lines(jy)) > 100


def test_cg_dynamic_normals_match_jax(tmp_path, plans, monkeypatch):
    gro, bnd, xtc = make_flat_bilayer(tmp_path, n_frames=40)
    a = JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                    analysis_type=JaxAnalysisType.cgorder("resname POPC"),
                    membrane_normal=MembraneNormal.dynamic(
                        "resname POPC and name PO4", 2.0),
                    silent=True, overwrite=True)
    (jy, _), (py, _) = _run_both(a, tmp_path)
    assert _kind(plans[-1]) == "b7x"
    status, off = _validate(py, jy, tmp_path, monkeypatch)
    print(f"cg dynamic: {status}, {off} lines off")


def test_on_batch_hands_out_the_normals_each_step_used(aa_files, tmp_path):
    """`DeviceBatch.normal` is the (B, M, 3) normals the batch's step used:
    those the export writes, in frame order."""
    from gorder_tpu_torch import Analysis, AnalysisType

    gro, bnd, xtc = aa_files
    a = Analysis(structure=gro, bonds=bnd, trajectory=xtc,
                 analysis_type=AnalysisType.aaorder(chip_smoke.HEAVY,
                                                    chip_smoke.HYDROGENS),
                 membrane_normal=MembraneNormal.dynamic(
                     P_HEADS, AA_RADIUS, collect=str(tmp_path / "n.yaml")),
                 output_yaml=str(tmp_path / "o.yaml"), silent=True,
                 overwrite=True)
    seen = []
    run_analysis(a, "cpu", CARD_BATCH, on_batch=seen.append).write()
    assert [db.kind for db in seen] == ["b7x", "b7x"]
    used = np.concatenate([db.normal[db.mask].numpy() for db in seen])
    assert used.shape == (FRAMES, AA_LIPIDS, 3)
    np.testing.assert_allclose(used, _exported(tmp_path / "n.yaml")["POPC"],
                               atol=5e-7)


def test_not_enough_points_matches_jax(aa_files, tmp_path):
    """A radius that leaves a head alone: both engines refuse with the
    same text, and write nothing."""
    messages = []
    for who in ("jax", "port"):
        a = _aa(aa_files, MembraneNormal.dynamic(P_HEADS, 0.5))
        a.output_yaml = str(tmp_path / f"{who}.yaml")
        with pytest.raises(Exception) as err:
            a.run() if who == "jax" else run_analysis(a, "cpu")
        assert type(err.value).__name__ == "DynamicNormalError"
        messages.append(str(err.value))
        assert not os.path.exists(a.output_yaml)
    assert messages[0] == messages[1]


def test_manual_table_must_cover_the_run(aa_files, tmp_path):
    from gorder_tpu_torch.errors import ManualNormalError

    a = _aa(aa_files, MembraneNormal.from_map(
        {"POPC": _unit_rows(np.random.default_rng(1), 7, AA_LIPIDS)}))
    a.output_yaml = str(tmp_path / "x.yaml")
    with pytest.raises(ManualNormalError, match="'7'"):
        run_analysis(a, "cpu")
    assert not os.path.exists(tmp_path / "x.yaml")
