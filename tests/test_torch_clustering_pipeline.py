"""Clustering leaflets end to end on the CPU: `run_analysis(a, "cpu")`
against `gorder_tpu`'s `a.run()` on the same analysis, for AA, CG and UA,
spectral and spherical, at every frequency, with flip, collection and
dynamic normals. Every non-`#` YAML line must be equal, and the exported
leaflet file too; each run asserts the wire it took:

- every-frame spectral clustering rides a coordinate wire (s6 or d8
  here, as `gorder_tpu` picks), its labels oriented on the host frame
  after frame;
- every-frame spherical clustering rides s6 or d8 and classifies with the
  step;
- every-N and once clustering ride the b7 class plane with sparse reads
  of the assignment frames (UA runs never ride b7).

The head cloud is every atom the heads query selects, also where only a
part of the membrane is analyzed.

The systems are cuts of tools/bench_modes.py's clustering bilayer (heads
2 nm from the midplane, chains inward: well-posed clustering), the same
geometry with the UA lipid, and tests/synthetic.py's flat bilayer,
vesicle and scrambling bilayer.
"""

import contextlib

import pytest
import torch

import chip_smoke
from gorder_tpu.input import Analysis as JaxAnalysis
from gorder_tpu.input import AnalysisType as JaxAnalysisType
from gorder_tpu.input.config import (Frequency, LeafletClassification,
                                     MembraneNormal)
from gorder_tpu_torch.engine.drivers import run_analysis
from tools import bench_modes

from . import synthetic
from .test_torch_leaflets import (  # noqa: F401
    CARD_BATCH, _kind, _lines, plans)

P_HEADS = "resname POPC and name P"
N_LIPIDS = 16
FRAMES = 600                  # two batches, the second one padded
BILAYER_BOX = (3.2, 3.2, 11.0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{system: (gro, bnd, xtc)}."""
    d = tmp_path_factory.mktemp("clu")
    aab = chip_smoke.synthesize_aab(str(d), FRAMES, n_mols=N_LIPIDS,
                                    total_atoms=N_LIPIDS * 134 + 300,
                                    box=BILAYER_BOX)
    uab = chip_smoke.synthesize(
        str(d), "uab", bench_modes._ua_template, FRAMES, N_LIPIDS,
        N_LIPIDS * 51 + 90, (3.2, 3.2, 9.0), 29, ["OW", "HW1", "HW2"],
        z_offset=2.0, chains_inward=True)
    for sub in ("flat", "ves", "scr"):
        (d / sub).mkdir()
    flat = synthetic.make_flat_bilayer(d / "flat", n_frames=40)
    vesicle = synthetic.make_vesicle(d / "ves", n_outer=300, n_inner=60,
                                     n_frames=20)[:3]
    scrambling = synthetic.make_scrambling(d / "scr", n_per_leaflet=64,
                                           n_frames=8, flip_at=4,
                                           n_flip=4)[:3]
    return {"aa": aab, "ua": uab, "cg": flat, "vesicle": vesicle,
            "scrambling": scrambling}


@contextlib.contextmanager
def one_torch_thread():
    """torch's CPU ops on one thread: the classifiers loop over many small
    ops (100 k-means steps, 50 EM steps), and with every test worker's
    intra-op threads spinning on shared cores each step waits on
    descheduled threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_torch_thread():
        yield


def _analysis(files, system, leaflets, atoms="resname POPC", **kw):
    gro, bnd, xtc = files[system]
    if system == "aa":
        atype = JaxAnalysisType.aaorder(chip_smoke.HEAVY, chip_smoke.HYDROGENS)
    elif system == "ua":
        atype = JaxAnalysisType.uaorder(
            saturated="resname POPC and name r'^CA\\d+$' or "
                      "(resname POPC and name r'^CB\\d+$' and "
                      "not name CB9 CB10)",
            unsaturated="resname POPC and name CB9 CB10")
    else:
        atype = JaxAnalysisType.cgorder(atoms)
    return JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                       analysis_type=atype, leaflets=leaflets, silent=True,
                       overwrite=True, **kw)


def compare(analysis, tmp_path, plans):
    """Run `analysis` on both packages; every YAML line but the header
    (and the exported leaflets) equal, both leaflets populated. → the
    port's wire kind."""
    collect = analysis.leaflets.collect
    for who in ("jax", "port"):
        analysis.output_yaml = str(tmp_path / f"{who}.yaml")
        if collect.enabled:
            analysis.leaflets.with_collect(
                str(tmp_path / f"{who}_leaflets.yaml"))
        if who == "jax":
            analysis.run().write()
        else:
            with one_torch_thread():
                run_analysis(analysis, "cpu", CARD_BATCH).write()
    want = _lines(tmp_path / "jax.yaml")
    assert _lines(tmp_path / "port.yaml") == want
    for side in ("upper", "lower"):
        assert any(ln.strip().startswith(side) and "null" not in ln
                   for ln in want), side
    if collect.enabled:
        exported = _lines(tmp_path / "port_leaflets.yaml")
        assert exported == _lines(tmp_path / "jax_leaflets.yaml")
        assert len(exported) > 1
    return _kind(plans[-1])


def _spectral(heads=P_HEADS):
    return LeafletClassification.clustering(heads)


def _spherical(heads=P_HEADS):
    return LeafletClassification.spherical(heads)


CASES = {
    "aa_spectral_collect": ("aa", lambda: _spectral().with_collect(True),
                            {}, "s6"),
    "aa_spectral_every7_flip": (
        "aa", lambda: _spectral().with_frequency(Frequency.every(7))
        .with_flip().with_collect(True), {}, "b7m sparse"),
    "aa_spectral_once": (
        "aa", lambda: _spectral().with_frequency(Frequency.once()), {},
        "b7m sparse"),
    "aa_spherical_flip_collect": (
        "aa", lambda: _spherical().with_flip().with_collect(True), {},
        "s6"),
    "aa_spherical_every5": (
        "aa", lambda: _spherical().with_frequency(Frequency.every(5)), {},
        "b7m sparse"),
    "aa_spectral_dynamic_normals": (
        "aa", _spectral,
        dict(membrane_normal=MembraneNormal.dynamic(P_HEADS, 2.5)), "s6"),
    "cg_spectral_every4": (
        "cg", lambda: _spectral("name PO4").with_frequency(
            Frequency.every(4)).with_collect(True), {}, "b7m sparse"),
    "cg_spherical_vesicle": ("vesicle", lambda: _spherical("name PO4"), {},
                             "d8"),
    # lipid 0 flips to the lower leaflet at frame 4: only the orienter's
    # frame-to-frame matching keeps the leaflets' identities
    "cg_spectral_scrambling": (
        "scrambling", lambda: _spectral("name PO4").with_collect(True), {},
        "d8"),
    # a part of the membrane analyzed: the head cloud still spans every
    # lipid, and each analyzed molecule takes its own head's class
    "cg_spectral_part": (
        "cg", lambda: _spectral("name PO4").with_collect(True),
        dict(atoms="resname POPC and resid 5 to 40"), "d8"),
    "cg_spherical_part_vesicle": (
        "vesicle", lambda: _spherical("name PO4").with_flip()
        .with_collect(True), dict(atoms="resname POPC and resid 250 to 330"),
        "d8"),
    "ua_spectral": ("ua", lambda: _spectral().with_collect(True), {},
                    "d8"),
    "ua_spherical_once_flip": (
        "ua", lambda: _spherical().with_frequency(Frequency.once())
        .with_flip(), {}, "d8"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_clustering_leaflets_match_jax(files, tmp_path, plans, case):
    system, leaflets, kw, wire = CASES[case]
    analysis = _analysis(files, system, leaflets(), **kw)
    assert compare(analysis, tmp_path, plans) == wire


def test_fewer_than_two_heads_is_refused(files, tmp_path):
    """One analyzed lipid and one head atom in the cloud: both packages
    refuse it with the same TopologyError (leaflets.rs:103-113)."""
    gro, bnd, xtc = files["aa"]
    one = " and resid 1"
    msgs = []
    for run in (lambda a: a.run(), lambda a: run_analysis(a, "cpu")):
        a = JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                        analysis_type=JaxAnalysisType.aaorder(
                            chip_smoke.HEAVY + one,
                            chip_smoke.HYDROGENS + one),
                        leaflets=_spectral(P_HEADS + one),
                        output_yaml=str(tmp_path / "x.yaml"), silent=True)
        with pytest.raises(Exception) as err:
            run(a)
        msgs.append((type(err.value).__name__, str(err.value)))
    assert msgs[0] == msgs[1]
    assert msgs[1][0] == "TopologyError" and "'1' headgroup" in msgs[1][1]
