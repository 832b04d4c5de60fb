"""Geometry selection through the port's whole path on the CPU
(`run_analysis(a, "cpu")`) against `gorder_tpu`'s `a.run()`, on the small
AA cut of tests/test_torch_pipeline.py, a small CG bilayer and the UA cut,
each run asserting the wire it took. Every non-`#` line of the YAML must be
equal.

A geometry run alone on XTC input is in the geometry channel class: both
packages take the inside mask from the decoder's bitplane (b7geo, or
`i16G` when the trajectory does not fit b7), so they agree with the
jitted engine. Geometry beside leaflets, normals or a map, and every UA
run, computes the mask on the device from positions; the XTC grid puts
bond midpoints exactly on a cuboid's faces there, and jitted XLA:CPU
contracts the midpoint into an FMA and moves some of them by an ulp
(tests/test_torch_geometry.py), so those cases run `gorder_tpu` op by op
(`jax.disable_jit()`), where every jnp operation is its own correctly
rounded computation, as every f32 step of the port is.
"""

import jax
import pytest

import chip_smoke
from gorder_tpu.input import Analysis as JaxAnalysis
from gorder_tpu.input import AnalysisType as JaxAnalysisType
from gorder_tpu.input.config import Geometry, LeafletClassification
from gorder_tpu_torch.engine.drivers import run_analysis
from gorder_tpu_torch.errors import ConfigError

from .synthetic import make_flat_bilayer
from .test_torch_leaflets import (  # noqa: F401
    CARD_BATCH, _kind, _lines, plans)
from .test_torch_pipeline import _ua, aa_files  # noqa: F401

P_HEADS = "resname POPC and name P"


@pytest.fixture(scope="module")
def cg_files(tmp_path_factory):
    return make_flat_bilayer(tmp_path_factory.mktemp("cg"), n_frames=40)


#: frames of the cuts the op-by-op cases run on: one padded batch, which
#: keeps `gorder_tpu` op by op to a few seconds
SHORT = 150


@pytest.fixture(scope="module")
def aa_short(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("aa_short"))
    gro, bnd, system = chip_smoke.synthesize_structure(
        d, n_lipids=4, total_atoms=4 * 134 + 60)
    return gro, bnd, chip_smoke.synthesize_trajectory(d, system, SHORT)


@pytest.fixture(scope="module")
def ua_short(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ua_short"))
    return chip_smoke.synthesize_ua(d, SHORT, n_lipids=6,
                                    total_atoms=6 * 51 + 90)


def _aa(files, **kw):
    gro, bnd, xtc = files
    return JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                       analysis_type=JaxAnalysisType.aaorder(
                           chip_smoke.HEAVY, chip_smoke.HYDROGENS),
                       silent=True, overwrite=True, **kw)


def _cg(files, **kw):
    gro, bnd, xtc = files
    return JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                       analysis_type=JaxAnalysisType.cgorder("resname POPC"),
                       silent=True, overwrite=True, **kw)


def _compare(analysis, tmp_path, op_by_op=False):
    """Run `analysis` on both engines; their YAML lines must be equal. →
    the lines."""
    for who in ("jax", "port"):
        analysis.output_yaml = str(tmp_path / f"{who}.yaml")
        if who == "port":
            run_analysis(analysis, "cpu", CARD_BATCH).write()
        elif op_by_op:
            with jax.disable_jit():
                analysis.run().write()
        else:
            analysis.run().write()
    want = _lines(tmp_path / "jax.yaml")
    assert _lines(tmp_path / "port.yaml") == want
    return want


CHANNEL_CASES = {
    "aa_cuboid_center": (Geometry("cuboid", xdim=(-2.0, 3.0),
                                  zdim=(-1.5, 1.5)), "b7"),
    "aa_cylinder_inverted": (Geometry("cylinder", reference="resname POPC",
                                      radius=2.5, orientation="z",
                                      invert=True), "b7"),
    "cg_cylinder_point": (Geometry("cylinder", reference=(4.0, 4.0, 4.0),
                                   radius=2.0, span=(-1.0, 1.0),
                                   orientation="z"), "b7"),
    "aa_sphere_selection_i16G": (Geometry("sphere", reference=P_HEADS,
                                          radius=3.0), "i16"),
}


@pytest.mark.parametrize("case", list(CHANNEL_CASES))
def test_geometry_channel_matches_jax(aa_files, cg_files, tmp_path, plans,
                                      monkeypatch, case):
    """Geometry alone: b7geo with the decoder's bitplane, and forced onto
    int16, `i16G` with the same bitplane: equal to the jitted engine. The
    wire is forced with GORDER_TPU_WIRE in both packages: on the AA cut s6
    ships fewer bytes a frame than b7, and both would pick it."""
    geometry, wire = CHANNEL_CASES[case]
    monkeypatch.setenv("GORDER_TPU_WIRE", wire)
    files, make = (cg_files, _cg) if case.startswith("cg") \
        else (aa_files, _aa)
    want = _compare(make(files, geometry=geometry), tmp_path)
    assert plans[-1].geo_channel and plans[-1].wire == wire
    assert len(want) > 10


@pytest.mark.parametrize("case", ["global_leaflets", "ua_sphere_selection",
                                  "ua_cuboid_point_pbc_off"])
def test_device_geometry_matches_jax(aa_short, ua_short, tmp_path, plans,
                                     case):
    """The inside mask computed on the device: geometry with global
    leaflets (int16 with the decoder's COG, a cuboid around the box
    center), and UA runs, whose bond positions exist only inside the step
    (a sphere around the P heads' center, and a cuboid around a point with
    PBC off). Op by op."""
    if case == "global_leaflets":
        a = _aa(aa_short, geometry=Geometry("cuboid", zdim=(-1.0, 2.0)),
                leaflets=LeafletClassification.global_("resname POPC",
                                                       P_HEADS))
    elif case == "ua_sphere_selection":
        a = _ua(ua_short, tmp_path / "x.yaml", "ua",
                geometry=Geometry("sphere", reference=P_HEADS, radius=3.0))
    else:
        a = _ua(ua_short, tmp_path / "x.yaml", "ua",
                geometry=Geometry("cuboid", reference=(3.0, 3.0, 3.0),
                                  xdim=(-1.0, 2.0), zdim=(0.0, 3.0)),
                handle_pbc=False)
    want = _compare(a, tmp_path, op_by_op=True)
    plan = plans[-1]
    assert not plan.geo_channel
    assert _kind(plan) == ("s6g" if case == "global_leaflets" else "s6")
    assert any("upper" in ln for ln in want) == (case == "global_leaflets")


def test_box_center_without_pbc_is_refused(aa_files):
    """The box center needs PBC: the same ConfigError text as gorder_tpu,
    before the run."""
    from gorder_tpu.errors import ConfigError as JaxConfigError

    a = _aa(aa_files, geometry=Geometry("cuboid", zdim=(0.0, 1.0)),
            handle_pbc=False)
    with pytest.raises(JaxConfigError) as want:
        a.run()
    with pytest.raises(ConfigError) as got:
        run_analysis(a, "cpu")
    assert str(got.value) == str(want.value)
    assert "periodic boundary conditions are ignored" in str(got.value)
