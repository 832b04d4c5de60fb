"""Ordermaps through the port's whole path on the CPU (`run_analysis(a,
"cpu")`) against `gorder_tpu`'s `a.run()` on the small cuts of the
benchmark membranes that tests/test_torch_normals_pipeline.py uses, and on
a small CG bilayer, each run asserting the wire it took: a map run never
rides b7.

`gorder_tpu` runs jitted, as it runs in production, and in the AA static,
AA manual-span and CG cases also op by op (`jax.disable_jit()`), where
every jnp operation is its own correctly rounded computation, as every f32
step of the port is.

- Op by op: the YAML and every `.dat` file of the two ordermap
  directories are equal line for line (`#` lines aside: the version), the
  file sets too. (Dynamic normals agree with `gorder_tpu`'s to float
  noise, and UA CH1u hydrogens to the last bits of atan2, cos and sin, so
  those runs are held to the jitted rule only; tests/test_torch_ordermap.py
  holds the UA map exactly without CH1u.)
- Jitted: the YAML is equal, the file set too, and at most 0.1 % of the
  tile lines differ. XLA:CPU contracts FMAs inside a jitted program (the
  exactness contract in ROADMAP.md): in d² (a sample off by a quantum),
  and in the pair difference f32(q_b)·s − p_a, which moves a bond midpoint
  that lies on a tile boundary by an ulp and so the sample into the next
  tile. The number of lines off is printed.

The XTC positions lie on a 0.001 nm grid, so bond midpoints fall exactly
on the 0.1 and 0.25 nm tile boundaries here: the tiles hold only if the
pair formulation is bit for bit the JAX package's.
"""

import os
import sys

import jax
import numpy as np
import pytest

from gorder_tpu.input import Analysis as JaxAnalysis
from gorder_tpu.input import AnalysisType as JaxAnalysisType
from gorder_tpu.input.config import (GridSpan, LeafletClassification,
                                     MembraneNormal, OrderMapParams)
from gorder_tpu_torch.engine.drivers import run_analysis

from .synthetic import make_flat_bilayer
from .test_torch_leaflets import _kind, _lines, plans  # noqa: F401
from .test_torch_normals_pipeline import (  # noqa: F401
    AA_RADIUS, P_HEADS, _aa, _ua, aa_files, ua_files)


def _map(tmp_path, **fields):
    return OrderMapParams.parse(dict(
        fields, output_directory=str(tmp_path / "maps")))


def _run_both(analysis, tmp_path, op_by_op=False):
    """Run `analysis` on `gorder_tpu`, jitted and, with `op_by_op`, op by
    op, and on the port, each into its own YAML and map directory. →
    {engine: (YAML path, map directory)}."""
    out = {}
    for who in (("op_by_op",) if op_by_op else ()) + ("jitted", "port"):
        analysis.output_yaml = str(tmp_path / f"{who}.yaml")
        analysis.map.output_directory = str(tmp_path / f"{who}_maps")
        if who == "op_by_op":
            with jax.disable_jit():
                analysis.run().write()
        elif who == "jitted":
            analysis.run().write()
        else:
            run_analysis(analysis, "cpu").write()
        out[who] = (analysis.output_yaml, analysis.map.output_directory)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _compare_maps(port_dir, jax_dir, n_tiles):
    """The two map directories hold the same files, each .dat file
    `n_tiles` tile lines; → (tile lines, tile lines that differ). Every
    other line is equal."""
    names = _files(jax_dir)
    assert _files(port_dir) == names and len(names) > 2
    total = off = 0
    for name in names:
        with open(os.path.join(port_dir, name)) as fh:
            got = [ln for ln in fh.read().splitlines()
                   if not ln.startswith("#")]
        with open(os.path.join(jax_dir, name)) as fh:
            want = [ln for ln in fh.read().splitlines()
                    if not ln.startswith("#")]
        if not name.endswith(".dat"):
            assert got == want, name
            continue
        tiles = [ln for ln in want if not ln.startswith(("@", "$"))]
        assert len(tiles) == n_tiles and len(got) == len(want), name
        for g, w in zip(got, want):
            if g != w:
                assert g.split()[:2] == w.split()[:2], (name, g, w)
                off += 1
        total += len(tiles)
    return total, off


def _check(out, n_tiles, classes=("full",)):
    """Op by op, where run: YAML and maps equal. Jitted: YAML equal, at
    most 0.1 % of the tile lines off. → (tile lines, lines off against
    jitted)."""
    port_yaml, port_maps = out["port"]
    assert len(_lines(port_yaml)) > 10
    assert _lines(port_yaml) == _lines(out["jitted"][0])
    if "op_by_op" in out:
        assert _lines(port_yaml) == _lines(out["op_by_op"][0])
        assert _compare_maps(port_maps, out["op_by_op"][1],
                             n_tiles)[1] == 0
    total, off = _compare_maps(port_maps, out["jitted"][1], n_tiles)
    assert off <= total // 1000, (off, total)
    present = {os.path.basename(n).rsplit("_", 1)[1]
               for n in _files(port_maps) if n.endswith(".dat")}
    assert present == {f"{c}.dat" for c in classes}
    return total, off


def _values(path):
    with open(path) as fh:
        rows = [ln.split() for ln in fh if ln[0].isdigit() or ln[0] == "-"]
    return np.array([float(r[2]) for r in rows])


@pytest.mark.parametrize("case", ["static", "global", "dynamic", "manual"])
def test_aa_ordermaps_match_jax(aa_files, tmp_path, plans, case):
    """AA maps: a static z normal with auto spans (int16); global leaflets
    (int16 + the decoder's COG, upper and lower maps); dynamic normals
    with `plane: xy`; a manual span at 0.1 nm with min_samples 5."""
    kw = {}
    if case == "manual":
        params = _map(tmp_path, bin_size=[0.1, 0.1], min_samples=5)
        params.dim = (GridSpan.manual(2.0, 5.0), GridSpan.manual(3.0, 6.5))
        n_tiles = 31 * 36
    else:
        params = _map(tmp_path, bin_size=[0.25, 0.25],
                      **({"plane": "xy"} if case == "dynamic" else {}))
        n_tiles = 53 * 53                  # the 13 nm box at 0.25 nm
    if case == "global":
        kw["leaflets"] = LeafletClassification.global_("resname POPC",
                                                       P_HEADS)
    normal = (MembraneNormal.dynamic(P_HEADS, AA_RADIUS)
              if case == "dynamic" else MembraneNormal.static("z"))
    out = _run_both(_aa(aa_files, normal, map=params, **kw), tmp_path,
                    op_by_op=case in ("static", "manual"))
    assert _kind(plans[-1]) == ("s6g" if case == "global" else "s6")
    total, off = _check(out, n_tiles, ("full", "upper", "lower")
                        if case == "global" else ("full",))
    print(f"aa {case}: {total} tile lines, {off} off against jitted")
    if case == "manual":
        # min_samples 5 leaves tiles empty: NaN in both, as checked above
        assert np.isnan(_values(os.path.join(
            out["port"][1], "ordermap_average_full.dat"))).any()


def test_aa_ordermaps_on_the_xtc_wire_match_jax(aa_files, tmp_path, plans,
                                                monkeypatch):
    """The static AA map with the port alone forced onto its xtc wire (the
    records decoded by `ops/xtc.py`, on the CPU its plain version), which
    `gorder_tpu` lacks: op by op the YAML and every map file equal
    gorder_tpu's line for line, as on the host wires."""
    real = run_analysis

    def on_xtc(analysis, device):
        with monkeypatch.context() as m:
            m.setenv("GORDER_TPU_WIRE", "xtc")
            return real(analysis, device)

    monkeypatch.delenv("GORDER_TPU_WIRE", raising=False)
    monkeypatch.setattr(sys.modules[__name__], "run_analysis", on_xtc)
    out = _run_both(_aa(aa_files, MembraneNormal.static("z"),
                        map=_map(tmp_path, bin_size=[0.25, 0.25])),
                    tmp_path, op_by_op=True)
    assert _kind(plans[-1]) == "xtc"
    total, off = _check(out, 53 * 53)
    print(f"aa xtc: {total} tile lines, {off} off against jitted")


def test_cg_ordermaps_match_jax(tmp_path, plans):
    gro, bnd, xtc = make_flat_bilayer(tmp_path, n_frames=40)
    a = JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                    analysis_type=JaxAnalysisType.cgorder("resname POPC"),
                    map=_map(tmp_path), silent=True, overwrite=True)
    out = _run_both(a, tmp_path, op_by_op=True)
    assert _kind(plans[-1]) == "d8"
    total, off = _check(out, 81 * 81)  # the 8 nm box at the default 0.1 nm
    print(f"cg: {total} tile lines, {off} off against jitted")


def test_ua_ordermaps_match_jax(ua_files, tmp_path, plans):
    a = _ua(ua_files, MembraneNormal.static("z"),
            map=_map(tmp_path, bin_size=[0.25, 0.25]))
    out = _run_both(a, tmp_path)
    assert _kind(plans[-1]) == "s6"
    from tools import bench_modes

    n = int(np.floor(bench_modes.UA_BOX[0] / 0.25 + 0.5)) + 1
    total, off = _check(out, n * n)
    print(f"ua: {total} tile lines, {off} off against jitted")


def test_geometry_still_refused(aa_files, tmp_path, plans):
    """A map run with a geometry selection, refused once, now runs: a
    cylinder around the membrane's per-frame center, on s6 with the pair
    difference, its inside mask computed on the device. Op by op the
    YAML and every map file equal gorder_tpu's line for line; against the
    jitted engine the YAML is equal and at most 0.1 % of the tile lines
    differ (`_check`)."""
    from gorder_tpu.input.config import Geometry

    a = _aa(aa_files, MembraneNormal.static("z"),
            map=_map(tmp_path, bin_size=[0.25, 0.25]),
            geometry=Geometry("cylinder", reference="resname POPC",
                              radius=3.0, orientation="z"))
    out = _run_both(a, tmp_path, op_by_op=True)
    assert _kind(plans[-1]) == "s6"
    total, off = _check(out, 53 * 53)
    print(f"aa geometry map: {total} tile lines, {off} off against jitted")


def test_map_directory_backup_matches_jax(tmp_path):
    """Without `overwrite`, a second run backs the map directory (and the
    YAML) up as `gorder_tpu` does, and both write the same files again."""
    gro, bnd, xtc = make_flat_bilayer(tmp_path, n_frames=12)
    listings = {}
    for who in ("jax", "port"):
        root = tmp_path / who
        root.mkdir()
        a = JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                        analysis_type=JaxAnalysisType.cgorder(
                            "resname POPC"),
                        map=OrderMapParams.parse(
                            {"output_directory": str(root / "maps"),
                             "bin_size": 1.0}),
                        output_yaml=str(root / "order.yaml"), silent=True)
        for _ in range(2):
            (a.run() if who == "jax" else run_analysis(a, "cpu")).write()
        listings[who] = _files(root)
    assert listings["port"] == listings["jax"]
    assert any(n.startswith("#maps.1#") for n in listings["port"])
