"""Sharded runs in the port: `Analysis.run_partial` over contiguous frame
blocks and `Analysis.merge` (gorder_tpu_torch/engine/drivers.py) on the
CPU. The merged output must equal the single run's byte for byte, as in
tests/test_sharding.py, whose fixtures need the reference corpus; here on
tests/synthetic.py's flat bilayer, tools/bench_modes.py's clustering
bilayer and its UA lipid, cut small. The partial state is `gorder_tpu`'s:
states of the two packages merge with each other, in both directions.
"""

import os

import numpy as np
import pytest

import chip_smoke
from gorder_tpu.input import Analysis as JaxAnalysis
from gorder_tpu.input import AnalysisType as JaxAnalysisType
from gorder_tpu.parallel.shard import load_partial as jax_load_partial
from gorder_tpu.parallel.shard import save_partial as jax_save_partial
from gorder_tpu_torch.engine.drivers import run_analysis_partial
from gorder_tpu_torch.errors import AnalysisError
from gorder_tpu_torch.input.config import (
    Analysis,
    AnalysisType,
    Collect,
    EstimateError,
    Frequency,
    LeafletClassification,
    MembraneNormal,
    OrderMapParams,
)
from gorder_tpu_torch.parallel.shard import (
    expand_partial_paths,
    load_partial,
    save_partial,
)
from gorder_tpu_torch.present import write_yaml
from tools import bench_modes

from .synthetic import make_flat_bilayer
from .test_torch_clustering_pipeline import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def cg_files(tmp_path_factory):
    return make_flat_bilayer(tmp_path_factory.mktemp("cg"), n_frames=40)


@pytest.fixture(scope="module")
def aab_files(tmp_path_factory):
    """A cut of the clustering benchmark's bilayer: 16 lipids, 600 frames."""
    return chip_smoke.synthesize_aab(
        str(tmp_path_factory.mktemp("aab")), 600, n_mols=16,
        total_atoms=16 * 134 + 300, box=(3.2, 3.2, 11.0))


@pytest.fixture(scope="module")
def ua_files(tmp_path_factory):
    return chip_smoke.synthesize(
        str(tmp_path_factory.mktemp("ua")), "ua", bench_modes._ua_template,
        90, 12, 12 * 51 + 90, (3.2, 3.2, 9.0), 29, ["OW", "HW1", "HW2"],
        z_offset=2.0, chains_inward=True)


def cg(files, cls=Analysis, atype=AnalysisType, **kw):
    gro, bnd, xtc = files
    return cls(structure=gro, bonds=bnd, trajectory=xtc,
               analysis_type=atype.cgorder("resname POPC"), silent=True,
               overwrite=True, **kw)


def _yaml(results, path):
    write_yaml(results, str(path))
    with open(path) as fh:
        return fh.read()


def _assert_merge_identical(analysis, tmp_path, n_shards, tag,
                            roundtrip_disk=False):
    direct = analysis.run(device="cpu")
    states = []
    for i in range(n_shards):
        state = analysis.run_partial(i, n_shards, device="cpu")
        if roundtrip_disk:
            path = str(tmp_path / f"part_{tag}_{i}.npz")
            save_partial(path, state)
            state = load_partial(path)
        states.append(state)
    merged = analysis.merge(states[::-1])      # any order
    assert _yaml(merged, tmp_path / f"merged_{tag}.yaml") == _yaml(
        direct, tmp_path / f"direct_{tag}.yaml"), tag
    return direct, merged


def test_shard_merge_basic(cg_files, tmp_path):
    """Three shards through disk, and the same shards in memory."""
    _assert_merge_identical(cg(cg_files), tmp_path, 3, "disk",
                            roundtrip_disk=True)
    _assert_merge_identical(cg(cg_files), tmp_path, 3, "memory")


def test_shard_blocks_cover_the_run(cg_files):
    states = [cg(cg_files).run_partial(i, 3, device="cpu")
              for i in range(3)]
    assert [s["shard_start"] for s in states] == [0, 14, 28]
    assert [s["n_shard_frames"] for s in states] == [14, 14, 12]


def test_shard_merge_leaflets_every_collect(cg_files, tmp_path):
    leaflets = LeafletClassification.global_("resname POPC", "name PO4")
    leaflets.with_frequency(Frequency.every(4))
    leaflets.with_collect(Collect(True, None))
    direct, merged = _assert_merge_identical(
        cg(cg_files, leaflets=leaflets), tmp_path, 3, "leaflets")
    np.testing.assert_array_equal(direct.leaflets_for_molecule("POPC"),
                                  merged.leaflets_for_molecule("POPC"))


def test_shard_merge_leaflets_once_clustering(cg_files, tmp_path):
    """Once-frequency clustering: shards 1-3 bootstrap from global frame
    0."""
    leaflets = LeafletClassification.clustering("name PO4")
    leaflets.with_frequency(Frequency.once())
    leaflets.with_collect(Collect(True, None))
    direct, merged = _assert_merge_identical(
        cg(cg_files, leaflets=leaflets), tmp_path, 4, "clustering_once")
    np.testing.assert_array_equal(direct.leaflets_for_molecule("POPC"),
                                  merged.leaflets_for_molecule("POPC"))


@pytest.mark.parametrize("method", ["clustering", "spherical"])
def test_shard_merge_every_frame_clustering(aab_files, tmp_path, method):
    """Every-frame spectral clustering in 2 shards: shard 1 orients its
    clusters against global frame 0's; spherical likewise."""
    gro, bnd, xtc = aab_files
    leaflets = getattr(LeafletClassification, method)(
        "resname POPC and name P").with_collect(True)
    analysis = Analysis(structure=gro, bonds=bnd, trajectory=xtc,
                        analysis_type=AnalysisType.aaorder(
                            chip_smoke.HEAVY, chip_smoke.HYDROGENS),
                        leaflets=leaflets, silent=True, overwrite=True)
    direct, merged = _assert_merge_identical(analysis, tmp_path, 2, method)
    np.testing.assert_array_equal(direct.leaflets_for_molecule("POPC"),
                                  merged.leaflets_for_molecule("POPC"))


def test_shard_merge_error_estimation(cg_files, tmp_path):
    """The timewise series join in global frame order."""
    _assert_merge_identical(cg(cg_files, estimate_error=EstimateError()),
                            tmp_path, 3, "errors")


def test_shard_merge_ordermaps(cg_files, tmp_path):
    analysis = cg(cg_files, map=OrderMapParams.parse({
        "bin_size": [1.0, 1.0], "output_directory": str(tmp_path / "maps"),
        "min_samples": 10}))
    direct, merged = _assert_merge_identical(analysis, tmp_path, 3, "maps")
    for cls in direct.average_maps:
        np.testing.assert_array_equal(direct.average_maps[cls],
                                      merged.average_maps[cls])


def test_shard_merge_dynamic_normals(cg_files, tmp_path):
    analysis = cg(cg_files, membrane_normal=MembraneNormal.dynamic(
        "name PO4", 2.0, Collect(True, None)))
    direct, merged = _assert_merge_identical(analysis, tmp_path, 2,
                                             "normals")
    np.testing.assert_array_equal(direct.normals_for_molecule("POPC"),
                                  merged.normals_for_molecule("POPC"))


def test_shard_merge_ua(ua_files, tmp_path):
    analysis = chip_smoke.ua_analysis("ua", *ua_files)
    _assert_merge_identical(analysis, tmp_path, 3, "ua")


def test_merge_rejects_incomplete_coverage(cg_files):
    analysis = cg(cg_files)
    s0 = analysis.run_partial(0, 3, device="cpu")
    with pytest.raises(AnalysisError, match="missing or duplicated") as err:
        analysis.merge([s0])
    with pytest.raises(Exception) as jax_err:
        cg(cg_files, cls=JaxAnalysis, atype=JaxAnalysisType).merge([s0])
    assert str(err.value) == str(jax_err.value)


def test_merge_rejects_mismatched_fingerprint(cg_files):
    states = [cg(cg_files).run_partial(i, 2, device="cpu")
              for i in range(2)]
    with pytest.raises(AnalysisError, match="does not match") as err:
        cg(cg_files, step=5).merge(states)
    with pytest.raises(Exception) as jax_err:
        cg(cg_files, cls=JaxAnalysis, atype=JaxAnalysisType,
           step=5).merge(states)
    assert str(err.value) == str(jax_err.value)


def test_invalid_shard_and_missing_files_are_refused(cg_files, tmp_path):
    with pytest.raises(AnalysisError, match="invalid shard 3/3"):
        run_analysis_partial(cg(cg_files), 3, 3, "cpu")
    with pytest.raises(AnalysisError, match="could not load partial"):
        load_partial(str(tmp_path / "none.npz"))
    with pytest.raises(AnalysisError, match="no partial states match"):
        expand_partial_paths([str(tmp_path / "part*.npz")])


@pytest.mark.parametrize("kw", [
    {}, {"estimate_error": EstimateError()},
    {"map": "maps"},
    {"leaflets": "clustering_once"}], ids=["basic", "errors", "maps",
                                           "clustering_once"])
def test_states_of_both_packages_merge(cg_files, tmp_path, kw):
    """Shards 0 and 2 from one package, shard 1 from the other, through
    each package's files, merged by each package: the single run's YAML
    (every line but the header, which names the package) both ways."""
    from gorder_tpu.input import (EstimateError as JaxEstimateError,
                                  Frequency as JaxFrequency,
                                  LeafletClassification as JaxLeaflets,
                                  OrderMapParams as JaxOrderMapParams)

    def build(cls, atype, err, maps, leaflets, freq, out):
        opts = {}
        if "estimate_error" in kw:
            opts["estimate_error"] = err()
        if "map" in kw:
            opts["map"] = maps.parse({
                "bin_size": [1.0, 1.0], "min_samples": 10,
                "output_directory": str(tmp_path / f"maps_{out}")})
        if "leaflets" in kw:
            opts["leaflets"] = leaflets.clustering("name PO4") \
                .with_frequency(freq.once())
        return cg(cg_files, cls=cls, atype=atype,
                  output_yaml=str(tmp_path / f"{out}.yaml"), **opts)

    def port(out):
        return build(Analysis, AnalysisType, EstimateError, OrderMapParams,
                     LeafletClassification, Frequency, out)

    def jax(out):
        return build(JaxAnalysis, JaxAnalysisType, JaxEstimateError,
                     JaxOrderMapParams, JaxLeaflets, JaxFrequency, out)

    single = port("single")
    single.run(device="cpu").write()

    def lines(path):
        with open(path) as fh:
            return [ln for ln in fh.read().splitlines()
                    if not ln.startswith("#")]

    want = lines(tmp_path / "single.yaml")
    for mine, theirs, save, load in (
            (port, jax, jax_save_partial, load_partial),
            (jax, port, save_partial, jax_load_partial)):
        a, b = mine("a"), theirs("b")
        paths = []
        for i in range(3):
            if i == 1:
                state = (b.run_partial(i, 3) if b.__class__ is JaxAnalysis
                         else b.run_partial(i, 3, device="cpu"))
            else:
                state = (a.run_partial(i, 3) if a.__class__ is JaxAnalysis
                         else a.run_partial(i, 3, device="cpu"))
            paths.append(str(tmp_path / f"{mine.__name__}_{i}.npz"))
            save(paths[-1], state)
        merger = mine(f"merged_{mine.__name__}")
        merger.merge([load(p) for p in paths]).write()
        assert lines(merger.output_yaml) == want, mine.__name__
        for p in paths:
            os.remove(p)
