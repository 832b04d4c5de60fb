"""Frame data parallelism in the port (gorder_tpu_torch/parallel/mesh.py,
parallel/context.py, engine/batches.py) on the CPU: `visible_devices`
gives 2 or 4 copies of the CPU, so that every batch is split into that
many frame slices, each run by its own step with its own replicas and map
state, as the JAX package's tests split batches over 8 XLA host devices.

- `activate` gives the device count of `gorder_tpu.parallel.context
  .activate` for every `GORDER_TPU_MESH` and batch size of a grid.
- Runs split over 2 and 4 devices write the single-device run's YAML (and
  map files) byte for byte, and `gorder_tpu`'s: AA on b7, a d8 run (each
  slice decodes on top of the slice before it), UA, an ordermap, `every
  2` leaflets (classes carried between frames), dynamic normals, a
  geometry selection, and `run_partial` + `merge`. Dynamic normals agree
  with `gorder_tpu`'s to float noise only (tests/test_torch_normals_
  pipeline.py), so that YAML is held to `bench.validate_output`'s rule
  against it, and byte for byte to the port's single-device run.
- `on_batch` sees one `DeviceBatch` a slice, and each slice's output is
  the plain step's on that slice alone.
"""

import contextlib
import logging
import os

import jax
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from gorder_tpu.input import Analysis as JaxAnalysis
from gorder_tpu.input import AnalysisType as JaxAnalysisType
from gorder_tpu.input.config import (Frequency, Geometry,
                                     LeafletClassification, MembraneNormal,
                                     OrderMapParams)
from gorder_tpu.parallel import context as jax_context
from gorder_tpu_torch.engine import drivers
from gorder_tpu_torch.engine.drivers import run_analysis
from gorder_tpu_torch.input import config as port_config
from gorder_tpu_torch.ops import p2
from gorder_tpu_torch.parallel import context, mesh

from .synthetic import make_flat_bilayer
from .test_torch_leaflets import _lines

BATCH = 16            # 40 frames: batches of 16, 16 and a padded 8
CPU = torch.device("cpu")


def _cpus(n):
    return lambda device: [CPU] * n


@pytest.mark.parametrize("env", ["", "0", "3", "5", "16"])
@pytest.mark.parametrize("batch_size", [96, 100, 128])
def test_activate_matches_jax(monkeypatch, env, batch_size):
    """8 visible devices on both sides: the count `GORDER_TPU_MESH` caps,
    clipped to a divisor of the batch size, one device giving None."""
    assert len(jax.devices()) == 8
    monkeypatch.setenv("GORDER_TPU_MESH", env)
    monkeypatch.setattr(context, "visible_devices", _cpus(8))
    want = jax_context.activate(batch_size)
    jax_context.deactivate()
    got = context.activate(batch_size, "cpu")
    try:
        assert context.active_mesh() is got
        if want is None:
            assert got is None
        else:
            assert got.size == want.devices.size
            assert got.devices == (CPU,) * got.size
    finally:
        context.deactivate()
    assert context.active_mesh() is None


def test_visible_devices():
    assert context.visible_devices("cpu") == [CPU]
    assert context.visible_devices("cuda:1") == [torch.device("cuda", 1)]
    assert context.visible_devices("cuda") == [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_shard_batch_and_replicate():
    m = mesh.frame_mesh([CPU] * 4)
    a = np.arange(24, dtype=np.int32).reshape(8, 3)
    parts, again = mesh.shard_batch(m, a, torch.as_tensor(a))
    assert [p.shape[0] for p in parts] == [2] * 4
    assert torch.equal(mesh.gather(parts), torch.as_tensor(a))
    assert torch.equal(mesh.gather(again), torch.as_tensor(a))
    copies = mesh.replicate(m, a)
    assert len(copies) == 4 and all(torch.equal(c, torch.as_tensor(a))
                                    for c in copies)
    a[:] = 0                      # the copies no longer read the array
    assert int(mesh.gather(parts).sum()) == 24 * 23 // 2
    with pytest.raises(ValueError, match="do not split evenly"):
        mesh.shard_batch(m, np.zeros(6))
    r = mesh.Replicas(torch.arange(5))
    assert r.on("cpu") is r.on(CPU) and len(r) == 5


# --- runs over a mesh --------------------------------------------------------


@pytest.fixture(scope="module")
def cg_files(tmp_path_factory):
    return make_flat_bilayer(tmp_path_factory.mktemp("cg"), n_frames=40)


@pytest.fixture(scope="module")
def aa_files(tmp_path_factory):
    """A cut of bench.py's AA membrane: 4 lipids, 40 frames."""
    d = str(tmp_path_factory.mktemp("aa"))
    gro, bnd, system = chip_smoke.synthesize_structure(
        d, n_lipids=4, total_atoms=4 * 134 + 60)
    return gro, bnd, chip_smoke.synthesize_trajectory(d, system, 40)


@pytest.fixture(scope="module")
def ua_files(tmp_path_factory):
    """A cut of tools/bench_modes.py's UA membrane: 6 lipids, 40 frames."""
    return chip_smoke.synthesize_ua(str(tmp_path_factory.mktemp("ua")), 40,
                                    n_lipids=6, total_atoms=6 * 51 + 90)


def _analysis(case, files, out):
    """gorder_tpu's Analysis of `case` (the port reads it by attribute)."""
    gro, bnd, xtc = files
    kw = dict(structure=gro, bonds=bnd, trajectory=xtc, output_yaml=out,
              silent=True, overwrite=True)
    if case == "ua":
        port = chip_smoke.ua_analysis("ua", gro, bnd, xtc)
        at = port.analysis_type
        return JaxAnalysis(analysis_type=JaxAnalysisType.uaorder(
            saturated=at.saturated, unsaturated=at.unsaturated), **kw)
    if case in ("aa", "aa-d8"):
        return JaxAnalysis(analysis_type=JaxAnalysisType.aaorder(
            chip_smoke.HEAVY, chip_smoke.HYDROGENS), **kw)
    cg = JaxAnalysisType.cgorder("resname POPC")
    if case == "cg-ordermap":
        kw["map"] = OrderMapParams.parse({
            "bin_size": [1.0, 1.0], "min_samples": 5,
            "output_directory": out[:-len(".yaml")] + "_maps"})
    elif case == "cg-every2":
        kw["leaflets"] = LeafletClassification.global_(
            "resname POPC", "name PO4").with_frequency(Frequency.every(2))
    elif case == "cg-dynamic":
        kw["membrane_normal"] = MembraneNormal.dynamic(
            "resname POPC and name PO4", 2.0)
    elif case == "cg-geometry":
        kw["geometry"] = Geometry("cylinder", reference=(4.0, 4.0, 4.0),
                                  radius=2.0, span=(-1.0, 1.0),
                                  orientation="z")
    return JaxAnalysis(analysis_type=cg, **kw)


#: case → (files fixture, GORDER_TPU_WIRE, the wire kind every batch
#: rides); b7 is forced, since with batches this short the bytes policy
#: prefers d8
CASES = {
    "aa": ("aa_files", "b7", "b7"),
    "aa-d8": ("aa_files", "d8", "d8"),
    "ua": ("ua_files", "", None),
    "cg-ordermap": ("cg_files", "", None),
    "cg-every2": ("cg_files", "b7", "b7m"),
    "cg-dynamic": ("cg_files", "b7", "b7x"),
    "cg-geometry": ("cg_files", "b7", "b7geo"),
}


def _tree(directory):
    """{relative path: its non-`#` lines} of every file of a map
    directory."""
    return {os.path.relpath(os.path.join(root, name), directory):
            _lines(os.path.join(root, name))
            for root, _, names in os.walk(directory) for name in names}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """gorder_tpu's YAML of each case, computed once."""
    d = tmp_path_factory.mktemp("jax")
    cache = {}

    def get(case, files):
        if case not in cache:
            wire = CASES[case][1]
            old = os.environ.pop("GORDER_TPU_WIRE", None)
            if wire:
                os.environ["GORDER_TPU_WIRE"] = wire
            try:
                a = _analysis(case, files, str(d / f"{case}.yaml"))
                # op by op, a map's tiles are the port's exactly
                # (tests/test_torch_ordermap_pipeline.py)
                with (jax.disable_jit() if a.map is not None
                      else contextlib.nullcontext()):
                    a.run().write()
            finally:
                os.environ.pop("GORDER_TPU_WIRE", None)
                if old is not None:
                    os.environ["GORDER_TPU_WIRE"] = old
            cache[case] = a
        return cache[case]

    return get


def _port(case, files, out, monkeypatch, n_devices, caplog):
    """The port's run of `case` over `n_devices` copies of the CPU →
    (YAML path, [(batch, slice)] as `on_batch` saw them)."""
    monkeypatch.setattr(context, "visible_devices", _cpus(n_devices))
    a = _analysis(case, files, out)
    seen = []
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="gorder"):
        run_analysis(a, "cpu", batch_size=BATCH,
                     on_batch=lambda db: seen.append(db)).write()
    parallel = [r.getMessage() for r in caplog.records
                if r.getMessage().startswith("data-parallel")]
    if n_devices > 1:
        assert parallel == [f"data-parallel over {n_devices} devices "
                            f"('frames' mesh)"]
    else:
        assert parallel == []
    assert context.active_mesh() is None
    return a, seen


@pytest.mark.parametrize("n_devices", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_run_matches_single_and_jax(request, tmp_path, monkeypatch,
                                         caplog, jax_runs, case, n_devices):
    name, wire, kind = CASES[case]
    files = request.getfixturevalue(name)
    if wire:
        monkeypatch.setenv("GORDER_TPU_WIRE", wire)
    single, _ = _port(case, files, str(tmp_path / "single.yaml"),
                      monkeypatch, 1, caplog)
    meshed, seen = _port(case, files, str(tmp_path / "mesh.yaml"),
                         monkeypatch, n_devices, caplog)
    with open(single.output_yaml) as a, open(meshed.output_yaml) as b:
        assert b.read() == a.read()
    jax_run = jax_runs(case, files)
    jax_yaml = jax_run.output_yaml
    if case == "cg-dynamic":
        golden = tmp_path / "golden"
        golden.mkdir()
        (golden / "run_40.yaml").write_text(open(jax_yaml).read())
        monkeypatch.setattr(bench, "GOLDEN_DIR", str(golden))
        assert bench.validate_output(meshed.output_yaml, "run", 40) \
            is not None
    else:
        assert _lines(meshed.output_yaml) == _lines(jax_yaml)
    if case == "cg-ordermap":
        maps = _tree(meshed.map.output_directory)
        assert maps == _tree(single.map.output_directory) and len(maps) > 3
        assert maps == _tree(jax_run.map.output_directory)
    # one DeviceBatch a slice, each of BATCH / n frames
    assert [(db.index, db.shard) for db in seen] == [
        (b, i) for b in range(3) for i in range(n_devices)]
    assert all(db.mask.shape[0] == BATCH // n_devices for db in seen)
    if kind is not None:
        assert {db.kind for db in seen} == {kind}


@pytest.mark.parametrize("n_devices", [2, 4])
def test_each_slice_is_its_plain_step(aa_files, tmp_path, monkeypatch,
                                      caplog, n_devices):
    """Each slice's output is the plain P2 step's on that slice's wire
    alone: the d8 slices decode on top of the slice before them."""
    monkeypatch.setenv("GORDER_TPU_WIRE", "d8")
    _, seen = _port("aa-d8", aa_files, str(tmp_path / "mesh.yaml"),
                    monkeypatch, n_devices, caplog)
    _, whole = _port("aa-d8", aa_files, str(tmp_path / "single.yaml"),
                     monkeypatch, 1, caplog)
    from gorder_tpu_torch.engine.fused import decode_positions

    for b, batch in enumerate(whole):
        slices = [db for db in seen if db.index == b]
        coords = [decode_positions(db.kind, db.wire, 0) for db in slices]
        assert torch.equal(torch.cat(coords),
                           decode_positions(batch.kind, batch.wire, 0))
        for db, q in zip(slices, coords):
            step = db.step
            want = p2.p2_positions_plain(
                q, step.atom_a, step.atom_b, db.scale, db.box, db.normal,
                db.mask, step.bond_type, step.n_types,
                handle_pbc=step.handle_pbc)
            assert torch.equal(db.out, want)
        assert torch.equal(torch.cat([db.out for db in slices]), batch.out)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_partial_runs_merge_under_a_mesh(cg_files, tmp_path, monkeypatch,
                                         jax_runs, n_devices):
    """`run_partial` activates the mesh as `run` does; merged, the shards
    write the single run's YAML and gorder_tpu's."""
    monkeypatch.setattr(context, "visible_devices", _cpus(n_devices))
    monkeypatch.setattr(drivers, "default_batch_size", lambda device: 8)
    gro, bnd, xtc = cg_files
    leaflets = port_config.LeafletClassification.global_(
        "resname POPC", "name PO4").with_frequency(
            port_config.Frequency.every(2))
    port = port_config.Analysis(
        structure=gro, bonds=bnd, trajectory=xtc,
        analysis_type=port_config.AnalysisType.cgorder("resname POPC"),
        leaflets=leaflets, output_yaml=str(tmp_path / "merged.yaml"),
        silent=True, overwrite=True)
    states = [port.run_partial(i, 3, device="cpu") for i in range(3)]
    port.merge(states).write()
    assert _lines(port.output_yaml) == _lines(
        jax_runs("cg-every2", cg_files).output_yaml)
