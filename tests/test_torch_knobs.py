"""The environment knobs of `gorder_tpu` that the port reads where
`gorder_tpu` reads them (gorder_tpu_torch/engine/batches.py,
engine/channels.py), each set the same way for both packages on the CPU:
the port's batch count (its `on_batch` calls) against `ceil(frames /
gorder_tpu.engine.batches._effective_batch_size())`, the wire of its
"wire format" log line against `gorder_tpu.engine.batches._LAST_WIRE`,
and the YAML line for line.

- GORDER_TPU_BATCH_SIZE: frames a batch (default 128 on the CPU, 512 on
  the card).
- GORDER_TPU_B7_LEAFLETS=0: no leaflet channel class; a global-leaflet
  run leaves b7g and classifies against a center taken on the device, an
  `every 2` run leaves the b7 class plane.
- GORDER_TPU_GEO_CHANNEL=0: no geometry bitplane from the decoder; the
  step computes the inside mask from positions.
- GORDER_TPU_PREFETCH: the depth of the decode ring (results do not
  depend on it).
"""

import logging
import math

import pytest
import torch

from gorder_tpu.engine import batches as jax_batches
from gorder_tpu.input import Analysis as JaxAnalysis
from gorder_tpu.input import AnalysisType as JaxAnalysisType
from gorder_tpu.input.config import Frequency, Geometry, LeafletClassification
from gorder_tpu_torch.engine import batches
from gorder_tpu_torch.engine.drivers import run_analysis

from .synthetic import make_flat_bilayer
from .test_torch_leaflets import _lines

FRAMES = 150


@pytest.fixture(scope="module")
def cg_files(tmp_path_factory):
    return make_flat_bilayer(tmp_path_factory.mktemp("cg"), n_frames=FRAMES)


def _cg(files, out, **kw):
    gro, bnd, xtc = files
    return JaxAnalysis(structure=gro, bonds=bnd, trajectory=xtc,
                       analysis_type=JaxAnalysisType.cgorder("resname POPC"),
                       output_yaml=str(out), silent=True, overwrite=True,
                       **kw)


def _global():
    return LeafletClassification.global_("resname POPC", "name PO4")


def _both(files, tmp_path, caplog, **kw):
    """Run the same analysis on `gorder_tpu` and on the port (its default
    batch size) → (JAX wire, JAX batches, port wire, port kinds a batch)."""
    a = _cg(files, tmp_path / "jax.yaml", **kw)
    a.run().write()
    jax_wire = jax_batches._LAST_WIRE[0]
    jax_count = math.ceil(FRAMES / jax_batches._effective_batch_size())
    want = _lines(a.output_yaml)
    a.output_yaml = str(tmp_path / "port.yaml")
    kinds = []
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="gorder"):
        run_analysis(a, "cpu", on_batch=lambda db: kinds.append(db.kind)) \
            .write()
    wires = [r.getMessage().split()[2] for r in caplog.records
             if r.getMessage().startswith("wire format:")]
    assert len(wires) == 1
    assert _lines(a.output_yaml) == want
    return jax_wire, jax_count, wires[0], kinds


def test_default_batch_size(monkeypatch):
    monkeypatch.delenv("GORDER_TPU_BATCH_SIZE", raising=False)
    assert batches.default_batch_size("cpu") == 128
    assert batches.default_batch_size(torch.device("cuda")) == 512
    assert batches.default_batch_size("cuda:1") == 512
    monkeypatch.setenv("GORDER_TPU_BATCH_SIZE", "96")
    assert batches.default_batch_size("cpu") == 96
    assert batches.default_batch_size("cuda") == 96


@pytest.mark.parametrize("size", ["", "32", "150", "200"])
def test_batch_size_matches_jax(cg_files, tmp_path, monkeypatch, caplog,
                                size):
    if size:
        monkeypatch.setenv("GORDER_TPU_BATCH_SIZE", size)
    else:
        monkeypatch.delenv("GORDER_TPU_BATCH_SIZE", raising=False)
    jax_wire, jax_count, wire, kinds = _both(cg_files, tmp_path, caplog)
    assert len(kinds) == jax_count == math.ceil(FRAMES / int(size or 128))
    assert wire == jax_wire


@pytest.mark.parametrize("case", ["global", "every2"])
def test_b7_leaflets_off_matches_jax(cg_files, tmp_path, monkeypatch,
                                     caplog, case):
    """With b7 forced, the leaflet run rides b7g (or the class plane,
    b7m); with GORDER_TPU_B7_LEAFLETS=0 neither package can, and both
    ride the same coordinate wire, with no decoder COG."""
    leaflets = (_global() if case == "global"
                else _global().with_frequency(Frequency.every(2)))
    monkeypatch.setenv("GORDER_TPU_WIRE", "b7")
    _, _, wire, kinds = _both(cg_files, tmp_path, caplog, leaflets=leaflets)
    assert wire == "b7"
    assert set(kinds) == {"b7g" if case == "global" else "b7m"}
    monkeypatch.setenv("GORDER_TPU_B7_LEAFLETS", "0")
    jax_wire, jax_count, wire, kinds = _both(cg_files, tmp_path, caplog,
                                             leaflets=leaflets)
    assert wire == jax_wire != "b7"
    assert set(kinds) == {wire} and len(kinds) == jax_count


def test_b7_leaflets_off_without_forcing_matches_jax(cg_files, tmp_path,
                                                     monkeypatch, caplog):
    """The pick alone: every-frame global leaflets keep the decoder's COG
    on a coordinate wire (`*g`) by default, and lose it with the knob."""
    _, _, wire, kinds = _both(cg_files, tmp_path, caplog,
                              leaflets=_global())
    assert set(kinds) == {"b7g" if wire == "b7" else wire + "g"}
    monkeypatch.setenv("GORDER_TPU_B7_LEAFLETS", "0")
    jax_wire, jax_count, wire, kinds = _both(cg_files, tmp_path, caplog,
                                             leaflets=_global())
    assert wire == jax_wire and set(kinds) == {wire}
    assert len(kinds) == jax_count


def test_geo_channel_off_matches_jax(cg_files, tmp_path, monkeypatch,
                                     caplog):
    geometry = Geometry("cylinder", reference=(4.0, 4.0, 4.0), radius=2.0,
                        span=(-1.0, 1.0), orientation="z")
    monkeypatch.setenv("GORDER_TPU_WIRE", "b7")
    _, _, _, kinds = _both(cg_files, tmp_path, caplog, geometry=geometry)
    assert set(kinds) == {"b7geo"}
    monkeypatch.setenv("GORDER_TPU_GEO_CHANNEL", "0")
    jax_wire, jax_count, wire, kinds = _both(cg_files, tmp_path, caplog,
                                             geometry=geometry)
    assert wire == jax_wire != "b7"
    assert set(kinds) == {wire} and len(kinds) == jax_count


@pytest.mark.parametrize("depth", ["2", "3", "9"])
def test_prefetch_matches_jax(cg_files, tmp_path, monkeypatch, caplog,
                              depth):
    monkeypatch.setenv("GORDER_TPU_PREFETCH", depth)
    monkeypatch.setenv("GORDER_TPU_BATCH_SIZE", "16")
    jax_wire, jax_count, wire, kinds = _both(cg_files, tmp_path, caplog)
    assert wire == jax_wire and len(kinds) == jax_count == 10


@pytest.mark.parametrize("env, n_batches, depth", [
    (None, 10, 4), ("2", 10, 2), ("1", 10, 2), ("9", 10, 9), ("9", 3, 3),
    (None, 1, 2)])
def test_prefetch_depth(monkeypatch, env, n_batches, depth):
    """max(2, GORDER_TPU_PREFETCH or 4), at most the batches (but 2):
    gorder_tpu/engine/batches.py:233-234."""
    if env is None:
        monkeypatch.delenv("GORDER_TPU_PREFETCH", raising=False)
    else:
        monkeypatch.setenv("GORDER_TPU_PREFETCH", env)
    assert batches.prefetch_depth(n_batches) == depth
