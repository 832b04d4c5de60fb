"""The generator's integers go through the frozen encoder and come back
from the port's XTC reader exactly, with their boxes, times and steps;
a seed's inputs are cached and a new seed replaces them."""

import numpy as np
import pytest
import torch
from conftest import tiny_cell

from benchmark import synth


@pytest.mark.parametrize("name", ["aa-static", "ves-dynamic"])
def test_integers_round_trip(name, cache):
    from gorder_tpu_torch.io import native

    cell = tiny_cell(name)
    seed = 2 ** 31 + 99
    system, files, made = synth.prepare_inputs(
        cell.config, cell.config_bytes, seed, "cpu", cache)
    assert made
    ints = torch.cat([c for _, c in synth.trajectory_chunks(
        system, seed)]).numpy()
    assert ints.shape == (cell.config["n_frames"], system.n_atoms, 3)
    scan = native.xtc_scan(str(files["trajectory"]))
    coords, boxes, times, steps = native.xtc_decode(
        str(files["trajectory"]), scan["offsets"], system.n_atoms)
    assert np.array_equal(np.rint(coords.astype(np.float64) * 1000), ints)
    assert np.allclose(boxes[:, [0, 1, 2], [0, 1, 2]],
                       cell.config["box_nm"])
    frames = np.arange(cell.config["n_frames"])
    assert np.array_equal(times, frames * 10.0)
    assert np.array_equal(steps, frames * 100)


def test_cache_reuse_and_replace(cache):
    cell = tiny_cell("aa-static")
    args = (cell.config, cell.config_bytes)
    _, files, made = synth.prepare_inputs(*args, 5, "cpu", cache)
    first = files["trajectory"].read_bytes()
    _, _, again = synth.prepare_inputs(*args, 5, "cpu", cache)
    assert made and not again
    _, files, other = synth.prepare_inputs(*args, 6, "cpu", cache)
    assert other and files["trajectory"].read_bytes() != first
    assert sorted(p.name for p in files["trajectory"].parent.iterdir()) == [
        "bonds.bnd", "stamp.json", "structure.gro", "traj.xtc"]


def test_prefix_holds_the_same_integers(monkeypatch):
    monkeypatch.setattr(synth, "CHUNK_BYTES", 5 * 1500 * 12)
    cell = tiny_cell("aa-static")
    system = synth.make_system(cell.config, 3, "cpu")
    whole = torch.cat([c for _, c in synth.trajectory_chunks(system, 3)])
    part = torch.cat([c for _, c in synth.trajectory_chunks(system, 3,
                                                             n_frames=13)])
    assert synth.frames_per_chunk(system) == 5
    assert torch.equal(whole[:13], part)


def test_same_seed_same_integers():
    cell = tiny_cell("ves-dynamic")
    a = synth.make_system(cell.config, 11, "cpu")
    b = synth.make_system(cell.config, 11, "cpu")
    assert torch.equal(a.positions, b.positions)
    ia = next(synth.trajectory_chunks(a, 11))[1]
    ib = next(synth.trajectory_chunks(b, 11))[1]
    ic = next(synth.trajectory_chunks(b, 12))[1]
    assert torch.equal(ia, ib) and not torch.equal(ia, ic)


@pytest.mark.parametrize("name", ["aa-static", "ves-dynamic"])
def test_water_stays_out_of_the_membrane(name):
    cell = tiny_cell(name)
    cfg = cell.config
    system = synth.make_system(cfg, 2 ** 31 + 13, "cpu")
    water = [i for i, r in enumerate(system.resnames)
             if r == cfg["water_resname"]]
    per = len(cfg["water_names"])
    assert len(water) == (cfg["total_atoms"] - (system.n_atoms
                                                - len(water))) // per * per
    sites = system.positions[torch.as_tensor(water[::per])].double()
    centre = torch.tensor(cfg["box_nm"], dtype=torch.float64) / 2
    if cfg["system"] == "bilayer":
        assert ((sites[:, 2] - centre[2]).abs()
                >= cfg["water_free_half_nm"] - 1e-6).all()
    else:
        r = torch.linalg.vector_norm(sites - centre, dim=1)
        lo, hi = cfg["water_free_shell_nm"]
        assert ((r <= lo + 1e-6) | (r >= hi - 1e-6)).all()
        assert (r < lo).any() and (r >= hi).any()
