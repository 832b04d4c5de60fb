"""The benchmark's inputs, made from the seed on the device.

A configuration (`benchmark/configs/<name>.json`) describes a membrane
system: a lipid template laid out as a bilayer on a grid or as a vesicle
of two shells, water to a total atom count, uniform in the box outside
the membrane (`water_free_half_nm` about a bilayer's midplane,
`water_free_shell_nm` about a vesicle's centre), and a trajectory of
per-molecule drift (an AR(1) walk) plus per-atom jitter around the
structure, wrapped into the box. Everything random is drawn with a
`torch.Generator` on the device from the seed: the structure from
2·seed, the trajectory from 2·seed + 1. Coordinates are rounded on the
device to the XTC grid (`precision` integers a nm), and those integers are
what the encoder writes and what the reference reads: the same seed gives
the same integers.
The lipid template is found by name: a configuration's `template` is
`benchmark/templates/<template with "-" as "_">.py` (`cells.template_part`).

`prepare_inputs` writes the structure (GRO), the bonds (one `a b` pair a
line, 1-based) and the trajectory (XTC) into the configuration's cache
directory, or reuses them when they were made from the same seed, the
same generator sources and the same template file. One trajectory per
configuration lives there; a new seed replaces it.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import math
import os
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import cells, xtc

HERE = Path(__file__).resolve().parent
CACHE_DIR = HERE / "_cache"
#: bytes of one chunk's coordinates on the device
CHUNK_BYTES = 256 << 20
#: how far a random-walk step leans along its chain's direction before it
#: is scaled to the step length
CHAIN_BIAS = 1.2
#: the sources whose change makes a cached trajectory stale, beside the
#: configuration's own template file
_SOURCES = ("synth.py", "xtc_encode.cpp")


@dataclass
class System:
    """A configuration's structure: per atom its name, residue name,
    1-based residue number and 0-based molecule; the bonds (0-based pairs,
    a < b); the f32 positions on the device; the box lengths (nm)."""

    names: list
    resnames: list
    resids: np.ndarray
    molecule: np.ndarray
    n_molecules: int
    bonds: np.ndarray
    positions: torch.Tensor
    box: np.ndarray
    config: dict

    @property
    def n_atoms(self) -> int:
        return len(self.names)


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                    keepdim=True), min=1e-6)


def _bilayer_heads(cfg, device):
    """(n, 3) first-atom positions on a square grid of each leaflet and
    (n, 3) chain directions: leaflets alternate, heads `head_offset_nm`
    from the box's midplane, chains outward or (`chains_inward`) inward."""
    n = cfg["n_lipids"]
    box = cfg["box_nm"]
    grid = int(math.ceil(math.sqrt(n / 2)))
    spacing = box[0] / grid
    m = torch.arange(n, device=device)
    cell = m // 2
    sign = torch.where(m % 2 == 0, 1.0, -1.0).to(device)
    heads = torch.stack([((cell % grid) + 0.5) * spacing,
                         (((cell // grid) % grid) + 0.5) * spacing,
                         box[2] / 2 + sign * cfg["head_offset_nm"]], dim=1)
    z_dir = -sign if cfg["chains_inward"] else sign
    chain = torch.zeros((n, 3), device=device)
    chain[:, 2] = z_dir
    return heads.float(), chain, False


def _fibonacci_shell(n, radius, center, device):
    i = torch.arange(n, dtype=torch.float64, device=device)
    z = 1.0 - 2.0 * (i + 0.5) / n
    r = torch.sqrt(1.0 - z * z)
    theta = math.pi * (3.0 - math.sqrt(5.0)) * i
    unit = torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], 1)
    return center + radius * unit, unit


def _vesicle_heads(cfg, device):
    """Heads on two Fibonacci shells around the box centre; chains point
    inward on the outer shell and outward on the inner one; a molecule's
    first bead sits on its shell."""
    center = torch.tensor(cfg["box_nm"], dtype=torch.float64,
                          device=device) / 2
    outer, n_out = _fibonacci_shell(cfg["n_outer"], cfg["r_outer_nm"],
                                    center, device)
    inner, n_in = _fibonacci_shell(cfg["n_inner"], cfg["r_inner_nm"],
                                   center, device)
    heads = torch.cat([outer, inner]).float()
    chain = torch.cat([-n_out, n_in]).float()
    return heads, chain, True


def _bilayer_water(cfg, points):
    """Where water may sit: outside the slab of half-thickness
    `water_free_half_nm` about the box's midplane."""
    mid = cfg["box_nm"][2] / 2
    return (points[:, 2] - mid).abs() >= cfg["water_free_half_nm"]


def _vesicle_water(cfg, points):
    """Where water may sit: inside or outside the shell of radii
    `water_free_shell_nm` about the box centre."""
    lo, hi = cfg["water_free_shell_nm"]
    centre = torch.tensor(cfg["box_nm"], dtype=points.dtype,
                          device=points.device) / 2
    r = torch.linalg.vector_norm(points - centre, dim=1)
    return (r < lo) | (r >= hi)


_LAYOUTS = {"bilayer": (_bilayer_heads, _bilayer_water),
            "vesicle": (_vesicle_heads, _vesicle_water)}


def _water_sites(cfg, n, box, gen, device):
    """(n, 3) points uniform over the box where the layout lets water sit:
    uniform draws, those in the membrane dropped, until n are kept."""
    allowed = _LAYOUTS[cfg["system"]][1]
    kept, have = [], 0
    while have < n:
        draw = torch.rand((2 * (n - have) + 1024, 3), generator=gen,
                          device=device) * box
        draw = draw[allowed(cfg, draw)]
        kept.append(draw)
        have += draw.shape[0]
    return torch.cat(kept)[:n]


def make_system(cfg: dict, seed: int, device) -> System:
    """The configuration's structure from `seed` (its generator 2·seed)."""
    gen = _generator(2 * int(seed), device)
    names_t, bonds_t = cells.template_part(cfg["template"]).template()
    per = len(names_t)
    heads, chain, first_on_shell = _LAYOUTS[cfg["system"]][0](cfg, device)
    n_mols = heads.shape[0]
    box = torch.tensor(cfg["box_nm"], dtype=torch.float32, device=device)

    lipid = torch.empty((n_mols, per, 3), dtype=torch.float32, device=device)
    walk = heads.clone()
    for k in range(per):
        step = torch.randn((n_mols, 3), generator=gen, device=device)
        step = _unit(step + chain * CHAIN_BIAS)
        if k or not first_on_shell:
            walk = walk + step * cfg["step_nm"]
        lipid[:, k] = walk

    water_names = cfg["water_names"]
    n_water = (cfg["total_atoms"] - n_mols * per) // len(water_names)
    base = _water_sites(cfg, n_water, box, gen, device)
    water = torch.empty((n_water, len(water_names), 3), dtype=torch.float32,
                        device=device)
    for k in range(len(water_names)):
        d = _unit(torch.randn((n_water, 3), generator=gen, device=device))
        water[:, k] = base + d * (cfg["water_spacing_nm"] * k)
    positions = torch.remainder(torch.cat([lipid.reshape(-1, 3),
                                           water.reshape(-1, 3)]), box)

    n_wa = len(water_names)
    names = names_t * n_mols + water_names * n_water
    resnames = [cfg["resname"]] * (n_mols * per) \
        + [cfg["water_resname"]] * (n_water * n_wa)
    molecule = np.concatenate([np.repeat(np.arange(n_mols), per),
                               n_mols + np.repeat(np.arange(n_water), n_wa)])
    bonds = [np.asarray(bonds_t, np.int64)[None] + (np.arange(n_mols)
                                                    * per)[:, None, None]]
    if n_wa > 1:
        o = n_mols * per + np.arange(n_water) * n_wa
        bonds.append(np.stack([np.stack([o, o + k], 1)
                               for k in range(1, n_wa)], 1))
    bonds = np.sort(np.concatenate([b.reshape(-1, 2) for b in bonds]), 1)
    return System(names=names, resnames=resnames,
                  resids=(molecule + 1).astype(np.int64), molecule=molecule,
                  n_molecules=n_mols + n_water, bonds=bonds,
                  positions=positions,
                  box=np.asarray(cfg["box_nm"], np.float32), config=cfg)


def frames_per_chunk(system: System) -> int:
    return max(1, CHUNK_BYTES // (system.n_atoms * 12))


def trajectory_chunks(system: System, seed: int, n_frames: int = None):
    """Yield (first frame, (F, A, 3) int32 grid integers on the device)
    over the trajectory of `seed` (its generator 2·seed + 1), in frame
    order. The draws follow the configuration's chunks of
    `frames_per_chunk` frames whatever `n_frames` (which stops early), so
    that every prefix holds the same integers."""
    cfg = system.config
    device = system.positions.device
    gen = _generator(2 * int(seed) + 1, device)
    total = cfg["n_frames"]
    stop = total if n_frames is None else min(n_frames, total)
    chunk = frames_per_chunk(system)
    mol = torch.as_tensor(system.molecule, device=device)
    box = torch.tensor(cfg["box_nm"], dtype=torch.float32, device=device)
    drift = torch.zeros((system.n_molecules, 3), dtype=torch.float32,
                        device=device)
    for start in range(0, stop, chunk):
        n = min(chunk, total - start)
        eps = torch.randn((n, system.n_molecules, 3), generator=gen,
                          device=device) * cfg["drift_sigma_nm"]
        drifts = torch.empty_like(eps)
        for i in range(n):
            drift = (drift + eps[i]) * cfg["drift_decay"]
            drifts[i] = drift
        jitter = torch.randn((n, system.n_atoms, 3), generator=gen,
                             device=device) * cfg["jitter_sigma_nm"]
        keep = min(n, stop - start)
        coords = torch.remainder(system.positions[None] + drifts[:keep, mol]
                                 + jitter[:keep], box)
        yield start, torch.round(coords * cfg["precision"]).to(torch.int32)


def frame_meta(cfg: dict, start: int, n: int):
    """(n, 9) f32 boxes, (n,) f32 times (ps) and (n,) int32 steps of frames
    start .. start + n."""
    box9 = np.diag(np.asarray(cfg["box_nm"], np.float32)).reshape(9)
    frames = np.arange(start, start + n)
    return (np.tile(box9, (n, 1)),
            (frames * cfg["dt_ps"]).astype(np.float32),
            (frames * cfg["steps_per_frame"]).astype(np.int32))


def write_structure(system: System, gro: Path, bnd: Path) -> None:
    """The GRO file (3-decimal positions, residue and atom numbers modulo
    100,000 as GROMACS writes them) and the bonds file."""
    pos = system.positions.cpu().numpy()
    lines = [f"{system.config['name']} (benchmark, synthetic)",
             f"{system.n_atoms:>5d}"]
    for i in range(system.n_atoms):
        lines.append(f"{int(system.resids[i]) % 100000:>5d}"
                     f"{system.resnames[i]:<5.5s}{system.names[i]:>5.5s}"
                     f"{(i + 1) % 100000:>5d}{pos[i, 0]:8.3f}"
                     f"{pos[i, 1]:8.3f}{pos[i, 2]:8.3f}")
    b = system.box
    lines.append(f"{b[0]:10.5f}{b[1]:10.5f}{b[2]:10.5f}")
    gro.write_text("\n".join(lines) + "\n")
    np.savetxt(bnd, system.bonds + 1, fmt="%d")


def _stamp(cfg_bytes: bytes, seed: int) -> str:
    """The digest of the configuration's bytes, the generator's sources,
    the configuration's own template file and the seed."""
    h = hashlib.sha256(cfg_bytes)
    template = Path(cells.template_part(
        json.loads(cfg_bytes)["template"]).__file__)
    for path in [HERE / name for name in _SOURCES] + [template]:
        h.update(path.read_bytes())
    h.update(str(int(seed)).encode())
    return h.hexdigest()


def encoder_threads() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def prepare_inputs(cfg: dict, cfg_bytes: bytes, seed: int, device,
                   cache_dir: Path = None, log=print):
    """→ (System, {"structure", "bonds", "trajectory"} paths, made): the
    configuration's files in its cache directory, written unless the stamp
    there says they came from this seed and these sources (`made` False)."""
    system = make_system(cfg, seed, device)
    out = Path(cache_dir or CACHE_DIR) / cfg["name"]
    out.mkdir(parents=True, exist_ok=True)
    files = {"structure": out / "structure.gro", "bonds": out / "bonds.bnd",
             "trajectory": out / "traj.xtc"}
    stamp_path = out / "stamp.json"
    stamp = _stamp(cfg_bytes, seed)
    try:
        old = json.loads(stamp_path.read_text())
    except (OSError, ValueError):
        old = None
    if old is not None and old.get("stamp") == stamp and all(
            f.exists() for f in files.values()) and (
            files["trajectory"].stat().st_size == old.get("xtc_bytes")):
        return system, files, False

    for f in list(files.values()) + [stamp_path]:
        if f.exists():
            f.unlink()
    t0 = time.perf_counter()
    write_structure(system, files["structure"], files["bonds"])
    partial = files["trajectory"].with_suffix(".xtc.partial")
    threads = encoder_threads()

    def encode(start, ints):
        boxes, times, steps = frame_meta(cfg, start, ints.shape[0])
        return xtc.append_frames(partial, ints, boxes, times, steps,
                                 cfg["precision"], threads,
                                 append=start > 0)

    # a chunk is encoded on the host's threads while the next is made
    written, pending = 0, None
    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        for start, ints in trajectory_chunks(system, seed):
            host = ints.cpu().numpy()
            if pending is not None:
                written += pending.result()
            pending = pool.submit(encode, start, host)
        written += pending.result()
    # on the disk before the window opens, so that no write-back of it
    # runs beside the measured analyses
    fd = os.open(partial, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(partial, files["trajectory"])
    stamp_path.write_text(json.dumps({"stamp": stamp, "seed": int(seed),
                                      "xtc_bytes": written}))
    log(f"inputs: {cfg['name']} seed {seed}: {cfg['n_frames']} frames, "
        f"{written} bytes of XTC, {system.n_atoms} atoms, in "
        f"{time.perf_counter() - t0:.3f} s on {threads} encoder threads")
    return system, files, True
