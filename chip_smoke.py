#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

Run from the repository root on a machine with a CUDA card (an H100: the
kernels are built for sm_90a):

    python3 chip_smoke.py

It imports nothing of JAX or of `gorder_tpu`. Phases, one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds `gorder_tpu_torch/csrc/*.cu`;
3. synth: the AA benchmark membrane of bench.py (256 POPC, 64.5k atoms,
   10,000 XTC frames, seeds 7 and 11), synthesized byte for byte like
   bench.py does, through the port's shared host modules; cached in the
   temporary directory;
4. kernel: the P2 kernel against its plain PyTorch version on the first
   full-width batch (B = 512) of that trajectory, for its three inputs
   (b7 residuals, int16 positions, f32 positions): the int64 (B, 2, T)
   outputs must be equal; CUDA-event times of both;
5. run: `gorder_tpu_torch.run(analysis, device="cuda")` over all 10,000
   frames; the YAML must pass `bench.validate_output` against
   `tools/bench_golden/aa_10000.yaml`, and the P2 kernel must have been
   launched once per batch;
6. synth ua: the UA benchmark membrane of tools/bench_modes.py (256
   Berger-like POPC, 44.3k atoms, 3,000 XTC frames, seed 29), synthesized
   byte for byte likewise;
7. kernel ua: the UA kernel against its plain version on the first
   full-width batch of that trajectory and on a synthetic batch with all
   four carbon categories, for int16 and f32 positions: the int64 outputs
   must be equal; CUDA-event times of both;
8. run ua, run ua-palmitoyl: `gorder_tpu_torch.run` over all 3,000 frames
   for both UA analyses of tools/bench_modes.py; each YAML must pass
   `bench.validate_output` against `tools/bench_golden/ua_3000.yaml` and
   `ua-palmitoyl_3000.yaml`, and the UA kernel must have been launched
   once per batch and carbon category.

Then one JSON line with the kernels of the path, and last the result line
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_FRAMES = 10_000
BATCH = 512
HEAVY = "resname POPC and name r'^C'"
HYDROGENS = "resname POPC and name r'^H'"


def synthesize_structure(cache_dir, n_lipids=None, total_atoms=None):
    """bench.py synthesize_structure, through the port's `_ref` host
    modules: bench.gro + bench.bnd (lipids first, then water)."""
    import bench
    from gorder_tpu_torch._ref.io.gro import write_gro
    from gorder_tpu_torch._ref.system import System, canonical_bonds

    n_lipids = bench.N_LIPIDS if n_lipids is None else n_lipids
    total_atoms = bench.TOTAL_ATOMS if total_atoms is None else total_atoms
    box = bench.BOX
    lipid_names, lipid_bonds = bench.build_lipid_template()
    per_lipid = len(lipid_names)
    n_lipid_atoms = per_lipid * n_lipids
    n_water = (total_atoms - n_lipid_atoms) // 3

    names, resids, resnames = [], [], []
    bonds = []
    rng = np.random.default_rng(7)
    positions = np.zeros((n_lipid_atoms + n_water * 3, 3), np.float32)
    grid = int(np.ceil(np.sqrt(n_lipids / 2)))
    spacing = box[0] / grid
    idx = 0
    for m in range(n_lipids):
        leaflet = m % 2
        cell = m // 2
        gx, gy = cell % grid, (cell // grid) % grid
        base = np.array([
            (gx + 0.5) * spacing, (gy + 0.5) * spacing,
            box[2] / 2 + (1.0 if leaflet == 0 else -1.0) * 0.4,
        ], np.float32)
        z_dir = 1.0 if leaflet == 0 else -1.0
        walk = base.copy()
        for name in lipid_names:
            names.append(name)
            resids.append(m + 1)
            resnames.append("POPC")
            step_dir = rng.normal(0, 1, 3).astype(np.float32)
            step_dir[2] += z_dir * 1.2
            step_dir /= max(np.linalg.norm(step_dir), 1e-6)
            walk = walk + step_dir * (0.125 + 0.03 * rng.random())
            positions[idx] = walk
            idx += 1
        offset = m * per_lipid
        for a, b in lipid_bonds:
            bonds.append((offset + a, offset + b))

    for w in range(n_water):
        o_pos = rng.random(3).astype(np.float32) * box
        d1 = rng.normal(0, 1, 3).astype(np.float32)
        d1 /= max(np.linalg.norm(d1), 1e-6)
        helper = rng.normal(0, 1, 3).astype(np.float32)
        perp = np.cross(d1, helper)
        perp /= max(np.linalg.norm(perp), 1e-6)
        d2 = np.cos(np.radians(104.5)) * d1 + np.sin(np.radians(104.5)) * perp
        for name, pos in (("OH2", o_pos), ("H1", o_pos + 0.0957 * d1),
                          ("H2", o_pos + 0.0957 * d2)):
            names.append(name)
            resids.append(n_lipids + w + 1)
            resnames.append("TIP3")
            positions[idx] = pos
            idx += 1
        o = n_lipid_atoms + w * 3
        bonds += [(o, o + 1), (o, o + 2)]

    positions %= box

    system = System(
        name="gorder-tpu benchmark membrane",
        atom_names=np.array(names, dtype="U8"),
        resids=np.array(resids, np.int64),
        resnames=np.array(resnames, dtype="U8"),
        serials=np.arange(1, len(names) + 1, dtype=np.int64),
        positions=positions,
        box=np.diag(box).astype(np.float32),
    )
    system.bonds = canonical_bonds(np.asarray(bonds, np.int64))

    gro_path = os.path.join(cache_dir, "bench.gro")
    bnd_path = os.path.join(cache_dir, "bench.bnd")
    write_gro(gro_path, system)
    with open(bnd_path, "w") as fh:
        for a, b in system.bonds:
            fh.write(f"{a + 1} {b + 1}\n")
    return gro_path, bnd_path, system


def synthesize_trajectory(cache_dir, system, n_frames):
    """bench.py synthesize_trajectory for `n_frames` frames (reused when a
    complete file is cached)."""
    import bench
    from gorder_tpu_torch._ref.io import native

    xtc_path = os.path.join(cache_dir, f"bench_{n_frames}.xtc")
    if os.path.exists(xtc_path):
        if len(native.xtc_scan(xtc_path)["offsets"]) == n_frames:
            return xtc_path
        os.remove(xtc_path)

    box = bench.BOX
    rng = np.random.default_rng(11)
    base = system.positions.copy()
    n_atoms = base.shape[0]
    mol_of_atom = np.asarray(system.resids, np.int64) - 1
    n_mols = int(mol_of_atom.max()) + 1
    mol_drift = np.zeros((n_mols, 3), np.float32)
    chunk = 200
    boxes = np.tile(np.diag(box).astype(np.float32), (chunk, 1, 1))
    written = 0
    while written < n_frames:
        n = min(chunk, n_frames - written)
        coords = np.empty((n, n_atoms, 3), np.float32)
        for i in range(n):
            mol_drift += rng.standard_normal(
                (n_mols, 3), dtype=np.float32) * 0.015
            mol_drift *= 0.995
            jitter = rng.standard_normal(
                (n_atoms, 3), dtype=np.float32) * 0.012
            coords[i] = (base + mol_drift[mol_of_atom] + jitter) % box
        times = (np.arange(written, written + n) * 10.0).astype(np.float32)
        steps = (np.arange(written, written + n) * 100).astype(np.int32)
        native.xtc_write(xtc_path, coords, boxes[:n], times, steps,
                         precision=1000.0, append=written > 0)
        written += n
    return xtc_path


def synthesize_ua(cache_dir, n_frames, n_lipids=None, total_atoms=None):
    """tools/bench_modes.py `_synthesize("ua", ...)` (synth_ua: 256
    Berger-like POPC, 44.3k atoms, seed 29), through the port's `_ref` host
    modules: ua_bench.gro, ua_bench.bnd and ua_bench_{n_frames}.xtc, each
    written unless cached. One rng stream feeds the structure and then the
    trajectory, and the trajectory starts from the in-memory positions,
    not from the GRO read back."""
    from tools import bench_modes as bm

    from gorder_tpu_torch._ref.io import native
    from gorder_tpu_torch._ref.io.gro import write_gro
    from gorder_tpu_torch._ref.system import System, canonical_bonds

    n_mols = bm.UA_LIPIDS if n_lipids is None else n_lipids
    total_atoms = bm.UA_TOTAL_ATOMS if total_atoms is None else total_atoms
    box = bm.UA_BOX
    water_names = ["OW", "HW1", "HW2"]
    gro = os.path.join(cache_dir, "ua_bench.gro")
    bnd = os.path.join(cache_dir, "ua_bench.bnd")
    xtc = os.path.join(cache_dir, f"ua_bench_{n_frames}.xtc")

    lipid_names, lipid_bonds = bm._ua_template()
    per = len(lipid_names)
    n_lipid_atoms = per * n_mols
    n_water = (total_atoms - n_lipid_atoms) // len(water_names)
    need_struct = not (os.path.exists(gro) and os.path.exists(bnd))
    need_traj = True
    if os.path.exists(xtc):
        need_traj = len(native.xtc_scan(xtc)["offsets"]) != n_frames
        if need_traj:
            os.remove(xtc)

    rng = np.random.default_rng(29)
    names, resids, resnames = [], [], []
    bonds = []
    n_atoms = n_lipid_atoms + n_water * len(water_names)
    positions = np.zeros((n_atoms, 3), np.float32)
    grid = int(np.ceil(np.sqrt(n_mols / 2)))
    spacing = box[0] / grid
    idx = 0
    for m in range(n_mols):
        leaflet = m % 2
        cell = m // 2
        gx, gy = cell % grid, (cell // grid) % grid
        sign = 1.0 if leaflet == 0 else -1.0
        base = np.array([(gx + 0.5) * spacing, (gy + 0.5) * spacing,
                         box[2] / 2 + sign * 0.4], np.float32)
        walk = base.copy()
        for name in lipid_names:
            names.append(name)
            resids.append(m + 1)
            resnames.append("POPC")
            step = rng.normal(0, 1, 3).astype(np.float32)
            step[2] += sign * 1.2
            step /= max(np.linalg.norm(step), 1e-6)
            walk = walk + step * 0.14
            positions[idx] = walk
            idx += 1
        off = m * per
        bonds += [(off + a, off + b) for a, b in lipid_bonds]
    for w in range(n_water):
        base = rng.random(3).astype(np.float32) * box
        for k, name in enumerate(water_names):
            names.append(name)
            resids.append(n_mols + w + 1)
            resnames.append("SOL")
            d = rng.normal(0, 1, 3).astype(np.float32)
            d /= max(np.linalg.norm(d), 1e-6)
            positions[idx] = base + (0.0957 * k) * d
            idx += 1
        o = n_lipid_atoms + w * len(water_names)
        bonds += [(o, o + k) for k in range(1, len(water_names))]
    positions %= box

    system = System(
        name="gorder-tpu ua benchmark",
        atom_names=np.array(names, dtype="U8"),
        resids=np.array(resids, np.int64),
        resnames=np.array(resnames, dtype="U8"),
        serials=np.arange(1, n_atoms + 1, dtype=np.int64),
        positions=positions,
        box=np.diag(box).astype(np.float32),
    )
    system.bonds = canonical_bonds(np.asarray(bonds, np.int64))
    if need_struct:
        write_gro(gro, system)
        with open(bnd, "w") as fh:
            for a, b in system.bonds:
                fh.write(f"{a + 1} {b + 1}\n")

    if need_traj:
        mol_of_atom = np.asarray(system.resids, np.int64) - 1
        n_mols_total = int(mol_of_atom.max()) + 1
        drift = np.zeros((n_mols_total, 3), np.float32)
        chunk = 200
        boxes = np.tile(np.diag(box).astype(np.float32), (chunk, 1, 1))
        written = 0
        while written < n_frames:
            n = min(chunk, n_frames - written)
            coords = np.empty((n, n_atoms, 3), np.float32)
            for i in range(n):
                drift += rng.standard_normal(
                    (n_mols_total, 3), dtype=np.float32) * 0.015
                drift *= 0.995
                jitter = rng.standard_normal(
                    (n_atoms, 3), dtype=np.float32) * 0.012
                coords[i] = (positions + drift[mol_of_atom] + jitter) % box
            times = (np.arange(written, written + n) * 10.0).astype(
                np.float32)
            steps = (np.arange(written, written + n) * 100).astype(np.int32)
            native.xtc_write(xtc, coords, boxes[:n], times, steps,
                             precision=1000.0, append=written > 0)
            written += n
    return gro, bnd, xtc


def ua_analysis(mode, gro, bnd, xtc, output_yaml=None):
    """tools/bench_modes.py `_make_analysis(mode)` for "ua" and
    "ua-palmitoyl", built from the port's `Analysis`."""
    from gorder_tpu_torch import Analysis, AnalysisType

    if mode == "ua-palmitoyl":
        atype = AnalysisType.uaorder(
            saturated="resname POPC and name r'^CA\\d+$'")
    else:
        atype = AnalysisType.uaorder(
            saturated="resname POPC and name r'^CA\\d+$' or "
                      "(resname POPC and name r'^CB\\d+$' and "
                      "not name CB9 CB10)",
            unsaturated="resname POPC and name CB9 CB10")
    return Analysis(structure=gro, bonds=bnd, trajectory=xtc,
                    analysis_type=atype, output_yaml=output_yaml,
                    n_threads=os.cpu_count() or 1, silent=True,
                    overwrite=True)


def aa_analysis(gro, bnd, xtc, output_yaml=None):
    from gorder_tpu_torch import Analysis, AnalysisType

    return Analysis(structure=gro, bonds=bnd, trajectory=xtc,
                    analysis_type=AnalysisType.aaorder(HEAVY, HYDROGENS),
                    output_yaml=output_yaml, n_threads=os.cpu_count() or 1,
                    silent=True, overwrite=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device time of one call, from CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def first_batch(analysis):
    """The first B = 512 frames of the AA trajectory, as the main path's
    decoders give them: b7 payload, int16 positions and f32 positions."""
    from gorder_tpu_torch._ref.engine.prepare import (
        _build_atom_space, _prepare_bond_kinds, load_structure)
    from gorder_tpu_torch._ref.io.native import b7_stride
    from gorder_tpu_torch._ref.io.traj import Trajectory

    system = load_structure(analysis)
    _, compiled = _prepare_bond_kinds(system, analysis)
    space, remap = _build_atom_space(system, analysis,
                                     [compiled.atom_a, compiled.atom_b])
    atom_a, atom_b = remap(compiled.atom_a), remap(compiled.atom_b)
    traj = Trajectory(analysis.trajectory, expected_atoms=system.n_atoms)
    chunk = traj.select_frames(None, None, 1)[:BATCH]
    esc_cap = 8192
    pk = np.zeros((BATCH, b7_stride(len(atom_a))), np.uint8)
    eg = np.zeros((BATCH, esc_cap), np.uint16)
    ev = np.zeros((BATCH, esc_cap), np.int16)
    res, nesc = traj.read_frames_b7(chunk, space, atom_a, atom_b, pk, eg, ev,
                                    n_threads=analysis.n_threads)
    if res is None:
        raise RuntimeError(f"b7 decode failed (escape demand {nesc})")
    base, inv_prec, boxes, _, _ = res
    q16, inv16, _, _, _ = traj.read_frames_quantized(
        chunk, space, n_threads=analysis.n_threads)
    f32, _, _, _ = traj.read_frames(chunk, space,
                                    n_threads=analysis.n_threads)
    return dict(atom_a=atom_a, atom_b=atom_b, bond_type=compiled.bond_type,
                n_types=compiled.n_types, pk=pk, eg=eg, ev=ev, base=base,
                inv_prec=inv_prec, boxes=boxes, q16=q16, inv16=inv16,
                f32=f32)


def check_kernel(batch):
    """Phase 4: kernel against plain for the three inputs; returns the b7
    (main-path) entry's numbers."""
    import torch

    from gorder_tpu_torch.engine.wire import b7_residuals
    from gorder_tpu_torch.ops import p2

    dev = torch.device("cuda")

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev,
                               dtype=dtype)

    box = t(batch["boxes"][:, [0, 1, 2], [0, 1, 2]], torch.float32)
    normal = t(np.array([0.0, 0.0, 1.0], np.float32))
    mask = torch.ones(BATCH, dtype=torch.bool, device=dev)
    bond_type = t(batch["bond_type"], torch.int32)
    atom_a = t(batch["atom_a"], torch.int32)
    atom_b = t(batch["atom_b"], torch.int32)
    n_types = int(batch["n_types"])
    base = t(batch["base"])
    wire = (t(batch["pk"]), t(batch["eg"].view(np.int16)), t(batch["ev"]))
    r = b7_residuals(*wire, base.shape[0])
    scale = t(batch["inv_prec"], torch.float32)
    q16 = t(batch["q16"])
    scale16 = t(batch["inv16"], torch.float32)
    f32 = t(batch["f32"])

    cases = {
        "resid": (p2.p2_resid, p2.p2_resid_plain,
                  (r, base, scale, box, normal, mask, bond_type, n_types)),
        "i16": (p2.p2_positions, p2.p2_positions_plain,
                (q16, atom_a, atom_b, scale16, box, normal, mask, bond_type,
                 n_types)),
        "f32": (p2.p2_positions, p2.p2_positions_plain,
                (f32, atom_a, atom_b, None, box, normal, mask, bond_type,
                 n_types)),
    }
    outs = {}
    numbers = {}
    for name, (kernel, plain, args) in cases.items():
        before = p2.p2_launches
        got = kernel(*args, handle_pbc=True)
        torch.cuda.synchronize()
        if p2.p2_launches != before + 1:
            raise RuntimeError(f"{name}: p2_launches did not grow")
        want = plain(*args, handle_pbc=True)
        if got.shape != (BATCH, 2, n_types) or got.dtype != torch.int64:
            raise RuntimeError(f"{name}: output {tuple(got.shape)} "
                               f"{got.dtype}")
        err = int((got - want).abs().max())
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: kernel != plain, max |diff| {err} "
                               f"quanta")
        # in turns: plain, kernel, kernel, plain
        plain_ms = cuda_ms(lambda: plain(*args, handle_pbc=True))
        ms = cuda_ms(lambda: kernel(*args, handle_pbc=True))
        ms2 = cuda_ms(lambda: kernel(*args, handle_pbc=True))
        plain_ms2 = cuda_ms(lambda: plain(*args, handle_pbc=True))
        outs[name] = got
        numbers[name] = dict(max_abs_err=err, ms=min(ms, ms2),
                             plain_ms=min(plain_ms, plain_ms2))
        print(f"kernel {name}: B={BATCH} N={len(batch['atom_a'])} "
              f"T={n_types} kernel == plain (int64, max |diff| {err}); "
              f"ms per call: plain {plain_ms:.4f}, kernel {ms:.4f}, "
              f"kernel {ms2:.4f}, plain {plain_ms2:.4f}", flush=True)
    if not torch.equal(outs["resid"], outs["i16"]):
        raise RuntimeError("b7 residual input and int16 positions disagree: "
                           "both must give the same integer bond vectors")
    print("kernel: b7 residual input == int16 positions (same integer "
          "bond vectors)", flush=True)
    # the main path's whole device work for one batch: b7 unpack + kernel
    unpack_ms = cuda_ms(lambda: b7_residuals(*wire, base.shape[0]))
    batch_ms = cuda_ms(lambda: p2.p2_resid(
        b7_residuals(*wire, base.shape[0]), base, scale, box, normal, mask,
        bond_type, n_types, handle_pbc=True))
    print(f"kernel: device time per batch on the main path: b7 unpack "
          f"{unpack_ms:.4f} ms + P2 kernel = {batch_ms:.4f} ms", flush=True)
    return dict(numbers["resid"], batch_ms=batch_ms)


def ua_problem(seed, n_frames, n_mols, n_types=7):
    """A numpy-seeded UA problem with all four categories, laid out as
    tests/test_pallas_ua.py `_ua_problem` lays its own: molecules of 10
    atoms with 1 CH3, 3 CH2, 1 CH1u and 1 CH1s each, uniform positions in
    a 6 nm box, the last two frames masked, and sample types
    (i·K + k) mod n_types per category. → dict of numpy arrays, with the
    positions also as int16 XTC integers at precision 1000."""
    rng = np.random.default_rng(seed)
    per = 10
    coords = rng.uniform(0, 6, (n_frames, n_mols * per, 3)).astype(np.float32)
    mask = np.ones(n_frames, bool)
    mask[-2:] = False
    base = np.arange(n_mols, dtype=np.int32) * per
    categories = {
        "ch3": {"target": base, "h1": base + 1, "h2": base + 2},
        "ch2": {"target": (base[:, None] + [1, 2, 3]).ravel(),
                "h1": (base[:, None] + [4, 1, 2]).ravel(),
                "h2": (base[:, None] + [2, 3, 4]).ravel()},
        "ch1u": {"target": base + 5, "h1": base + 4, "h2": base + 6},
        "ch1s": {"target": base + 7, "h1": base + 6, "h2": base + 8,
                 "h3": base + 9},
    }
    k_of = {"ch3": 3, "ch2": 2, "ch1u": 1, "ch1s": 1}
    bond_type = np.concatenate([
        np.arange(len(d["target"]) * k_of[c]) % n_types
        for c, d in categories.items()]).astype(np.int32)
    bond_mol = np.concatenate([
        np.repeat(d["target"] // per, k_of[c])
        for c, d in categories.items()]).astype(np.int32)
    return dict(coords=coords, q16=np.round(coords * 1000).astype(np.int16),
                inv16=np.full(n_frames, 1e-3, np.float32),
                box=np.full((n_frames, 3), 6.0, np.float32), mask=mask,
                categories=categories, bond_type=bond_type,
                bond_mol=bond_mol, n_types=n_types)


def ua_first_batch(analysis):
    """The first B = 512 frames of a UA trajectory as the main path's
    decoders give them (int16 and f32 positions), with the analysis's
    remapped category index arrays."""
    from gorder_tpu_torch._ref.engine.prepare import (
        _build_atom_space, _prepare_ua_kinds, load_structure)
    from gorder_tpu_torch._ref.io.traj import Trajectory

    system = load_structure(analysis)
    _, compiled = _prepare_ua_kinds(system, analysis)
    keys = ("target", "h1", "h2", "h3")
    space, remap = _build_atom_space(
        system, analysis, [d[k] for d in compiled.categories.values()
                           for k in keys if k in d])
    traj = Trajectory(analysis.trajectory, expected_atoms=system.n_atoms)
    chunk = traj.select_frames(None, None, 1)[:BATCH]
    q16, inv16, boxes, _, _ = traj.read_frames_quantized(
        chunk, space, n_threads=analysis.n_threads)
    f32, _, _, _ = traj.read_frames(chunk, space,
                                    n_threads=analysis.n_threads)
    return dict(
        categories={cat: {k: (remap(v) if k in keys else v)
                          for k, v in d.items()}
                    for cat, d in compiled.categories.items()},
        bond_type=compiled.bond_type, bond_mol=compiled.bond_mol,
        n_types=compiled.n_types, q16=q16, inv16=inv16, f32=f32,
        box=boxes[:, [0, 1, 2], [0, 1, 2]], mask=np.ones(BATCH, bool))


def check_ua_kernel(batch, label):
    """The UA kernel against its plain version on one batch, for the int16
    and f32 inputs: the int64 (B, 2, T) outputs must be equal, and the
    kernel must have been launched once per category. Returns the int16
    (main-path) entry's numbers."""
    import torch

    from gorder_tpu_torch.core.ua import N_HYDROGENS, make_ua_step
    from gorder_tpu_torch.ops import ua

    dev = torch.device("cuda")

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev,
                               dtype=dtype)

    n_types = int(batch["n_types"])
    step = make_ua_step(batch["categories"], batch["bond_type"],
                        batch["bond_mol"], n_types, handle_pbc=True,
                        device=dev)
    box = t(batch["box"], torch.float32)
    normal = t(np.array([0.0, 0.0, 1.0], np.float32))
    mask = t(batch["mask"])
    inputs = {"i16": (t(batch["q16"]), t(batch["inv16"], torch.float32)),
              "f32": (t(batch["f32"] if "f32" in batch
                        else batch["coords"]), None)}
    n_cats = len(step.layout)
    n_samples = len(batch["bond_type"])
    numbers = {}
    for name, (coords, scale) in inputs.items():
        def kernel(layout=step.layout, bond_type=step.bond_type):
            return ua.ua_positions(coords, scale, box, normal, mask,
                                   step.indices, bond_type, n_types,
                                   handle_pbc=True, layout=layout)

        def plain(layout=step.layout, bond_type=step.bond_type):
            return ua.ua_positions_plain(coords, scale, box, normal, mask,
                                         step.indices, bond_type, n_types,
                                         handle_pbc=True, layout=layout)

        before = ua.ua_launches
        got = kernel()
        torch.cuda.synchronize()
        if ua.ua_launches != before + n_cats:
            raise RuntimeError(f"ua {label} {name}: ua_launches grew by "
                               f"{ua.ua_launches - before}, expected "
                               f"{n_cats} (one per category)")
        want = plain()
        if got.shape != want.shape or got.dtype != torch.int64:
            raise RuntimeError(f"ua {label} {name}: output "
                               f"{tuple(got.shape)} {got.dtype}")
        err = int((got - want).abs().max())
        if not torch.equal(got, want):
            # which category disagrees, and in how many (frame, type) cells
            detail = []
            offset = 0
            for cat, n in step.layout:
                one = (((cat, n),),
                       step.bond_type[offset:offset + n * N_HYDROGENS[cat]])
                offset += n * N_HYDROGENS[cat]
                kc, pc = kernel(*one), plain(*one)
                detail.append(f"{cat}: {int((kc != pc).sum())} cells, max "
                              f"|diff| {int((kc - pc).abs().max())}")
            raise RuntimeError(f"ua {label} {name}: kernel != plain, max "
                               f"|diff| {err} quanta; " + "; ".join(detail))
        plain_ms = cuda_ms(plain)
        ms = cuda_ms(kernel)
        ms2 = cuda_ms(kernel)
        plain_ms2 = cuda_ms(plain)
        numbers[name] = dict(max_abs_err=err, ms=min(ms, ms2),
                             plain_ms=min(plain_ms, plain_ms2))
        print(f"kernel ua {label} {name}: B={coords.shape[0]} "
              f"samples={n_samples} T={n_types} categories "
              f"{[f'{c}:{n}' for c, n in step.layout]} kernel == plain "
              f"(int64, max |diff| {err}); ms per call: plain "
              f"{plain_ms:.4f}, kernel {ms:.4f}, kernel {ms2:.4f}, plain "
              f"{plain_ms2:.4f}", flush=True)
    return numbers["i16"]


def run_ua(mode, gro, bnd, xtc, cache, n_frames):
    """`gorder_tpu_torch.run` over the UA trajectory for `mode`; the YAML
    must pass bench.validate_output against the pinned golden and the UA
    kernel must have run once per batch and category. → launches."""
    import bench
    import torch

    import gorder_tpu_torch
    from gorder_tpu_torch._ref.utils.timers import timers
    from gorder_tpu_torch.ops import p2, ua

    out_yaml = os.path.join(cache, f"smoke_{mode}.yaml")
    analysis = ua_analysis(mode, gro, bnd, xtc, out_yaml)
    ua.ua_launches = 0
    p2.p2_launches = 0
    timers.reset()
    t0 = time.perf_counter()
    results = gorder_tpu_torch.run(analysis, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ua.ua_launches
    results.write()
    n_cats = 3 if mode == "ua" else 2          # (ch3, ch2[, ch1u])
    n_batches = math.ceil(n_frames / BATCH)
    print(f"run {mode}: {n_frames} frames in {wall:.3f} s = "
          f"{n_frames / wall:.1f} frames/s end to end; phases: "
          f"{timers.summary()}", flush=True)
    if results.n_analyzed_frames != n_frames:
        raise RuntimeError(f"{mode}: analyzed {results.n_analyzed_frames} "
                           f"frames, expected {n_frames}")
    if launches != n_batches * n_cats or p2.p2_launches != 0:
        raise RuntimeError(f"{mode}: ua_launches {launches} != {n_batches} "
                           f"batches x {n_cats} categories (p2_launches "
                           f"{p2.p2_launches})")
    status = bench.validate_output(out_yaml, mode, n_frames)
    if status is None:
        raise RuntimeError(f"no pinned golden for {mode}_{n_frames}")
    values = [m.average_order.total.value for m in results.molecules]
    if not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"{mode}: non-finite average order: {values}")
    print(f"check {mode}: ua_launches {launches} == {n_batches} batches x "
          f"{n_cats} categories; golden {mode}_{n_frames}.yaml: {status}; "
          f"average order {values}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import bench

    import gorder_tpu_torch
    from gorder_tpu_torch._ref.utils.timers import timers
    from gorder_tpu_torch.ops import build, p2

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)",
          flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    so_path, log = build.build()
    build.load()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"build: {os.path.relpath(so_path, root)} in "
          f"{time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(ptxas)}",
          flush=True)

    # 3. synth
    cache = os.path.join(tempfile.gettempdir(), "gorder_tpu_torch_smoke")
    os.makedirs(cache, exist_ok=True)
    t0 = time.perf_counter()
    gro, bnd, _ = synthesize_structure(cache)
    # the pinned golden's trajectory starts from the positions as read
    # back from bench.gro (3 decimals), as bench.py does once bench.gro
    # is cached
    from gorder_tpu_torch._ref.engine.prepare import load_structure

    system = load_structure(
        aa_analysis(gro, bnd, os.path.join(cache, "missing.xtc")))
    xtc = synthesize_trajectory(cache, system, N_FRAMES)
    print(f"synth: {system.n_atoms} atoms, {N_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s ({os.path.getsize(xtc)} bytes "
          f"of XTC)", flush=True)

    # 4. kernel against plain
    out_yaml = os.path.join(cache, "smoke_order.yaml")
    analysis = aa_analysis(gro, bnd, xtc, out_yaml)
    resid = check_kernel(first_batch(analysis))

    # 5. the main path, end to end
    p2.p2_launches = 0
    timers.reset()
    t0 = time.perf_counter()
    results = gorder_tpu_torch.run(analysis, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = p2.p2_launches
    results.write()
    n_batches = math.ceil(N_FRAMES / BATCH)
    print(f"run: {N_FRAMES} frames in {wall:.3f} s = "
          f"{N_FRAMES / wall:.1f} frames/s end to end on {kind}; device "
          f"work ~{n_batches} x {resid['batch_ms']:.3f} ms = "
          f"{100 * n_batches * resid['batch_ms'] / 1e3 / wall:.1f} % of the "
          f"wall time; phases: {timers.summary()}", flush=True)
    if results.n_analyzed_frames != N_FRAMES:
        raise RuntimeError(f"analyzed {results.n_analyzed_frames} frames, "
                           f"expected {N_FRAMES}")
    if launches != n_batches:
        raise RuntimeError(f"p2_launches {launches} != {n_batches} batches")
    status = bench.validate_output(out_yaml, "aa", N_FRAMES)
    if status is None:
        raise RuntimeError("no pinned golden for the AA cell")
    values = [m.average_order.total.value for m in results.molecules]
    if not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"non-finite average order: {values}")
    print(f"check: p2_launches {launches} == {n_batches} batches; golden "
          f"aa_{N_FRAMES}.yaml: {status}; average order {values}",
          flush=True)

    # 6. UA synth
    t0 = time.perf_counter()
    from tools import bench_modes

    ua_frames = bench_modes.UA_FRAMES
    ua_files = synthesize_ua(cache, ua_frames)
    print(f"synth ua: {ua_frames} frames in {time.perf_counter() - t0:.1f} "
          f"s ({os.path.getsize(ua_files[2])} bytes of XTC)", flush=True)

    # 7. UA kernel against plain: the first real batch, then a synthetic
    # batch with all four categories (the cell has no CH1s)
    ua_real = check_ua_kernel(
        ua_first_batch(ua_analysis("ua", *ua_files)), "ua_3000")
    check_ua_kernel(ua_problem(17, BATCH, 2000, n_types=68), "synthetic")

    # 8. the UA runs, end to end
    ua_launches = run_ua("ua", *ua_files, cache, ua_frames)
    run_ua("ua-palmitoyl", *ua_files, cache, ua_frames)

    print(json.dumps({"kernels": [{
        "name": "p2", "route": "cuda",
        "source": "gorder_tpu_torch/csrc/p2.cu",
        "replaces": "gorder_tpu/ops/pallas_p2.py:163",
        "launches": launches, "max_abs_err": resid["max_abs_err"],
        "ms": resid["ms"], "plain_ms": resid["plain_ms"]}, {
        "name": "ua", "route": "cuda",
        "source": "gorder_tpu_torch/csrc/ua.cu",
        "replaces": "gorder_tpu/ops/pallas_ua.py:69",
        "launches": ua_launches, "max_abs_err": ua_real["max_abs_err"],
        "ms": ua_real["ms"], "plain_ms": ua_real["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
