"""Drive the runs whose dense neighbour kernels (`ops/neighbors.py`:
`normal_cloud`, `local_sums`) sit on their path, end to end, and check the
kernels on each run's first batch, with the package of any checkout, so
that two versions can be compared in one call on one card.

Run from the repository root on a machine with a CUDA card:

    python3 gorder_tpu_torch/diagnostics/neighbors.py [--root TREE] \
        [--cache DIR] [--repeat N]

TREE (default: this checkout) names the checkout whose `chip_smoke.py` and
`gorder_tpu_torch` are imported, such as an earlier commit unpacked with
`git archive`; run each tree in its own process, in turns (parent, change,
change, parent). DIR holds `chip_smoke.py`'s synthesized AA membrane and
CG vesicle (made on the first call, reused after; default: the cache
`chip_smoke.py` uses). Each of `aa-dynamic` (b7, 10,000 frames),
`aa-local-leaflets` (int16) and `ves-spherical` (1,000 frames, the pick's
wire) runs N times through `gorder_tpu_torch.run`, after
`chip_smoke.first_calls`; each run prints its frames/s and phase times.
Then `chip_smoke.check_normals` and `check_local` hold the kernels against
their plain versions on the first batch of each run's last repeat and time
them. Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

#: the runs, in order: (label, the check of the first batch)
RUNS = (("aa-dynamic", "check_normals"), ("aa-local-leaflets", "check_local"),
        ("ves-spherical", "check_normals"))


def run_once(analysis, n_frames: int, wire=None) -> tuple:
    """One `gorder_tpu_torch.run` on the card, `wire` forced if given. →
    (frames/s, phase seconds, the first batch's `DeviceBatch`)."""
    import chip_smoke
    import torch

    import gorder_tpu_torch
    from gorder_tpu_torch.utils.timers import timers

    first = []
    timers.reset()
    with chip_smoke.forced_wire(wire):
        t0 = time.perf_counter()
        results = gorder_tpu_torch.run(
            analysis, device="cuda",
            on_batch=lambda db: first.append(db) if db.index == 0 else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if results.n_analyzed_frames != n_frames:
        raise RuntimeError(f"analyzed {results.n_analyzed_frames} frames, "
                           f"expected {n_frames}")
    return n_frames / wall, timers.snapshot(), first[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="the checkout whose chip_smoke.py and gorder_tpu_torch run")
    parser.add_argument("--cache", default=os.path.join(
        tempfile.gettempdir(), "gorder_tpu_torch_smoke"),
        help="directory of the synthesized inputs")
    parser.add_argument("--repeat", type=int, default=2,
                        help="runs of each configuration")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("neighbors: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from gorder_tpu_torch.engine.prepare import load_structure
    from gorder_tpu_torch.ops import build

    print(f"tree {root}: chip_smoke from {chip_smoke.__file__}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    os.environ["GORDER_TPU_MESH"] = "0"
    t0 = time.perf_counter()
    build.build()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    cache = args.cache
    os.makedirs(cache, exist_ok=True)
    t0 = time.perf_counter()
    gro, bnd, _ = chip_smoke.synthesize_structure(cache)
    system = load_structure(
        chip_smoke.aa_analysis(gro, bnd, os.path.join(cache, "missing.xtc")))
    xtc = chip_smoke.synthesize_trajectory(cache, system, chip_smoke.N_FRAMES)
    ves = chip_smoke.synthesize_vesicle(cache, chip_smoke.VESICLE_FRAMES)
    print(f"synth: {time.perf_counter() - t0:.1f} s", flush=True)

    def yaml(label):
        return os.path.join(cache, f"neighbors_{label}.yaml")

    analyses = {
        "aa-dynamic": (chip_smoke.normals_analysis(
            "aa-dynamic", gro, bnd, xtc, cache, yaml("aa-dynamic")), "b7",
            chip_smoke.N_FRAMES),
        "aa-local-leaflets": (chip_smoke.leaflet_analysis(
            "aa-local-leaflets", gro, bnd, xtc, cache,
            yaml("aa-local-leaflets")), "i16", chip_smoke.N_FRAMES),
        "ves-spherical": (chip_smoke.vesicle_analysis(
            ves, yaml("ves-spherical"), spherical=True), None,
            chip_smoke.VESICLE_FRAMES)}
    chip_smoke.first_calls()
    out = {"tree": root, "runs": [], "kernels": {}}
    for label, check in RUNS:
        analysis, wire, n_frames = analyses[label]
        for rep in range(args.repeat):
            rate, phases, first = run_once(analysis, n_frames, wire)
            print(f"run {label} #{rep}: {n_frames} frames, {rate:.1f} "
                  f"frames/s end to end; phases: "
                  + " | ".join(f"{k} {v:.3f}s" if isinstance(v, float)
                               else f"{k} {v}" for k, v in phases.items()),
                  flush=True)
            out["runs"].append(dict(label=label, rep=rep, frames=n_frames,
                                    frames_per_s=rate, phases=phases))
        got = getattr(chip_smoke, check)(label, first)
        if isinstance(got, dict):
            out["kernels"][label] = got
        del first
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
