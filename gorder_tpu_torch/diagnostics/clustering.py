"""Where the clustering classifiers spend a batch on one CUDA card, and
the clustering runs end to end, with the package of any checkout, so that
two versions of the spectral kernels can be compared in one call on one
card.

Run from the repository root on a machine with a CUDA card:

    python3 gorder_tpu_torch/diagnostics/clustering.py [--root TREE] \
        [--cache DIR] [--frames 512] [--runs N]

TREE (default: this checkout) names the checkout whose `gorder_tpu_torch`
is imported, such as an earlier commit unpacked with `git archive`; the
measuring code (the synthesis, the tolerances, the timers) is this
checkout's `chip_smoke.py` for every tree. Run each tree in its own
process, in turns (parent, change, change, parent). The clustering
benchmark's bilayer of `chip_smoke.py` (`synthesize_aab`: 256 POPC, heads
2 nm from the midplane) is synthesized into DIR for `--frames` frames
(the first frames of the full trajectory; made on the first call, reused
after; default: the cache `chip_smoke.py` uses), and its P heads are
classified as one batch on the card.

First the similarity (`spectral_affinity`) and the k-means
(`rayleigh_kmeans`) are held against their plain versions on the batch:
S and the degrees within `chip_smoke.py`'s SPECTRAL_S_RTOL and
SPECTRAL_DEGREE_RTOL, the labels of every frame equal (and, where the
tree's wrapper reports them, the k-means steps each frame took: min,
median, max). Then prints the CUDA-event time of the spectral classifier's
stages in the algebra the card runs: the similarity, the top-3 subspace
(the 12 squarings, then six `thin_qr3` and their products), one
`thin_qr3`, the deflated span's two directions (`top2_span`), the
Laplacian products and the embedding's k-means, and the device time of
the similarity's and the k-means' calls queued on the card
(`chip_smoke.device_ms`); of the whole spectral call in both algebras and
through the plain versions, and of the spherical classifier; the host
time of the labels' copy and of their orientation frame after frame; and
a `torch.profiler` table of the spectral call's device time by
operation. Then, with N > 0 (default 2), `aa-clustering-leaflets`
(int16) and `aa-clustering-leaflets-every10` (b7) run N times each over
`chip_smoke.py`'s N_FRAMES frames of the bilayer (synthesized into DIR
on the first call, ~2 min) through `gorder_tpu_torch.run`, each printing
its frames/s and phase times. Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: this checkout
HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def heads_batch(frames: int, cache: str):
    """(B, M, 3) f32 P-head positions and (B, 3) boxes of the first
    `frames` frames of the clustering bilayer, on the card."""
    import chip_smoke
    from gorder_tpu_torch.io.gro import read_gro
    from gorder_tpu_torch.io.traj import Trajectory

    os.makedirs(cache, exist_ok=True)
    gro, _, xtc = chip_smoke.synthesize_aab(cache, frames)
    system = read_gro(gro)
    heads = np.nonzero(system.atom_names == "P")[0]
    traj = Trajectory(xtc)
    coords, boxes, _, _ = traj.read_frames(
        traj.select_frames(None, None, 1), system.n_atoms)
    box = np.ascontiguousarray(boxes[:, [0, 1, 2], [0, 1, 2]])
    return (torch.as_tensor(np.ascontiguousarray(coords[:, heads]),
                            device="cuda"),
            torch.as_tensor(box, device="cuda"))


def kernel_checks(heads, box) -> dict:
    """The similarity and the k-means against their plain versions on the
    batch; raises where they disagree. → the k-means steps' min, median
    and max where the tree's wrapper reports them."""
    import chip_smoke
    from gorder_tpu_torch.core import clustering as cl
    from gorder_tpu_torch.ops import spectral

    s_mat, degree = spectral.spectral_affinity(heads, box, True,
                                               cl.PRECISE_SIGMA)
    want_s, want_degree = spectral.spectral_affinity_plain(
        heads, box, True, cl.PRECISE_SIGMA)
    d_err = (degree - want_degree).abs()
    s_err = (s_mat - want_s).abs()
    if bool((d_err > chip_smoke.SPECTRAL_DEGREE_RTOL * want_degree.abs())
            .any() or (s_err > chip_smoke.SPECTRAL_S_RTOL * want_s.abs()
                       + chip_smoke.TINY_F32).any()):
        raise RuntimeError(f"similarity off by up to {float(s_err.max())}, "
                           f"degrees {float(d_err.max())}")
    out = {"s_max_abs_err": float(s_err.max()),
           "degree_max_abs_err": float(d_err.max())}
    v0 = torch.sqrt(want_degree)
    v0 = v0 / cl._norm(v0)
    span = cl._top3_subspace(want_s, v0, spectral.thin_qr3_plain)
    u2 = spectral.top2_span_plain(span, want_degree)
    lu2 = u2 - want_s @ u2
    want = spectral.rayleigh_kmeans_plain(u2, lu2, cl.KMEANS_ITERS)
    kwargs = {}
    if "steps" in inspect.signature(spectral.rayleigh_kmeans).parameters:
        kwargs["steps"] = torch.empty(u2.shape[0], dtype=torch.int32,
                                      device=u2.device)
    labels = spectral.rayleigh_kmeans(u2, lu2, cl.KMEANS_ITERS, **kwargs)
    differ = int((labels != want).any(1).sum())
    if differ:
        raise RuntimeError(f"k-means labels differ from plain's in {differ} "
                           f"frames")
    out["kmeans_frames_equal"] = int(labels.shape[0])
    if kwargs:
        steps = kwargs["steps"].cpu()
        out["kmeans_steps"] = [int(steps.min()), int(steps.median()),
                               int(steps.max())]
    return out


def stage_times(heads, box) -> dict:
    """CUDA-event ms of each stage of the spectral classifier (the matmul
    algebra, `core/clustering.py _spectral_chunk`, through the kernels)."""
    import chip_smoke
    from gorder_tpu_torch.core import clustering as cl
    from gorder_tpu_torch.ops import spectral

    def similarity():
        return spectral.spectral_affinity(heads, box, True, cl.PRECISE_SIGMA)

    s_mat, degree = similarity()
    v0 = torch.sqrt(degree)
    v0 = v0 / cl._norm(v0)
    span = cl._top3_subspace(s_mat, v0, spectral.thin_qr3)
    u2 = spectral.top2_span(span, degree)
    lu2 = u2 - s_mat @ u2

    def ms(fn):
        return chip_smoke.cuda_ms(fn, reps=20, warmup=3)

    return {
        "similarity": ms(similarity),
        "top3_subspace": ms(
            lambda: cl._top3_subspace(s_mat, v0, spectral.thin_qr3)),
        "thin_qr3_of_one_iteration": ms(
            lambda: spectral.thin_qr3(s_mat @ span)),
        "top2_span": ms(lambda: spectral.top2_span(span, degree)),
        "laplacian_products": ms(lambda: u2 - s_mat @ u2),
        "rayleigh_kmeans": ms(lambda: spectral.rayleigh_kmeans(
            u2, lu2, cl.KMEANS_ITERS)),
        "similarity_device": chip_smoke.device_ms(similarity),
        "rayleigh_kmeans_device": chip_smoke.device_ms(
            lambda: spectral.rayleigh_kmeans(u2, lu2, cl.KMEANS_ITERS)),
    }


def end_to_end(cache: str, repeat: int) -> list:
    """`aa-clustering-leaflets` (int16) and its every-10th-frame run (b7),
    `repeat` times each over N_FRAMES frames of the bilayer. → one dict a
    run: label, frames/s, phase seconds."""
    import chip_smoke
    from gorder_tpu_torch.diagnostics.neighbors import run_once

    t0 = time.perf_counter()
    aab = chip_smoke.synthesize_aab(cache, chip_smoke.N_FRAMES)
    print(f"synth aab: {chip_smoke.N_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    for label, wire in (("aa-clustering-leaflets", "i16"),
                        ("aa-clustering-leaflets-every10", "b7")):
        analysis = chip_smoke.leaflet_analysis(
            label, *aab, cache, os.path.join(cache, f"clustering_{label}.yaml"))
        for rep in range(repeat):
            rate, phases, _ = run_once(analysis, chip_smoke.N_FRAMES, wire)
            print(f"run {label} #{rep}: {chip_smoke.N_FRAMES} frames, "
                  f"{rate:.1f} frames/s end to end; phases: "
                  + " | ".join(f"{k} {v:.3f}s" for k, v in phases.items()),
                  flush=True)
            runs.append(dict(label=label, rep=rep, frames_per_s=rate,
                             phases=phases))
    return runs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=HERE,
                        help="the checkout whose gorder_tpu_torch runs")
    parser.add_argument("--cache", default=os.path.join(
        tempfile.gettempdir(), "gorder_tpu_torch_smoke"),
        help="directory of the synthesized bilayer")
    parser.add_argument("--frames", type=int, default=512)
    parser.add_argument("--runs", type=int, default=2,
                        help="end-to-end runs of each clustering run")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("clustering: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    os.environ["GORDER_TPU_MESH"] = "0"
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # this checkout's chip_smoke.py measures every tree
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = chip_smoke
    spec.loader.exec_module(chip_smoke)
    from gorder_tpu_torch.core import clustering as cl
    from gorder_tpu_torch.ops import build

    print(f"tree {root}: gorder_tpu_torch from "
          f"{os.path.dirname(os.path.dirname(cl.__file__))}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    build.build()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    heads, box = heads_batch(args.frames, args.cache)
    index = np.arange(heads.shape[1])
    out = {"tree": root, "frames": heads.shape[0], "heads": heads.shape[1]}
    out.update(kernel_checks(heads, box))
    out.update(stage_times(heads, box))
    for algebra in ("matmul", "eigh"):
        fn = cl.make_spectral_labels(index, device="cuda", algebra=algebra)
        out[f"spectral_{algebra}"] = chip_smoke.cuda_ms(
            lambda f=fn: f(heads, box), reps=3, warmup=1)
    spectral = cl.make_spectral_labels(index, device="cuda")
    out["spectral_matmul_plain"] = chip_smoke.cuda_ms(
        lambda: spectral.plain(heads, box), reps=2, warmup=1)
    spherical = cl.make_spherical_classifier(index, device="cuda")
    out["spherical"] = chip_smoke.cuda_ms(lambda: spherical(heads, box),
                                          reps=5, warmup=1)
    labels = spectral(heads, box)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = labels.cpu().numpy()
    out["labels_to_host_host_ms"] = (time.perf_counter() - t0) * 1e3
    orienter = cl.SpectralOrienter(index)
    t0 = time.perf_counter()
    for frame in host:
        orienter.orient(frame)
    out["orient_host_ms"] = (time.perf_counter() - t0) * 1e3
    for key, value in out.items():
        print(f"{key}: {value}", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        spectral(heads, box)
        torch.cuda.synchronize()
    table = prof.key_averages()
    try:
        print(table.table(sort_by="device_time_total", row_limit=20))
    except (AttributeError, KeyError):
        print(table.table(sort_by="cuda_time_total", row_limit=20))
    if args.runs > 0:
        out["runs"] = end_to_end(args.cache, args.runs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
