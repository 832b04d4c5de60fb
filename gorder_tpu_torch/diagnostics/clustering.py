"""Where the clustering classifiers spend a batch on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 -m gorder_tpu_torch.diagnostics.clustering [--frames 512]

The clustering benchmark's bilayer of `chip_smoke.py` (`synthesize_aab`:
256 POPC, heads 2 nm from the midplane) is synthesized for `--frames`
frames (the first frames of the full trajectory), and its P heads are
classified as one batch on the card. Prints the CUDA-event time of the
spectral classifier's stages in the algebra the card runs: the
similarity (`spectral_affinity`), the top-3 subspace (the 12 squarings,
then six `thin_qr3` and their products), one `thin_qr3`, the deflated
span's two directions (`top2_span`), the Laplacian products and the
embedding's k-means (`rayleigh_kmeans`); of the whole spectral call in
both algebras and through the plain versions, and of the spherical
classifier; the host time of the labels' copy and of their orientation
frame after frame; then a `torch.profiler` table of the spectral call's
device time by operation, and last one JSON line with the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def heads_batch(frames: int):
    """(B, M, 3) f32 P-head positions and (B, 3) boxes of the first
    `frames` frames of the clustering bilayer, on the card."""
    import chip_smoke

    from ..io.gro import read_gro
    from ..io.traj import Trajectory

    cache = os.path.join(tempfile.gettempdir(), "gorder_tpu_torch_smoke")
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


def stage_times(heads, box) -> dict:
    """CUDA-event ms of each stage of the spectral classifier (the matmul
    algebra, `core/clustering.py _spectral_chunk`, through the kernels)."""
    import chip_smoke

    from ..core import clustering as cl
    from ..ops import spectral

    def similarity():
        return spectral.spectral_affinity(heads, box, True, cl.PRECISE_SIGMA)

    s_mat, degree = similarity()
    v0 = torch.sqrt(degree)
    v0 = v0 / cl._norm(v0)
    span = cl._top3_subspace(s_mat, v0, spectral.thin_qr3)
    u2 = spectral.top2_span(span, degree)
    lu2 = u2 - s_mat @ u2

    def ms(fn):
        return chip_smoke.cuda_ms(fn, reps=5, warmup=1)

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
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frames", type=int, default=512)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke

    from ..core import clustering as cl

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    heads, box = heads_batch(args.frames)
    index = np.arange(heads.shape[1])
    out = {"frames": heads.shape[0], "heads": heads.shape[1]}
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
