#!/usr/bin/env python3
"""XTC decode rates of the port: the host codec beside the card's decoder.

On the frames of the benchmark's aa-bilayer-256 (made from `--seed` by
`benchmark/synth.py` into `--cache`, the benchmark's own encoder), with the
atoms the `aa-static` analysis selects (the lipids' C and H atoms, their
prefix decoded), in 512-frame batches into buffers touched beforehand:

- the host codec's int16 decode (`Trajectory.read_frames_quantized`, the
  int16 wire's decode thread) and the xtc wire's host read
  (`Trajectory.read_frames_xtc`, a copy of each record) at 1, 2, 4 and 8
  threads and at the host's core count: frames/s, the best of 3 passes;
- the card's decoder (`ops/xtc.py xtc_ints`, `csrc/xtc.cu`): CUDA-event
  ms a batch, the mean of 10 launches after 2, the first batch checked
  against the host codec integer for integer;
  its bound, the batch's rows read and its integers written once at
  3.35 TB/s; the plain version's ms a frame over 2 frames;
- a pageable copy of one batch of each wire to the card (the loop's
  copy), GB/s.

Prints one line a figure and writes them as JSON to `--out`. Needs a card.

Usage: python3 tools/decode_bench.py [--frames 2048] [--seed 2718281828]
       [--cache build/decode_bench] [--out build/decode_bench.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BATCH = 512
PEAK_BYTES_S = 3.35e12


def make_inputs(cache: Path, n_frames: int, seed: int):
    """The first `n_frames` frames of aa-bilayer-256 from `seed` → (xtc
    path, selected atom indices, atom count)."""
    from benchmark import synth
    from benchmark import xtc as bench_xtc

    cfg = json.loads((ROOT / "benchmark" / "configs" / "aa-bilayer-256.json")
                     .read_text())
    system = synth.make_system(cfg, seed, "cuda")
    names = np.asarray(system.names).astype(str)
    lipid = np.asarray(system.resnames) == cfg["resname"]
    sel = np.flatnonzero(lipid & (np.char.startswith(names, "C")
                                  | np.char.startswith(names, "H")))
    cache.mkdir(parents=True, exist_ok=True)
    path = cache / f"aa-{seed}-{n_frames}.xtc"
    if not path.exists():
        part = path.with_suffix(".partial")
        for start, ints in synth.trajectory_chunks(system, seed, n_frames):
            boxes, times, steps = synth.frame_meta(cfg, start, ints.shape[0])
            bench_xtc.append_frames(part, ints.cpu().numpy(), boxes, times,
                                    steps, cfg["precision"],
                                    synth.encoder_threads(),
                                    append=start > 0)
        os.replace(part, path)
    return str(path), sel, system.n_atoms


def best_rate(fn, batches, n_frames, reps=3):
    """Frames/s of the best of `reps` passes of fn over every batch, after
    one warm pass over the first."""
    fn(batches[0])
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        for chunk in batches:
            fn(chunk)
        best = max(best, n_frames / (time.perf_counter() - t0))
    return best


def cuda_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--cache", default=str(ROOT / "build" / "decode_bench"))
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "decode_bench.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("decode_bench needs a CUDA device")

    from gorder_tpu_torch.io import native
    from gorder_tpu_torch.io.traj import AtomSubset, Trajectory
    from gorder_tpu_torch.ops import build, xtc

    _, log = build.build()
    lines = log.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and "xtc_decode" in line:
            for shown in lines[k:k + 4]:
                print("ptxas:", shown.strip(), flush=True)
    cores = len(os.sched_getaffinity(0))
    out = {"card": card_line(), "cores": cores,
           "cpu_count": os.cpu_count(), "frames": args.frames,
           "seed": args.seed}
    print(f"card {out['card']}; host cores {cores} (os.cpu_count "
          f"{os.cpu_count()})", flush=True)

    t0 = time.perf_counter()
    path, sel, n_atoms = make_inputs(Path(args.cache), args.frames,
                                     args.seed)
    print(f"inputs: {path} ({os.path.getsize(path)} bytes) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sub = AtomSubset.from_indices(sel, n_out=(len(sel) + 255) // 256 * 256)
    traj = Trajectory(path, expected_atoms=n_atoms)
    idx = traj.select_frames(None, None, 1)
    n = len(idx)
    batches = [idx[s:s + BATCH] for s in range(0, n, BATCH)]
    stride, mean = traj.xtc_layout(idx)
    out.update(first_n=sub.first_n, n_sel=len(sel), n_out=sub.n_out,
               stride=stride, mean_record=mean)

    q16 = np.empty((BATCH, sub.n_out, 3), np.int16)
    raw = np.empty((BATCH, stride), np.uint8)
    lengths = np.zeros(BATCH, np.int32)
    q16.fill(0)
    raw.fill(0)
    host = {}
    for nt in sorted({1, 2, 4, 8, cores}):
        i16 = best_rate(lambda c: traj.read_frames_quantized(
            c, sub, n_threads=nt, out=q16), batches, n)
        read = best_rate(lambda c: traj.read_frames_xtc(
            c, raw, lengths, n_threads=nt), batches, n)
        host[nt] = {"i16_decode_fps": i16, "xtc_read_fps": read}
        print(f"host {nt} threads: int16 decode {i16:.1f} frames/s, xtc "
              f"read {read:.1f} frames/s", flush=True)
    out["host"] = host

    card = torch.device("cuda")
    slots = torch.as_tensor(sub.slot_of, device=card)
    status = torch.empty(BATCH, dtype=torch.int32, device=card)
    rows = []
    for chunk in batches:
        lengths[:] = 0
        traj.read_frames_xtc(chunk, raw, lengths, n_threads=cores)
        rows.append((torch.from_numpy(raw).to(card),
                     torch.from_numpy(lengths).to(card)))
    want = native.xtc_decode_i32(path, traj.files[0].offsets[batches[0]],
                                 sub.first_n, slot_of=sub.slot_of,
                                 n_out=sub.n_out, n_threads=cores)[0]
    moved = BATCH * stride + BATCH * sub.n_out * 12 + BATCH * 8
    got = xtc.xtc_ints(*rows[0], slots, sub.first_n, sub.n_out, status)
    torch.cuda.synchronize()
    if not (np.array_equal(got.cpu().numpy()[:len(batches[0])], want)
            and not status.any()):
        sys.exit("the card's decode differs from the host codec")
    ms = [cuda_ms(lambda r=r: xtc.xtc_ints(
        *r, slots, sub.first_n, sub.n_out, status)) for r in rows]
    out["card_decode"] = {"ms_per_batch": float(np.mean(ms)),
                          "ms_per_batch_each": ms,
                          "fps": BATCH / (np.mean(ms) / 1e3)}
    print(f"card decode: {np.mean(ms):.4f} ms a batch (batches "
          f"{', '.join(f'{m:.4f}' for m in ms)}) = "
          f"{BATCH / (np.mean(ms) / 1e3):.1f} frames/s; equal to the host "
          f"codec", flush=True)
    bound_ms = moved / PEAK_BYTES_S * 1e3
    out["bound_ms"] = bound_ms
    print(f"card decode bound (rows read, integers written once at 3.35 "
          f"TB/s): {bound_ms:.4f} ms a batch", flush=True)

    r0, l0 = (t.cpu().numpy() for t in rows[0])
    st = torch.empty(2, dtype=torch.int32)
    t0 = time.perf_counter()
    xtc.xtc_ints(torch.from_numpy(r0[:2].copy()), torch.from_numpy(l0[:2]),
                 torch.from_numpy(sub.slot_of), sub.first_n, sub.n_out, st)
    plain = (time.perf_counter() - t0) / 2 * 1e3
    out["plain_ms_per_frame"] = plain
    print(f"plain version (Python, host): {plain:.1f} ms a frame", flush=True)

    copies = {}
    for name, a in (("i16", q16), ("xtc", raw)):
        ms = cuda_ms(lambda a=a: torch.from_numpy(a).to(card), reps=5)
        copies[name] = {"bytes": a.nbytes, "ms": ms,
                        "gbps": a.nbytes / ms / 1e6}
        print(f"pageable copy of one {name} batch ({a.nbytes} bytes): "
              f"{ms:.3f} ms = {a.nbytes / ms / 1e6:.2f} GB/s", flush=True)
    out["copies"] = copies
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
