#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

Run from the repository root on a machine with a CUDA card (an H100: the
kernels are built for sm_90a):

    python3 chip_smoke.py

It imports nothing of JAX or of `gorder_tpu`. The runs that rode int16
before the bytes pick preferred s6 and d8 keep int16, forced with
GORDER_TPU_WIRE=i16, and the runs that check a b7 kind force b7 (on the
card the link-rate pick takes int16), so that their kernel variants stay
on the path; phases 27-31 drive the s6, d8 and i12 wires, 32 the pick.
Every phase but 33 runs with GORDER_TPU_MESH=0, on one card. Phases, one
line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds `gorder_tpu_torch/csrc/*.cu`;
3. kernel ua synthetic: the UA kernel against its plain PyTorch version on
   a synthetic batch with all four carbon categories (B = 512), for int16
   and f32 positions, without and with seeded leaflet classes: the int64
   outputs must be equal; CUDA-event times of both;
4. synth: the AA benchmark membrane of bench.py (256 POPC, 64.5k atoms,
   10,000 XTC frames, seeds 7 and 11), synthesized byte for byte like
   bench.py does, through the port's own host modules; cached in the
   temporary directory;
5. run aa: `gorder_tpu_torch.run(analysis, device="cuda")` over all 10,000
   frames; the YAML must pass `bench.validate_output` against
   `tools/bench_golden/aa_10000.yaml`, and the P2 kernel must have been
   launched once per batch. Then the P2 kernel against its plain version
   on the first batch (B = 512) exactly as the run handed it to its step
   (`run(..., on_batch=...)`): the packed b7 wire, which the kernel
   unpacks itself, int64 (B, 2, T) outputs equal; CUDA-event times of
   both, and the kernel's time being the batch's whole device work;
6. run aa-leaflets ... aa-fromfile-leaflets: the seven AA leaflet modes of
   tools/bench_modes.py over the same 10,000 frames; each YAML must pass
   `bench.validate_output` against its golden (the lines off by a print
   quantum, if any, counted by key), and the with_leaflets P2 kernel must
   have been launched once per batch. Then that kernel against its plain
   version on the first batch of `aa-leaflets` (the b7 wire, with the
   classes from the decoder's head and COG channels) and of
   `aa-local-leaflets` (int16 positions, also dequantized as f32 input,
   with the local classes), and the plain variant on the latter: the int64
   outputs must be equal, and b7 and int16 must give the same sums. The
   local classifier's sums are the neighbour kernel `local_sums`
   (csrc/neighbors.cu), launched once per batch: against its plain
   version on aa-local-leaflets' first batch, the classes of every frame
   equal (and the step's), the sums within NEIGHBOR_SUM_BOUND; CUDA-event
   times of both, and of each every-frame classifier a batch;
7. run aa-dynamic, aa-dynamic-export, aa-manual-z: first, the wall time
   of the process's first batched 3x3 eigh and first `normal_cloud`
   launch on a small input, and of each again (`first_calls`), so that no
   run below pays a one-time start; then the AA analysis with
   dynamic membrane normals on the P heads (tools/bench_modes.py), with
   and without their export, over the same 10,000 frames, riding b7x and
   passing their goldens, and with an inline manual map of (0, 0, 1) for
   every molecule and frame, riding int16 and equal to `aa_10000.yaml`
   exactly; the per_bond_normal P2 kernel must have been launched once
   per batch. The exported file must hold 10,000 x 256 finite unit
   vectors, its first rows those the first batch's step used. Then that
   kernel against its plain version with the normals each step used, on
   the first batch of `aa-dynamic` (b7), of `aa-manual-z` (int16 and f32),
   and of `aa-dynamic` with `aa-leaflets`' classes; and the CUDA-event
   time of the dynamic normals of a batch. The normals' counts and
   covariances are the neighbour kernel `normal_cloud`, launched once per
   batch: against its plain version on aa-dynamic's first batch (the b7x
   aux atoms), the counts equal, the covariances within the bound, the
   normals within 1 - |n.n'| <= 1e-5 of the plain ones', a second launch
   bit-equal; then both neighbour kernels against their plain versions on
   a synthetic batch at minimum-image ties (`check_neighbor_ties`);
8. synth ua: the UA benchmark membrane of tools/bench_modes.py (256
   Berger-like POPC, 44.3k atoms, 3,000 XTC frames, seed 29), synthesized
   byte for byte likewise;
9. run ua, run ua-palmitoyl: `gorder_tpu_torch.run` over all 3,000 frames
   for both UA analyses of tools/bench_modes.py; each YAML must pass
   `bench.validate_output` against `tools/bench_golden/ua_3000.yaml` and
   `ua-palmitoyl_3000.yaml`, and the UA kernel must have been launched
   once per batch and carbon category. Then the UA kernel against plain
   on the `ua` run's first batch, int16 and f32;
10. run ua-leaflets: the `ua` analysis with global leaflets; no golden is
   pinned for it, so its total order parameters must equal the `ua` run's
   exactly, its upper and lower ones must be finite, and the
   with_leaflets UA kernel must have been launched once per batch and
   category. Then that kernel against plain on the run's first batch
   (int16 with the decoder's COG), with the classes its step used;
11. run ua-dynamic: the `ua` analysis with dynamic normals on the P heads,
   riding int16; no golden is pinned, so its totals must be finite, and
   the per_bond_normal UA kernel must have been launched once per batch
   and category, the normals' kernel once per batch. Then that kernel
   against plain on the run's first batch
   with the normals its step used, and, for both kernels, per-molecule
   normals that are all (0, 0, 1) against the static normal on the `aa`
   and `ua` first batches: equal bit for bit;
12. run aa-ordermap, aa-ordermap-leaflets: the `aa` analysis with an
   ordermap (static z normal, the default xy plane, 0.1 nm bins, auto
   spans: 131 x 131 tiles), alone and with global leaflets, riding int16
   (with the decoder's COG for the leaflets); each YAML must pass
   `bench.validate_output` against `aa_10000.yaml` / `aa-leaflets_10000
   .yaml` (the pair formulation of map runs may move a sample by one
   quantum: the lines off are printed), the map state must hold every
   sample of the run's type sums, per class, exactly (its entries, the
   dump included, sum to the type sums' Σq and counts), and the map
   directory must hold the expected files, each with 131 x 131 tile
   lines. Then the pair_quantized P2 kernel with its map output against
   the plain version on each run's first batch, for the type sums and a
   freshly zeroed map state, in int64: int16 and f32 (dequantized), with
   the classes the step used, and with `aa-dynamic`'s normals; and the
   pair_quantized int16 type sums without a map;
13. run ua-ordermap: the `ua` analysis with the same map on the UA box
   (93 x 93 tiles), likewise against `ua_3000.yaml`, with the UA kernel's
   map output against plain on its first batch, int16 and f32;
14. run aa-geometry, aa-geometry-i16: tools/bench_modes.py's geometry
   mode (a cylinder of radius 4 nm along z around the per-frame center of
   `resname POPC`) over the same 10,000 frames, riding b7 with the
   decoder's geometry bitplane (b7geo), and forced onto int16 (the `i16G`
   kind, the same bitplane); both YAMLs must pass `bench.validate_output`
   against `aa-geometry_10000.yaml`, and the with_geom P2 kernel must have
   been launched once per batch. Then that kernel against its plain
   version on each run's first batch, with the bitplane the step was
   given: the b7 wire as handed over, with `aa-leaflets`' classes and
   with `aa-dynamic`'s normals; int16, f32 (dequantized), and the
   pair_quantized int16 input with a map output into a freshly zeroed
   state, whose entries, the dump included, must sum to the batch's
   inside-only type sums;
15. run ua-geometry, ua-geometry-invert: the `ua` analysis with the same
   cylinder, and inverted, over the 3,000 UA frames on int16; no golden
   is pinned, so per bond type the int64 sums and counts of the two runs
   must add up to the `ua` run's exactly, and the UA kernel's geometry
   test must have been launched once per batch and category. Then that
   kernel against plain on the first batch, int16 and f32, with the
   reference the step computed from the batch;
16. synth aab: tools/bench_modes.py's clustering bilayer
   (`synth_aa_bilayer`: bench.py's lipid, 256 POPC, 64.5k atoms, box 13 x
   13 x 11 nm, heads 2 nm from the midplane, chains inward, seed 31,
   10,000 frames), synthesized byte for byte likewise, once the AA
   trajectory is no longer needed;
17. run aa-clustering-leaflets: spectral clustering on the P heads over
   every frame (int16; labels oriented into leaflets on the host); its
   YAML must pass `bench.validate_output` against its golden and the
   with_leaflets P2 kernel must have been launched once per batch, the
   spectral classifier's kernels (csrc/spectral.cu) once per batch each
   but the thin QR, six times. Then that P2 kernel against plain on the
   first batch with the classes the step used; `check_spectral`: each
   spectral kernel against its plain version on that batch's 256 heads
   (the similarity and degrees within their ulp bounds, the QR on the
   chain's start basis and on the filter's ill-conditioned `gp @ q` and
   the deflated span's two directions by orthonormality and projectors
   within 1e-5, the k-means labels of every frame equal to the plain 100
   steps' and to the plain fixed point's, with the centroid updates each
   frame ran), with CUDA-event times of kernel, plain and, for the QR and
   the span, `torch.linalg.qr` and `torch.linalg.svd`, each kernel's
   device time (`device_ms`: its calls queued on the card), each bound
   (the k-means' over 100 steps and over the steps the batch needs) and
   share, and the whole call's device operations and time; and the
   classifier's CUDA-event time a batch in both algebras (the matmul
   branch the card runs, and batched `eigh`) and through the plain
   versions, the raw labels of every frame equal to the plain chain's and
   the CPU's (the other algebra's counted). Then every 10th frame (b7
   with the host class plane): its totals must equal the every-frame
   run's;
18. run aa-spherical-leaflets: spherical clustering on the aa membrane
   (int16, the classifier with the step), against its golden, with the
   same kernel check and classifier time; and the `ua` analysis with
   spherical leaflets, whose totals must equal the `ua` run's. The
   clustering phases first assert that f32 matmuls run in full precision
   (TF32 off);
19. run aa-sharded, aa-clustering-sharded: `aa` as 3 frame shards through
   `Analysis.run_partial(i, 3)` on the card, each state written with
   `save_partial` and read back with `load_partial`, then `Analysis
   .merge`: the merged YAML must equal phase 5's byte for byte; and
   `aa-clustering-leaflets` as 2 shards, whose shard 1 orients its
   clusters against global frame 0's: equal to phase 17's YAML byte for
   byte. The kernel must have been launched once per shard batch (the
   spectral kernels also once for shard 1's frame 0);
20. run aa-palmitoyl: the sn-1 chain of the AA membrane (tools/
   bench_modes.py's aa-palmitoyl) as pygorder code runs it: `import
   gorder_tpu_torch.compat as gorder`, `gorder.Analysis(...,
   analysis_type=gorder.analysis_types.AAOrder(...))` and `.run()` with no
   argument, on the card by default; its YAML must pass
   `aa-palmitoyl_10000.yaml`, with one P2 launch (b7) per batch;
21. run aa-concat: `aa` over the AA XTC split in two files at frame 4,000
   (byte copies of the frame records, by `native.xtc_scan`'s offsets): its
   YAML must equal phase 5's but the header line;
22. run aa-window, aa-window-file: `aa` with begin 20,000 ps, end 79,990
   ps and step 3 (2,000 frames, selected here from the frame times), and
   `aa` over an XTC of just those frames (byte copies): equal YAMLs but
   the header;
23. synth cg: tools/bench_modes.py's CG membrane (`synth_cg`: 512
   Martini-like POPC, 16,800 beads, box 12.8 x 12.8 x 10.0, 10,000 XTC
   frames, seed 23), synthesized byte for byte likewise;
24. run cg: the CG analysis through the pygorder drop-in, `.run()` with no
   argument; its YAML must pass `cg_10000.yaml` with one P2 launch (b7)
   per batch, and every molecule's `average_order().total().value()` and
   bond's `order().total().value()` must print as the YAML's values;
25. run cg-errors: the same with `estimate_error.EstimateError(n_blocks=5,
   output_convergence=...)` and TAB, CSV and XVG output: every `value()`
   equal to phase 24's, every `error()` finite, each molecule's
   convergence curve ending at its average order at 4 decimals, and the
   TAB, CSV and per-molecule XVG files holding the YAML's values;
26. run cg-xtc, cg-trr: the first 1,024 CG frames as read back from the
   XTC, written as a single-precision TRR (`write_trr`), run on the f32
   wire (one `p2_positions_f32` launch per batch), whose YAML must pass
   `bench.validate_output`'s tolerance against `cg` over the same 1,024
   frames of the XTC (`end` at the last one's time); then that kernel
   against its plain version on the TRR run's first batch;
27. run ua-d8, ua-s6: the `ua` analysis forced onto d8 and onto s6, the
   int32 XTC integers (`ua_positions_i32`, one launch a batch and
   category): each YAML must equal the int16 `ua` run's line for line;
   each decoder on the card against the CPU's on the run's first batch,
   integer for integer, with its CUDA-event time; the int32 UA kernel
   against plain on the d8 run's first batch;
28. run aa-ordermap-d8: `aa-ordermap` forced onto d8
   (`p2_positions_i32_pair` with its map): the YAML and every file of its
   map directory must equal the int16 run's byte for byte, the map hold
   the run's samples exactly; then that kernel against plain on its first
   batch, int32 and f32;
29. run cg-i16, cg-i12: the first 1,024 CG frames re-encoded at precision
   100, Martini's published compressed-x-precision, forced onto int16 and
   onto i12 (12-bit packed, unpacked to int16 on the card): every batch
   rides the wire forced, and the YAMLs are equal line for line;
30. synth ves: a CG vesicle (`synthesize_vesicle`: the CG lipid, 4,350
   heads on a 15.0 nm shell with chains inward and 2,300 on an 11.0 nm
   shell with chains outward, "W" water to 150,000 beads, a 36.0 nm box
   whose XTC integers overflow int16, 1,000 frames, seed 37);
31. run ves, ves-spherical, ves-spherical-{s6|d8}, ves-spherical-f32,
   ves-spherical-traced, ves-chain: CGOrder of the vesicle on b7
   (`p2_b7`), and with spherical leaflets and dynamic normals on PO4
   (radius 2.0 nm) every frame, which must ride the pick's s6 or d8
   (`p2_positions_i32` with classes and normals), with finite values in
   every class; its decoder against the CPU's and the kernel against plain
   on its first batch, and the normals' kernel against its plain version
   there (6,650 heads over 6,650 PO4 a frame; one launch a batch in each
   vesicle run), with the eigensolve's time; forced onto the other of s6
   and d8, an equal YAML
   (s6 keeps each residue's median a frame in int16: where that overflows,
   the pick falls to d8, as printed); forced onto f32, the difference of
   its values from the integer wire's is printed (what the port gave on
   such a box before it had s6 and d8); traced with torch.profiler
   (GORDER_TPU_PROFILE), equal YAML, its top device operations and busy
   share printed; then its first 64 frames on the card and on the CPU:
   the decoded integers and the classes equal, and the card's int64 sums
   equal to the CPU plain step's with the card's normals (the CPU's own
   normals, from another eigensolver, and its sums' difference printed);
32. pick: `aa`, `ua` and `cg` with no GORDER_TPU_WIRE: the measured link
   rate, the pick's log line (link, host int16 rate), the wire it took,
   frames/s, each golden, and the P2 kernel against plain on the first
   batch of the input it fed;
33. mesh: `aa` (b7), `ua` (int16) and `ua` on d8 with
   `parallel.context.visible_devices` giving two copies of cuda:0: the
   "data-parallel over 2 devices" line, two launches a batch (UA: a
   category), each YAML byte for byte the single run's, and each slice of
   the first batch equal to the plain version on its own inputs; with
   more than one card visible, `aa` over all of them too;
34. knobs: GORDER_TPU_BATCH_SIZE=256 on `aa` (40 batches, the same YAML),
   GORDER_TPU_B7_LEAFLETS=0 on `aa-leaflets` and GORDER_TPU_GEO_CHANNEL=0
   on `aa-geometry`, each with b7 asked for (int16, no decoder side
   channel, against the golden), GORDER_TPU_PREFETCH=2 on `ua` (the same
   YAML).

The phases run in the order 1-7, 18, 19 (aa), 14, 12, 28, 20-22, 8, 9,
27, 10, 11, 18 (ua), 13, 15, 23-26, 29, 32-34, 30, 31, 16, 17, 19
(clustering), and
the total time is printed. Then one JSON line with the kernels of the
path (with each one's bound: the least time the card could take, from
the bytes it must move at the H100's 3.35 TB/s and its f32 operations at
67 TFLOP/s), and last the result line `{"ok": true, "device": {...}}`.
Any failure raises and exits non-zero.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""

import collections
import contextlib
import dataclasses
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_FRAMES = 10_000
BATCH = 512
HEAVY = "resname POPC and name r'^C'"
HYDROGENS = "resname POPC and name r'^H'"
P_HEADS = "resname POPC and name P"
#: the AA leaflet modes of tools/bench_modes.py with a pinned golden on
#: bench.py's membrane but the clustering ones, which run apart (phases
#: 17-18; `leaflet_analysis` builds them too)
LEAFLET_MODES = ("aa-leaflets", "aa-leaflets-export", "aa-leaflets-every10",
                 "aa-leaflets-once", "aa-local-leaflets",
                 "aa-individual-leaflets", "aa-fromfile-leaflets")

# The bound of a kernel: the larger of its bytes (each input read once,
# each output written once) over the H100's memory rate and its f32
# operations over the card's f32 rate outside the tensor cores (NVIDIA's
# data sheet, SXM part at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations of each kernel's chain, counted from the sources: a P2
# sample (p2.cu: the dequantize or difference 3-6, min image 12, proj 5,
# d2 5, cos2 3, S 2), and a UA carbon with all its hydrogens (ua.cu: the
# prediction plus, per hydrogen, wrap 12, min image 12, proj 5, d2 6,
# S 4; a square root, atan2, cos or sin counted as one).
P2_OPS = 33
UA_OPS = {"ch3": 323, "ch2": 257, "ch1u": 232, "ch1s": 142}
# what the per_bond_normal variants add (p2.cu, ua.cu, common.cuh
# normal_norm2): n2 = max((nx·nx + ny·ny) + nz·nz, 1e-18) once per sample
# (P2) or carbon (UA), 6, and one product d2·n2 per sample, 1
P2_NORMAL_OPS = 7
UA_NORMAL_OPS = {cat: 6 + k for cat, k in
                 (("ch3", 3), ("ch2", 2), ("ch1u", 1), ("ch1s", 1))}
# what the map output adds per sample (common.cuh MapTable, p2.cu, ua.cu):
# the bond midpoint 6, each plane component's tile 4 (subtract, divide,
# add, floor); and the pair_quantized input's dequantization of both
# positions, 3 more than the single rounding
MAP_OPS = 14
PAIR_OPS = 3
# what the geometry test adds per UA sample (ua.cu, common.cuh
# geo_inside), for the chip runs' cylinder of infinite span: the bond
# position 6, the offset from the reference 3, two minimum images 8 and the
# radial distance 3. The P2 kernel reads a bit per bond and computes only
# the samples inside, so its bound counts those (P2_OPS each).
GEO_OPS = 20
# f32 operations of the neighbour functions (csrc/neighbors.cu), counted
# from the source. normal_cloud, per (head, cloud atom) pair, once: the
# offset 3, the minimum image 12 (divide, round, multiply, subtract a
# component; none without PBC), d2 5 and the test 1; per masked pair, the
# count and the three sums of the centroid 4 and the centred products 15.
# local_sums, per (head, membrane atom) pair:
# the plane offset 2, the minimum image 8, d2 3 and the test 1; per masked
# pair the two sums 2; per membrane atom, θ, cos θ and sin θ (or z and 1)
# before the launch, 4. A masked pair is counted as this run's data gives
# them.
CLOUD_PAIR_OPS = {True: 21, False: 9}
CLOUD_MASKED_OPS = 19
LOCAL_PAIR_OPS = {True: 14, False: 6}
LOCAL_MASKED_OPS = 2
LOCAL_MEMBER_OPS = 4
#: the share of the summed magnitudes by which the neighbour kernels'
#: f64 sums may differ from the plain versions' f32 ones (tests/
#: test_torch_neighbors.py SUM_BOUND)
NEIGHBOR_SUM_BOUND = 1e-5
# The spectral classifier's kernels (csrc/spectral.cu), counted from the
# source. spectral_affinity, per weight w_ij = w_ji, once a pair i <= j
# (the triangle path computes each once): the offset 3, the minimum image
# 12 (none without PBC), d2 5, sigma * d2 1, exp 1 (counted as one); per
# entry of S, the degree's add 1 and the two scalings 2; per head
# 1/sqrt(degree) and its guard 3. The other three work in f64, at the
# card's f64 rate outside the tensor cores: thin_qr3 per row, the three
# norms 6, the reflections of the later columns 15 and of Q's three
# columns 45; top2_span per row, the four passes 2 + 8 + 20 + 20;
# rayleigh_kmeans per row, the Rayleigh sums and the embedding 19 f64
# once and the centroid sums 3 f64 a centroid update, and in f32 the
# farthest-point distance 5 once and the two distances and the test 11
# a pass of labels: a frame that runs s updates takes s + 1 passes (its
# last labels, or the final ones).
AFFINITY_WEIGHT_OPS = {True: 22, False: 10}
AFFINITY_ENTRY_OPS = 3
AFFINITY_HEAD_OPS = 3
QR_ROW_F64_OPS = 66
SPAN_ROW_F64_OPS = 50
KMEANS_ROW_F64_OPS, KMEANS_STEP_F64_OPS = 19, 3
KMEANS_ROW_OPS, KMEANS_STEP_OPS = 5, 11
#: the H100's f64 rate outside the tensor cores (NVIDIA's data sheet, SXM
#: part at 700 W)
F64_OPS_PER_S = 34e12
#: the spectral classifier's similarity and degrees: the kernel sums a
#: degree in f64 and rounds it once, torch in f32 in its own order
#: (tests/test_torch_kernels.py); S takes two 1/sqrt(degree) factors; an
#: entry below f32's normal range carries fewer bits
SPECTRAL_DEGREE_RTOL = 1e-6
SPECTRAL_S_RTOL = 2e-6
TINY_F32 = 2.0 ** -126
#: the bases' orthonormality and projectors, ||.||_2
SPECTRAL_BASIS_TOL = 1e-5
#: the AA runs with membrane normals that are not static: tools/
#: bench_modes.py's two dynamic modes (:339-344, :371-373), whose goldens
#: are pinned, and the inline manual map of (0, 0, 1) for every molecule
#: and frame, which must give the static golden exactly
NORMAL_MODES = ("aa-dynamic", "aa-dynamic-export", "aa-manual-z")
#: tools/bench_modes.py's aa-palmitoyl selections (:381-384), the sn-1
#: chain: its heavy atoms and hydrogens
PALMITOYL = ("resname POPC and name r'^C2\\d+$'",
             "resname POPC and name r'^H\\d+[RST]2$'")
#: the frame at which aa-concat splits the AA trajectory in two files
CONCAT_AT = 4000
#: aa-window's begin and end (ps; frames lie at t = 10 i) and step
WINDOW = (20000.0, 79990.0, 3)
#: the CG frames cg-trr writes into a TRR, and cg-i12 re-encodes at
#: Martini's published compressed-x-precision
TRR_FRAMES = 1024
I12_PRECISION = 100.0
#: the CG vesicle (`synthesize_vesicle`): tools/bench_modes.py's Martini-
#: like POPC with heads on two shells, water to 150,000 beads, in a box
#: whose XTC integers overflow int16 at precision 1000
VESICLE = dict(n_outer=4350, r_outer=15.0, n_inner=2300, r_inner=11.0,
               total_beads=150_000, box=36.0, seed=37)
VESICLE_FRAMES = 1000
#: ves-spherical's leaflets and dynamic normals (heads, radius in nm)
VESICLE_HEADS = ("name PO4", 2.0)
#: the frames of the card-against-CPU chain of ves-spherical
CHAIN_FRAMES = 64


def synthesize_structure(cache_dir, n_lipids=None, total_atoms=None):
    """bench.py synthesize_structure, through the port's host
    modules: bench.gro + bench.bnd (lipids first, then water)."""
    import bench
    from gorder_tpu_torch.io.gro import write_gro
    from gorder_tpu_torch.system import System, canonical_bonds

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
    from gorder_tpu_torch.io import native

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


def synthesize(cache_dir, tag, template, n_frames, n_mols, total_atoms, box,
               seed, water_names, z_offset=0.4, chains_inward=False):
    """tools/bench_modes.py `_synthesize(tag, ...)` for the atomistic,
    united-atom and coarse-grained templates, through the port's host
    modules: {tag}_bench.gro, {tag}_bench.bnd and
    {tag}_bench_{n_frames}.xtc, each written unless cached. Lipids are
    bonded random walks on a leaflet grid (0.3 nm steps for "cg", 0.14 nm
    otherwise), `z_offset` nm from the box's midplane, chains outward (or
    inward with `chains_inward`), then water (resname W for "cg", SOL
    otherwise; bonded only with more than one atom a molecule). One rng
    stream (`seed`) feeds the structure and then the trajectory, which
    starts from the in-memory positions, not from the GRO read back."""
    from gorder_tpu_torch.io import native
    from gorder_tpu_torch.io.gro import write_gro
    from gorder_tpu_torch.system import System, canonical_bonds

    box = np.asarray(box, np.float32)
    gro = os.path.join(cache_dir, f"{tag}_bench.gro")
    bnd = os.path.join(cache_dir, f"{tag}_bench.bnd")
    xtc = os.path.join(cache_dir, f"{tag}_bench_{n_frames}.xtc")

    lipid_names, lipid_bonds = template()
    per = len(lipid_names)
    n_lipid_atoms = per * n_mols
    n_water = (total_atoms - n_lipid_atoms) // len(water_names)
    need_struct = not (os.path.exists(gro) and os.path.exists(bnd))
    need_traj = True
    if os.path.exists(xtc):
        need_traj = len(native.xtc_scan(xtc)["offsets"]) != n_frames
        if need_traj:
            os.remove(xtc)

    rng = np.random.default_rng(seed)
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
                         box[2] / 2 + sign * z_offset], np.float32)
        z_dir = -sign if chains_inward else sign
        walk = base.copy()
        for name in lipid_names:
            names.append(name)
            resids.append(m + 1)
            resnames.append("POPC")
            step = rng.normal(0, 1, 3).astype(np.float32)
            step[2] += z_dir * 1.2
            step /= max(np.linalg.norm(step), 1e-6)
            walk = walk + step * (0.3 if tag == "cg" else 0.14)
            positions[idx] = walk
            idx += 1
        off = m * per
        bonds += [(off + a, off + b) for a, b in lipid_bonds]
    for w in range(n_water):
        base = rng.random(3).astype(np.float32) * box
        for k, name in enumerate(water_names):
            names.append(name)
            resids.append(n_mols + w + 1)
            resnames.append("W" if tag == "cg" else "SOL")
            d = rng.normal(0, 1, 3).astype(np.float32)
            d /= max(np.linalg.norm(d), 1e-6)
            positions[idx] = base + (0.0957 * k) * d
            idx += 1
        if len(water_names) > 1:
            o = n_lipid_atoms + w * len(water_names)
            bonds += [(o, o + k) for k in range(1, len(water_names))]
    positions %= box

    system = System(
        name=f"gorder-tpu {tag} benchmark",
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


def synthesize_ua(cache_dir, n_frames, n_lipids=None, total_atoms=None):
    """tools/bench_modes.py `synth_ua` (256 Berger-like POPC, 44.3k atoms,
    seed 29), or a cut of it to `n_lipids` and `total_atoms`."""
    from tools import bench_modes as bm

    return synthesize(
        cache_dir, "ua", bm._ua_template, n_frames,
        bm.UA_LIPIDS if n_lipids is None else n_lipids,
        bm.UA_TOTAL_ATOMS if total_atoms is None else total_atoms,
        bm.UA_BOX, 29, ["OW", "HW1", "HW2"])


def synthesize_cg(cache_dir, n_frames, n_lipids=None, total_atoms=None):
    """tools/bench_modes.py `synth_cg` (512 Martini-like POPC of 12 beads,
    single-bead water to 16,800 beads, box 12.8 x 12.8 x 10.0, seed 23),
    or a cut of it to `n_lipids` and `total_atoms`."""
    from tools import bench_modes as bm

    return synthesize(
        cache_dir, "cg", bm._cg_template, n_frames,
        bm.CG_LIPIDS if n_lipids is None else n_lipids,
        bm.CG_TOTAL_BEADS if total_atoms is None else total_atoms,
        bm.CG_BOX, 23, ["W"])


#: tools/bench_modes.py `synth_aa_bilayer` (:270): bench.py's lipid at the
#: headline scale with realistic leaflet separation, heads 2 nm from the
#: midplane, chains inward
AAB = dict(n_mols=256, total_atoms=64500, box=(13.0, 13.0, 11.0), seed=31,
           water_names=["OH2", "H1", "H2"], z_offset=2.0,
           chains_inward=True)


def synthesize_aab(cache_dir, n_frames, **cut):
    """The clustering benchmark's bilayer (`AAB`, with `cut` replacing any
    of its sizes): aab_bench.gro, .bnd and _{n_frames}.xtc."""
    import bench

    return synthesize(cache_dir, "aab", bench.build_lipid_template,
                      n_frames, **{**AAB, **cut})


def _fibonacci_shell(n, radius, center):
    """(n, 3) points spread evenly on a sphere, and their unit normals."""
    i = np.arange(n, dtype=np.float64)
    z = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(1.0 - z * z)
    theta = np.pi * (3.0 - np.sqrt(5.0)) * i
    unit = np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)
    return center + radius * unit, unit


def synthesize_vesicle(cache_dir, n_frames, n_outer=None, r_outer=None,
                       n_inner=None, r_inner=None, total_beads=None,
                       box=None, seed=None):
    """A Martini-like CG vesicle (`VESICLE`, with any size replaced):
    tools/bench_modes.py's 12-bead POPC with its first bead on one of two
    Fibonacci shells around the box center, chains inward on the outer
    shell and outward on the inner one (0.3 nm random-walk steps biased
    along the chain), then single-bead "W" water uniform in the cubic box
    up to `total_beads`; the trajectory as `synthesize` makes it
    (per-molecule drift and per-bead jitter, one rng stream after the
    structure's), at precision 1000. → ves_bench.gro, .bnd and
    _{n_frames}.xtc in `cache_dir`, each written unless cached."""
    from gorder_tpu_torch.io import native
    from gorder_tpu_torch.io.gro import write_gro
    from gorder_tpu_torch.system import System, canonical_bonds
    from tools import bench_modes as bm

    v = dict(VESICLE, **{k: val for k, val in dict(
        n_outer=n_outer, r_outer=r_outer, n_inner=n_inner, r_inner=r_inner,
        total_beads=total_beads, box=box, seed=seed).items()
        if val is not None})
    gro = os.path.join(cache_dir, "ves_bench.gro")
    bnd = os.path.join(cache_dir, "ves_bench.bnd")
    xtc = os.path.join(cache_dir, f"ves_bench_{n_frames}.xtc")
    if all(os.path.exists(f) for f in (gro, bnd, xtc)) and len(
            native.xtc_scan(xtc)["offsets"]) == n_frames:
        return gro, bnd, xtc
    box3 = np.full(3, v["box"], np.float32)
    center = box3.astype(np.float64) / 2
    rng = np.random.default_rng(v["seed"])
    names, bonds_t = bm._cg_template()
    per = len(names)
    outer, n_out = _fibonacci_shell(v["n_outer"], v["r_outer"], center)
    inner, n_in = _fibonacci_shell(v["n_inner"], v["r_inner"], center)
    heads = np.concatenate([outer, inner])
    chains = np.concatenate([-n_out, n_in])       # the direction of a chain
    n_mols = len(heads)
    n_water = v["total_beads"] - n_mols * per
    positions = np.zeros((n_mols * per + n_water, 3), np.float32)
    for m in range(n_mols):
        walk = heads[m].astype(np.float32)
        for k in range(per):
            step = rng.normal(0, 1, 3).astype(np.float32)
            step += (chains[m] * 1.2).astype(np.float32)
            step /= max(np.linalg.norm(step), 1e-6)
            if k:
                walk = walk + step * 0.3
            positions[m * per + k] = walk
    positions[n_mols * per:] = rng.random((n_water, 3)).astype(
        np.float32) * box3
    positions %= box3
    resids = np.concatenate([np.repeat(np.arange(1, n_mols + 1), per),
                             np.arange(n_mols + 1, n_mols + n_water + 1)])
    system = System(
        name="gorder-tpu-torch CG vesicle",
        atom_names=np.array(names * n_mols + ["W"] * n_water, dtype="U8"),
        resids=resids.astype(np.int64),
        resnames=np.array(["POPC"] * (n_mols * per) + ["W"] * n_water,
                          dtype="U8"),
        serials=np.arange(1, len(positions) + 1, dtype=np.int64),
        positions=positions, box=np.diag(box3))
    system.bonds = canonical_bonds(np.asarray(
        [(m * per + a, m * per + b) for m in range(n_mols)
         for a, b in bonds_t], np.int64))
    write_gro(gro, system)
    with open(bnd, "w") as fh:
        for a, b in system.bonds:
            fh.write(f"{a + 1} {b + 1}\n")
    if os.path.exists(xtc):
        os.remove(xtc)
    mol_of_atom = resids - 1
    drift = np.zeros((n_mols + n_water, 3), np.float32)
    chunk = 100
    boxes = np.tile(np.diag(box3), (chunk, 1, 1))
    written = 0
    while written < n_frames:
        n = min(chunk, n_frames - written)
        coords = np.empty((n, len(positions), 3), np.float32)
        for i in range(n):
            drift += rng.standard_normal(drift.shape, dtype=np.float32) \
                * 0.015
            drift *= 0.995
            jitter = rng.standard_normal(positions.shape,
                                         dtype=np.float32) * 0.012
            coords[i] = (positions + drift[mol_of_atom] + jitter) % box3
        times = (np.arange(written, written + n) * 10.0).astype(np.float32)
        steps = (np.arange(written, written + n) * 100).astype(np.int32)
        native.xtc_write(xtc, coords, boxes[:n], times, steps,
                         precision=1000.0, append=written > 0)
        written += n
    return gro, bnd, xtc


def vesicle_analysis(files, output_yaml=None, spherical=False, **kw):
    """CGOrder of the vesicle's POPC (`ves`), with spherical-clustering
    leaflets and dynamic normals on `VESICLE_HEADS` (`ves-spherical`)."""
    from gorder_tpu_torch import Analysis, AnalysisType
    from gorder_tpu_torch.input.config import (LeafletClassification,
                                               MembraneNormal)

    if spherical:
        heads, radius = VESICLE_HEADS
        kw.update(leaflets=LeafletClassification.spherical(heads),
                  membrane_normal=MembraneNormal.dynamic(heads, radius))
    gro, bnd, xtc = files
    return Analysis(structure=gro, bonds=bnd, trajectory=xtc,
                    analysis_type=AnalysisType.cgorder("resname POPC"),
                    output_yaml=output_yaml, n_threads=os.cpu_count() or 1,
                    silent=True, overwrite=True, **kw)


def copy_frames(src, dst, frames):
    """Write the XTC frames `frames` (ascending indices) of `src` to `dst`
    as a byte copy of their records, by the frame offsets of
    `native.xtc_scan`: nothing is decoded or encoded again."""
    from gorder_tpu_torch.io import native

    offsets = native.xtc_scan(src)["offsets"]
    ends = np.append(offsets[1:], os.path.getsize(src))
    frames = np.asarray(frames, np.int64)
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        # runs of consecutive frames are one contiguous byte range
        cuts = np.flatnonzero(np.diff(frames) != 1) + 1
        for run in np.split(frames, cuts):
            fin.seek(int(offsets[run[0]]))
            fout.write(fin.read(int(ends[run[-1]] - offsets[run[0]])))
    return dst


def select_window(times, begin, end, step):
    """The indices of the frames at `times` (ps) that a run with `begin`,
    `end` and `step` analyzes: those with begin <= t <= end (compared in
    f32, as the trajectory's times are), then every `step`-th."""
    times = np.asarray(times, np.float32)
    inside = np.flatnonzero((times >= np.float32(begin))
                            & (times <= np.float32(end)))
    return inside[::step]


def write_trr(path, coords, boxes, times, steps):
    """A single-precision GROMACS TRR of positions only: per frame the XDR
    header (magic 1993, "GMX_trn_file", the block sizes of a 3 x 3 box and
    N x 3 positions, N, the step, time and lambda 0) and then the box and
    the positions, all big-endian. coords (F, N, 3), boxes (F, 3, 3) f32;
    times (F,) ps; steps (F,)."""
    n_frames, n_atoms = coords.shape[:2]
    version = b"GMX_trn_file"
    head = np.array([1993, len(version) + 1, len(version)], ">i4").tobytes()
    head += version + b"\0" * (-len(version) % 4)
    # ir, e, box, vir, pres, top, sym, x, v, f, natoms (then step, nre)
    sizes = np.array([0, 0, 36, 0, 0, 0, 0, 12 * n_atoms, 0, 0, n_atoms],
                     ">i4").tobytes()
    with open(path, "wb") as fh:
        for i in range(n_frames):
            fh.write(head + sizes)
            fh.write(np.array([steps[i], 0], ">i4").tobytes())
            fh.write(np.array([times[i], 0.0], ">f4").tobytes())
            fh.write(np.asarray(boxes[i], ">f4").tobytes())
            fh.write(np.asarray(coords[i], ">f4").tobytes())
    return path


def ua_analysis(mode, gro, bnd, xtc, output_yaml=None, **kw):
    """tools/bench_modes.py `_make_analysis(mode)` for "ua" and
    "ua-palmitoyl", built from the port's `Analysis` (with `kw` added)."""
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
                    overwrite=True, **kw)


def aa_analysis(gro, bnd, xtc, output_yaml=None, **kw):
    from gorder_tpu_torch import Analysis, AnalysisType

    return Analysis(structure=gro, bonds=bnd, trajectory=xtc,
                    analysis_type=AnalysisType.aaorder(HEAVY, HYDROGENS),
                    output_yaml=output_yaml, n_threads=os.cpu_count() or 1,
                    silent=True, overwrite=True, **kw)


def leaflet_analysis(mode, gro, bnd, xtc, cache, output_yaml=None):
    """tools/bench_modes.py `_make_analysis(mode)` for the AA leaflet modes
    (bench_modes.py:314-370) and CLUSTERING_MODES, built from the port's
    classes, on the membrane given (`aa-clustering-*` on `AAB`'s)."""
    import bench
    from gorder_tpu_torch.input.config import (Frequency,
                                               LeafletClassification)

    def global_():
        return LeafletClassification.global_("resname POPC", P_HEADS)

    leaflets = {
        "aa-leaflets": global_,
        "aa-leaflets-export": lambda: global_().with_collect(
            os.path.join(cache, "aa-leaflets-export_leaflets.yaml")),
        "aa-leaflets-every10": lambda: global_().with_frequency(
            Frequency.every(10)),
        "aa-leaflets-once": lambda: global_().with_frequency(
            Frequency.once()),
        "aa-local-leaflets": lambda: LeafletClassification.local(
            "resname POPC", P_HEADS, 2.5),
        "aa-individual-leaflets": lambda: LeafletClassification.individual(
            P_HEADS, "resname POPC and name C217 C317"),
        "aa-fromfile-leaflets": lambda: LeafletClassification.from_map(
            {"POPC": [[1 - (m % 2) for m in range(bench.N_LIPIDS)]]
             * N_FRAMES}),
        "aa-spherical-leaflets": lambda: LeafletClassification.spherical(
            P_HEADS),
        "aa-clustering-leaflets": lambda: LeafletClassification.clustering(
            P_HEADS),
        "aa-clustering-leaflets-every10":
            lambda: LeafletClassification.clustering(
                P_HEADS).with_frequency(Frequency.every(10)),
    }[mode]()
    return aa_analysis(gro, bnd, xtc, output_yaml, leaflets=leaflets)


def normals_analysis(mode, gro, bnd, xtc, cache, output_yaml=None):
    """The AA analysis of `mode` in NORMAL_MODES with its membrane normal,
    built from the port's classes (bench_modes.py:339-344, :371-373)."""
    import bench
    from gorder_tpu_torch.input.config import MembraneNormal

    if mode == "aa-manual-z":
        # one row object shared by every frame: the table costs no memory
        # until the run reads it
        row = [[0.0, 0.0, 1.0]] * bench.N_LIPIDS
        normal = MembraneNormal.from_map({"POPC": [row] * N_FRAMES})
    else:
        normal = MembraneNormal.dynamic(
            P_HEADS, collect=(os.path.join(cache, f"{mode}_normals.yaml")
                              if mode == "aa-dynamic-export" else None))
    return aa_analysis(gro, bnd, xtc, output_yaml, membrane_normal=normal)


def geometry_params(invert=False):
    """tools/bench_modes.py's geometry mode (:374-380): a cylinder of radius
    4 nm along z around the per-frame center of the lipids."""
    from gorder_tpu_torch.input.config import Geometry

    return Geometry("cylinder", reference="resname POPC", radius=4.0,
                    orientation="z", invert=invert)


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


def device_ms(fn, reps=20):
    """Mean device time of one call, from CUDA events around `reps` calls
    queued behind a ~10 ms `torch.cuda._sleep` on the stream: the card
    runs them back to back, where events around calls as the host makes
    them (`cuda_ms`) time the host's launches of a kernel shorter than
    them."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def n_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(moved, ops, f64_ops=0):
    """(ms, 'bytes' or 'operations'): the least time for `moved` bytes,
    `ops` f32 operations and `f64_ops` f64 ones on the card (its f32 and
    f64 units run side by side)."""
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = max(ops / F32_OPS_PER_S, f64_ops / F64_OPS_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def compare(label, kernel, plain, counter, launches, shape):
    """One `kernel()` call: the launch count (`counter()`) must grow by
    `launches`, and the int64 output of `shape` must equal `plain()`; a
    call that also fills a map returns (output, map state), both compared.
    Then CUDA-event times in turns: plain, kernel, kernel, plain. →
    dict(max_abs_err, ms, plain_ms, out[, map])."""
    import torch

    before = counter()
    got = kernel()
    torch.cuda.synchronize()
    if counter() != before + launches:
        raise RuntimeError(f"{label}: the launch count grew by "
                           f"{counter() - before}, expected {launches}")
    want = plain()
    got, want = ((got, want) if isinstance(got, tuple)
                 else ((got,), (want,)))
    if tuple(got[0].shape) != tuple(shape) or got[0].dtype != torch.int64:
        raise RuntimeError(f"{label}: output {tuple(got[0].shape)} "
                           f"{got[0].dtype}, expected {tuple(shape)} int64")
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"{label}: kernel != plain, max |diff| {err} "
                           f"quanta")
    plain_ms = cuda_ms(plain)
    ms = cuda_ms(kernel)
    ms2 = cuda_ms(kernel)
    plain_ms2 = cuda_ms(plain)
    print(f"kernel {label}: kernel == plain (int64"
          f"{', type sums and map' if len(got) > 1 else ''}, max |diff| "
          f"{err}); ms per call: plain {plain_ms:.4f}, kernel {ms:.4f}, "
          f"kernel {ms2:.4f}, plain {plain_ms2:.4f}", flush=True)
    numbers = dict(max_abs_err=err, ms=min(ms, ms2),
                   plain_ms=min(plain_ms, plain_ms2), out=got[0])
    if len(got) > 1:
        numbers["map"] = got[1]
    return numbers


def with_bound(label, numbers, moved, ops, f64_ops=0):
    numbers["bound_ms"], numbers["bound_by"] = bound(moved, ops, f64_ops)
    print(f"kernel {label}: bound {numbers['bound_ms']:.4f} ms "
          f"({numbers['bound_by']}; {moved} bytes, {ops} f32 operations"
          + (f", {f64_ops} f64 operations" if f64_ops else "") + ")",
          flush=True)
    return numbers


def batch_normals(db):
    """The dynamic normals (`core.normals.DynamicNormals`) a batch's
    program called: over the b7x wire's aux atoms, or over the coordinate
    wire's atoms; None without dynamic normals."""
    cs = db.consumers
    return cs.aux_normals if db.kind == "b7x" else cs.normals


def neighbor_inputs(db):
    """The (B, A, 3) f32 coordinates a batch's leaflet classifier and
    dynamic normals read (engine/fused.py): the b7x wire's aux atoms, or
    the coordinate wire's positions, dequantized f32(q)·s where they are
    integers."""
    from gorder_tpu_torch.engine.fused import decode_positions

    if db.kind == "b7x":
        q = db.wire[4]
    else:
        q = decode_positions(db.kind, db.wire, db.consumers.n_atoms)
        if db.kind.rstrip("gG") == "f32":
            return q
    return q.to(db.scale.dtype) * db.scale[:, None, None]


def wire_inputs(db):
    """The kernel inputs of a batch the main path handed to its step (a
    `DeviceBatch`): the packed b7 wire as the decoder ships it (codes,
    escape gaps and values, per-slot base) with its scale, or the
    coordinate wire's positions as reconstructed on the card (int16 for
    i16, int32 for s6 and d8), the integers also dequantized, f32(q)·s, as
    the f32 input. → {input: (tensors before the frame arguments)}."""
    import torch

    from gorder_tpu_torch.engine.fused import decode_positions

    if db.kind.startswith("b7"):
        return {"b7": (*db.wire[:4], db.scale)}
    coords = decode_positions(db.kind, db.wire, 0)
    if db.scale is None:
        return {"f32": (coords, None)}
    name = "i32" if coords.dtype == torch.int32 else "i16"
    return {name: (coords, db.scale),
            "f32": (coords.to(torch.float32) * db.scale[:, None, None],
                    None)}


#: the launch count of each P2 input with classes, and with (B, M, 3)
#: normals (with or without classes)
P2_LEAFLET_COUNTS = {"b7": "p2_leaflets_launches",
                     "i16": "p2_i16_leaflets_launches",
                     "i32": "p2_i32_leaflets_launches",
                     "f32": "p2_f32_leaflets_launches"}
P2_NORMAL_COUNTS = {"b7": "p2_normals_launches",
                    "i16": "p2_i16_normals_launches",
                    "i32": "p2_i32_normals_launches",
                    "f32": "p2_f32_normals_launches"}


def check_normals(label, db):
    """The dynamic-normal kernel (ops/neighbors.py `normal_cloud`) against
    its plain version on a batch the main path handed to its step, with
    the coordinates its normals read (`neighbor_inputs`) and the run's own
    head and cloud indices: the cloud counts equal, each covariance entry
    ab within NEIGHBOR_SUM_BOUND of (cov_aa + cov_bb) / 2, which bounds the
    magnitudes it sums, and the normals of every valid frame's heads whose
    clouds hold ≥ 3 atoms within |n·n'| ≥ 1 − 1e-5 of the plain ones', up
    to sign, and of those the step used; a second launch equal bit for
    bit. Then CUDA-event times in turns,
    plain, kernel, kernel, plain (the plain version in frame chunks of at
    most ops.neighbors.MAX_BYTES a pair intermediate, as the CPU runs it),
    the batched eigensolve's time on the kernel's covariances, and the
    bound. → dict(max_abs_err, ms, plain_ms, eigh_ms, bound_ms,
    bound_by)."""
    import torch

    from gorder_tpu_torch.core.normals import smallest_eigvec_3x3
    from gorder_tpu_torch.ops import neighbors

    fn = batch_normals(db)
    coords, box = neighbor_inputs(db), db.box
    heads, cloud = fn.heads.to(coords.device), fn.cloud.to(coords.device)
    n_frames, n_heads, n_cloud = coords.shape[0], len(heads), len(cloud)
    rest = (heads, cloud, fn.radius, fn.handle_pbc)

    def kernel():
        return neighbors.normal_cloud(coords, box, *rest)

    def plain():
        return neighbors.normal_cloud_plain(coords, box, *rest)

    def eig(cov):
        return smallest_eigvec_3x3(neighbors.symmetric_3x3(cov))

    before = neighbors.normals_launches
    counts, cov = kernel()
    again = kernel()
    torch.cuda.synchronize()
    if neighbors.normals_launches != before + 2:
        raise RuntimeError(f"{label}: normals_launches grew by "
                           f"{neighbors.normals_launches - before}, not 2")
    if not (torch.equal(counts, again[0]) and torch.equal(cov, again[1])):
        raise RuntimeError(f"{label}: two normal_cloud launches differ")
    want_counts, want_cov = plain()
    if not torch.equal(counts, want_counts):
        raise RuntimeError(f"{label}: cloud counts differ in "
                           f"{int((counts != want_counts).sum())} places")
    diff = (cov - want_cov).abs()
    scale = (want_cov[..., [0, 0, 0, 3, 3, 5]]
             + want_cov[..., [0, 3, 5, 3, 5, 5]]) / 2
    if bool((diff > NEIGHBOR_SUM_BOUND * scale + 1e-12).any()):
        raise RuntimeError(f"{label}: covariances off by up to "
                           f"{float(diff.max()):.3e}, over the bound")
    valid = (counts >= 3) & db.mask[:, None]
    normals = eig(cov)
    off = max(float(1.0 - (normals * other).sum(-1).abs()[valid].min())
              for other in (eig(want_cov), db.normal))
    if off > 1e-5:
        raise RuntimeError(f"{label}: normals off by 1 - |n.n'| = {off:.3e}")
    plain_ms = cuda_ms(plain, reps=1, warmup=0)
    ms = cuda_ms(kernel, reps=5, warmup=1)
    ms2 = cuda_ms(kernel, reps=5, warmup=0)
    plain_ms2 = cuda_ms(plain, reps=1, warmup=0)
    eigh_ms = cuda_ms(lambda: eig(cov), reps=3, warmup=1)
    print(f"kernel normals {label}: {db.kind} batch, B={n_frames}, M="
          f"{n_heads} heads, C={n_cloud} cloud atoms, radius {fn.radius} nm; "
          f"counts == plain (min {int(counts.min())}, mean "
          f"{float(counts.mean()):.1f}), two launches bit-equal; "
          f"covariances within the bound, max "
          f"|diff| {float(diff.max()):.3e} nm^2; normals 1 - |n.n'| <= "
          f"{off:.3e} (plain's and the step's); ms per call: plain "
          f"{plain_ms:.4f}, kernel {ms:.4f}, kernel {ms2:.4f}, plain "
          f"{plain_ms2:.4f}; the batched 3x3 eigh on its covariances "
          f"{eigh_ms:.4f}", flush=True)
    moved = n_bytes(counts, cov, box) + n_frames * (n_heads + n_cloud) * 12
    ops = (CLOUD_PAIR_OPS[fn.handle_pbc] * n_frames * n_heads * n_cloud
           + CLOUD_MASKED_OPS * int(counts.sum()))
    return with_bound(f"normals {label}", dict(
        max_abs_err=float(diff.max()), ms=min(ms, ms2),
        plain_ms=min(plain_ms, plain_ms2), eigh_ms=eigh_ms), moved, ops)


def check_local(label, db):
    """The local-leaflet kernel (ops/neighbors.py `local_sums`) against its
    plain version on a batch the main path handed to its step, with the
    coordinates its classifier read and the run's own indices: the classes
    of every frame equal the plain version's and the step's; the sums
    within NEIGHBOR_SUM_BOUND of count · max|v| (|cos θ|, |sin θ| ≤ 1;
    |z| and 1 without PBC), the count the in-plane mask's; a second
    launch equal bit for bit. Then CUDA-event
    times in turns, plain, kernel, kernel, plain (the plain version in
    frame chunks of the classifier's `max_elements` pairs, as the CPU runs
    it), and the bound. → dict(max_abs_err, ms, plain_ms, bound_ms,
    bound_by)."""
    import torch

    from gorder_tpu_torch.core.leaflets import LocalClassifier
    from gorder_tpu_torch.core.pbc import min_image
    from gorder_tpu_torch.ops import neighbors

    classify = db.consumers.coords
    if not isinstance(classify, LocalClassifier):
        raise RuntimeError(f"{label}: the batch's classifier is "
                           f"{type(classify).__name__}")
    coords, box = neighbor_inputs(db), db.box
    here = coords.device
    membrane, heads = classify.membrane.on(here), classify.heads.on(here)
    n_frames, n_heads, n_members = coords.shape[0], len(heads), len(membrane)
    axis, pbc = classify.axis, classify.handle_pbc
    rest = (membrane, heads, axis, classify.radius, pbc)
    step = max(1, classify.max_elements // (n_heads * n_members))
    chunks = range(0, n_frames, step)

    def kernel():
        return neighbors.local_sums(coords, box, *rest)

    def plain():
        return neighbors.local_sums_plain(coords, box, *rest,
                                          classify.max_elements)

    r2 = neighbors.radius_squared(classify.radius, here)

    def count(c, b):
        d2 = 0
        for a in neighbors.plane_axes(axis):
            d = c[:, None, membrane, a] - c[:, heads, None, a]
            if pbc:
                d = min_image(d, b[:, None, None, a])
            d2 = d2 + d * d
        return (d2 <= r2).sum(-1).to(torch.float32)

    before = neighbors.local_launches
    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    if neighbors.local_launches != before + 2:
        raise RuntimeError(f"{label}: local_launches grew by "
                           f"{neighbors.local_launches - before}, not 2")
    if not torch.equal(got, again):
        raise RuntimeError(f"{label}: two local_sums launches differ")
    want = plain()
    masked = torch.cat([count(coords[i:i + step], box[i:i + step])
                        for i in chunks])
    top = 1.0 if pbc else float(coords[:, membrane, axis].abs().max())
    diff = (got - want).abs()
    if bool((diff > NEIGHBOR_SUM_BOUND * masked[..., None] * top
             + 1e-12).any()):
        raise RuntimeError(f"{label}: local sums off by up to "
                           f"{float(diff.max()):.3e}, over the bound")
    labels = classify(coords, box)
    if not (torch.equal(labels, classify.plain(coords, box))
            and torch.equal(labels, db.classes)):
        raise RuntimeError(f"{label}: the kernel's classes differ from the "
                           f"plain version's or the step's")
    plain_ms = cuda_ms(plain, reps=1, warmup=0)
    ms = cuda_ms(kernel, reps=5, warmup=1)
    ms2 = cuda_ms(kernel, reps=5, warmup=0)
    plain_ms2 = cuda_ms(plain, reps=1, warmup=0)
    print(f"kernel local_leaflets {label}: {db.kind} batch, B={n_frames}, M="
          f"{n_heads} heads, Nm={n_members} membrane atoms, radius "
          f"{classify.radius} nm; the classes of all {n_frames} frames == "
          f"plain's == the step's ({int((labels == 0).sum())} upper, "
          f"{int((labels == 1).sum())} lower), two launches bit-equal; "
          f"sums within the bound, max "
          f"|diff| {float(diff.max()):.3e}, mean in-plane count "
          f"{float(masked.mean()):.1f}; ms per call: plain {plain_ms:.4f}, "
          f"kernel {ms:.4f}, kernel {ms2:.4f}, plain {plain_ms2:.4f}",
          flush=True)
    moved = (n_bytes(got, box)
             + n_frames * (n_members + n_heads) * 12)
    ops = (LOCAL_PAIR_OPS[pbc] * n_frames * n_heads * n_members
           + LOCAL_MASKED_OPS * int(masked.sum())
           + LOCAL_MEMBER_OPS * n_frames * n_members)
    return with_bound(f"local_leaflets {label}", dict(
        max_abs_err=float(diff.max()), ms=min(ms, ms2),
        plain_ms=min(plain_ms, plain_ms2)), moved, ops)


#: the synthetic batch at minimum-image ties (`near_tie_batch`): frames,
#: heads (not a multiple of a block's 32), the atoms of each head at its
#: ties, the cubic box (nm)
TIE_BATCH = dict(n_frames=16, n_heads=300, per_head=8, box=7.3)


def near_tie_batch(seed, n_frames, n_heads, per_head, box):
    """A batch whose offsets sit at minimum-image ties: `n_heads` heads
    uniform in a cubic box of `box` nm, and for each head `per_head` atoms
    at p ± L/2 in every component, each nudged by 0-2 ulps, so that d / L
    lies within a few ulps of ±1/2. → numpy (B, A, 3) f32 coordinates,
    (B, 3) f32 box lengths, the head indices and the other atoms'."""
    rng = np.random.default_rng(seed)
    length = np.float32(box)
    heads = (rng.random((n_frames, n_heads, 3)) * length).astype(np.float32)
    sign = rng.choice(np.float32([-1.0, 1.0]),
                      (n_frames, n_heads, per_head, 3))
    ties = (heads[:, :, None] + sign * (np.float32(0.5) * length)).astype(
        np.float32)
    steps = rng.integers(-2, 3, ties.shape)
    for _ in range(2):
        move = steps != 0
        ties = np.where(move, np.nextafter(
            ties, np.where(steps < 0, -np.inf, np.inf).astype(np.float32)),
            ties)
        steps = steps - np.sign(steps)
    coords = np.concatenate([heads, ties.reshape(n_frames, -1, 3)], axis=1)
    n_ties = n_heads * per_head
    return (np.ascontiguousarray(coords),
            np.full((n_frames, 3), length, np.float32),
            np.arange(n_heads), n_heads + np.arange(n_ties))


def tie_share(coords, box, heads, others, axes):
    """How many of the batch's (head, atom) offset components along `axes`
    lie at a tie, where the kernels take the division: t = d · fl(1/L)
    within MIN_IMAGE_MARGIN · MIN_IMAGE_SPAN of a half-integer
    (csrc/neighbors.cu `min_image_fast`, in torch f32 on the card). The
    kernels test no |t| per pair: a tile with a coordinate outside
    [-L, 2L] divides every pair, and `near_tie_batch`'s coordinates all
    lie in [-L/2, 3L/2]. → (count, components)."""
    import torch

    from gorder_tpu_torch.ops.neighbors import (MIN_IMAGE_MARGIN,
                                                MIN_IMAGE_SPAN)

    rnd = torch.tensor(1.5 * 2 ** 23, dtype=torch.float32,
                       device=coords.device)
    edge = 0.5 - MIN_IMAGE_MARGIN * MIN_IMAGE_SPAN
    near = 0
    for a in axes:
        d = coords[:, None, others, a] - coords[:, heads, None, a]
        t = d * (1.0 / box[:, a])[:, None, None]
        k = (t + rnd) - rnd
        near += int((t - k).abs().ge(edge).sum())
    return near, len(axes) * coords.shape[0] * len(heads) * len(others)


def tie_radius(coords, box, n_heads, axes):
    """The radius (f32) whose square sits at the median d² over `axes`
    of the heads' own tie atoms (`near_tie_batch`), plain minimum image:
    about half of them lie within it, and the side of a tie moves d² by
    ulps across it."""
    import torch

    from gorder_tpu_torch.core.pbc import min_image

    n_frames = coords.shape[0]
    own = coords[:, n_heads:].reshape(n_frames, n_heads, -1, 3)
    head = coords[:, :n_heads, None]
    d2 = 0
    for a in axes:
        d = min_image(own[..., a] - head[..., a], box[:, None, None, a])
        d2 = d2 + d * d
    return float(np.float32(float(d2.to(torch.float64).median()) ** 0.5))


def check_neighbor_ties():
    """Both neighbour kernels against their plain versions on a batch at
    minimum-image ties (`near_tie_batch`, TIE_BATCH), the radius at the
    median distance of the ties (`tie_radius`: all three components for
    `normal_cloud`, the plane's two for `local_sums`), so that the side of
    a tie moves the mask and, for the covariances, the offset's sign: the
    counts equal, the covariances and sums within NEIGHBOR_SUM_BOUND, the
    local classes equal, and a second launch equal bit for bit; the share
    of offset components the kernels divide."""
    import torch

    from gorder_tpu_torch.core.leaflets import LocalClassifier
    from gorder_tpu_torch.ops import neighbors

    coords, box, heads, others = (torch.as_tensor(a, device="cuda")
                                  for a in near_tie_batch(43, **TIE_BATCH))
    n_heads = len(heads)
    rest = (heads, others, tie_radius(coords, box, n_heads, (0, 1, 2)),
            True)
    before = neighbors.normals_launches
    counts, cov = neighbors.normal_cloud(coords, box, *rest)
    again = neighbors.normal_cloud(coords, box, *rest)
    torch.cuda.synchronize()
    want_counts, want_cov = neighbors.normal_cloud_plain(coords, box, *rest)
    if neighbors.normals_launches != before + 2:
        raise RuntimeError("ties: normals_launches did not grow by 2")
    if not (torch.equal(counts, again[0]) and torch.equal(cov, again[1])):
        raise RuntimeError("ties: two normal_cloud launches differ")
    if not torch.equal(counts, want_counts):
        raise RuntimeError(f"ties: cloud counts differ in "
                           f"{int((counts != want_counts).sum())} places")
    diff = (cov - want_cov).abs()
    scale = (want_cov[..., [0, 0, 0, 3, 3, 5]]
             + want_cov[..., [0, 3, 5, 3, 5, 5]]) / 2
    if bool((diff > NEIGHBOR_SUM_BOUND * scale + 1e-12).any()):
        raise RuntimeError(f"ties: covariances off by up to "
                           f"{float(diff.max()):.3e}")
    near, total = tie_share(coords, box, heads, others, (0, 1, 2))
    print(f"kernel normals ties: B={coords.shape[0]}, M={len(heads)}, C="
          f"{len(others)}, {near} of {total} offset components within the "
          f"margin of a tie; counts == plain (mean "
          f"{float(counts.mean()):.1f}), covariances within the bound (max "
          f"|diff| {float(diff.max()):.3e} nm^2), two launches bit-equal",
          flush=True)
    radius = tie_radius(coords, box, n_heads, (0, 1))
    rest = (others, heads, 2, radius, True)
    before = neighbors.local_launches
    got = neighbors.local_sums(coords, box, *rest)
    again = neighbors.local_sums(coords, box, *rest)
    torch.cuda.synchronize()
    want = neighbors.local_sums_plain(coords, box, *rest)
    if neighbors.local_launches != before + 2:
        raise RuntimeError("ties: local_launches did not grow by 2")
    if not torch.equal(got, again):
        raise RuntimeError("ties: two local_sums launches differ")
    r2 = neighbors.radius_squared(radius, coords.device)
    d2 = 0
    for a in (0, 1):
        d = coords[:, None, others, a] - coords[:, heads, None, a]
        d = d - box[:, None, None, a] * torch.round(d / box[:, None, None, a])
        d2 = d2 + d * d
    masked = (d2 <= r2).sum(-1).to(torch.float32)
    diff = (got - want).abs()
    if bool((diff > NEIGHBOR_SUM_BOUND * masked[..., None] + 1e-12).any()):
        raise RuntimeError(f"ties: local sums off by up to "
                           f"{float(diff.max()):.3e}")
    classify = LocalClassifier(others.cpu(), heads.cpu(), 2, radius, True,
                               device="cuda")
    labels = classify(coords, box)
    if not torch.equal(labels, classify.plain(coords, box)):
        raise RuntimeError("ties: the local classes differ from plain's")
    near, total = tie_share(coords, box, heads, others, (0, 1))
    print(f"kernel local_leaflets ties: B={coords.shape[0]}, M={len(heads)}"
          f", Nm={len(others)}, {near} of {total} plane components within "
          f"the margin of a tie; mean in-plane count "
          f"{float(masked.mean()):.1f}, sums within the bound (max |diff| "
          f"{float(diff.max()):.3e}), classes == plain's, two launches "
          f"bit-equal", flush=True)


def check_p2(label, db, leaflets):
    """The P2 kernel against its plain version on a batch of the main path
    (`DeviceBatch`), for each input `wire_inputs` gives, with the normal
    the step used: the static one, or (B, M, 3) per-molecule normals (the
    per_bond_normal variant). With `leaflets`, the with_leaflets variant
    on the batch's classes, whose totals must equal those without classes.
    The int64 outputs must be equal. → {input: numbers}."""
    import torch

    from gorder_tpu_torch.ops import p2

    step = db.step
    n_types = step.n_types
    n_frames = db.mask.shape[0]
    per_mol = db.normal.dim() == 3
    frame = (db.box, db.normal, db.mask, step.bond_type)
    by_mol = dict(bond_mol=step.bond_mol) if per_mol else {}
    extra = (dict(classes=db.classes, bond_mol=step.bond_mol) if leaflets
             else by_mol)
    shape = ((n_frames, 3, 2, n_types) if leaflets
             else (n_frames, 2, n_types))
    tag = (f"{label}{' leaflets' if leaflets else ''}"
           f"{' normals' if per_mol else ''}")
    print(f"kernel {tag}: {db.kind} batch, B={n_frames} "
          f"N={step.bond_type.shape[0]} T={n_types}"
          + (f" M={db.normal.shape[1]} normals" if per_mol else "")
          + (f" M={db.classes.shape[1]} classes: "
             f"{int((db.classes == 0).sum())} upper, "
             f"{int((db.classes == 1).sum())} lower (molecule-frames)"
             if leaflets else ""), flush=True)
    numbers = {}
    for name, inputs in wire_inputs(db).items():
        if name == "b7":
            kernel, plain, args = p2.p2_b7, p2.p2_b7_plain, inputs
        else:
            coords, scale = inputs
            kernel, plain = p2.p2_positions, p2.p2_positions_plain
            args = (coords, step.atom_a, step.atom_b, scale)
        count = (P2_NORMAL_COUNTS[name] if per_mol
                 else P2_LEAFLET_COUNTS[name] if leaflets
                 else "p2_i32_launches" if name == "i32" else "p2_launches")
        got = compare(
            f"{tag} {name}",
            lambda k=kernel, a=args: k(*a, *frame, n_types,
                                       handle_pbc=step.handle_pbc, **extra),
            lambda f=plain, a=args: f(*a, *frame, n_types,
                                      handle_pbc=step.handle_pbc, **extra),
            lambda c=count: getattr(p2, c), 1, shape)
        numbers[name] = with_bound(
            f"{tag} {name}", got,
            n_bytes(*args, *frame, got["out"], *extra.values()),
            int(db.mask.sum()) * step.bond_type.shape[0]
            * (P2_OPS + (P2_NORMAL_OPS if per_mol else 0)))
        if leaflets and not torch.equal(got["out"][:, 0], kernel(
                *args, *frame, n_types, handle_pbc=step.handle_pbc,
                **by_mol)):
            raise RuntimeError(f"{tag} {name}: total != the plain variant")
    return numbers


def check_ua(label, step, inputs, frame, classes=None, geom_ref=None):
    """The UA kernel against its plain version for each of `inputs`
    ({input: (coords, scale)}) with `frame` (box, normal, mask): the
    static normal, or (B, M, 3) per-molecule normals (the per_bond_normal
    variant); with `classes`, the with_leaflets variant; with a step made
    for an ordermap, also the map output, into a freshly zeroed state on
    each call; with a step made for a geometry, the inside test against
    the reference that `geom_ref` gives for the input (the batch's, as
    `DeviceBatch.geom_ref`). The int64 outputs (and maps) must be equal,
    and the kernel launched once per category. → {input: numbers}."""
    import torch

    from gorder_tpu_torch.core.order import geometry_reference
    from gorder_tpu_torch.core.ordermap import init_map_state
    from gorder_tpu_torch.core.ua import N_HYDROGENS
    from gorder_tpu_torch.ops import ua

    leaflets = classes is not None
    per_mol = frame[1].dim() == 3
    spec = step.map_spec
    geom = step.geom_spec
    n_types = step.n_types
    n_frames = frame[2].shape[0]
    shape = ((n_frames, 3, 2, n_types) if leaflets
             else (n_frames, 2, n_types))
    count = ("ua_geom_launches" if geom is not None
             else "ua_map_launches" if spec is not None
             else "ua_normals_launches" if per_mol
             else "ua_leaflets_launches" if leaflets else "ua_launches")

    def with_map(fn, **kw):
        """fn's output, or (output, map state) for a map run."""
        if spec is None:
            return fn(**kw)
        state = init_map_state(3 if leaflets else 1, n_types, spec,
                               frame[0].device)
        return fn(map_spec=spec, map_state=state, **kw), state

    tag = (f"ua{' leaflets' if leaflets else ''}"
           f"{' normals' if per_mol else ''}"
           f"{' map' if spec is not None else ''}"
           f"{' geometry' if geom is not None else ''} {label}")
    ops = int(frame[2].sum()) * sum(
        n * (UA_OPS[cat] + (UA_NORMAL_OPS[cat] if per_mol else 0)
             + (N_HYDROGENS[cat] * MAP_OPS if spec is not None else 0)
             + (N_HYDROGENS[cat] * GEO_OPS if geom is not None else 0))
        for cat, n in step.layout)
    numbers = {}
    for name, (coords, scale) in inputs.items():
        geometry = {}
        if geom is not None:
            coords_f = (coords if scale is None else
                        coords.to(torch.float32) * scale[:, None, None])
            geometry = dict(geom_spec=geom, reference=geometry_reference(
                coords_f, frame[0], geom_ref, step.handle_pbc).contiguous())

        def kernel(layout=step.layout, bond_type=step.bond_type,
                   coords=coords, scale=scale, geometry=geometry):
            return with_map(lambda **kw: ua.ua_positions(
                coords, scale, *frame, step.indices, bond_type, n_types,
                handle_pbc=step.handle_pbc, layout=layout, classes=classes,
                bond_mol=step.bond_mol, **geometry, **kw))

        def plain(layout=step.layout, bond_type=step.bond_type,
                  coords=coords, scale=scale, geometry=geometry):
            return with_map(lambda **kw: ua.ua_positions_plain(
                coords, scale, *frame, step.indices, bond_type, n_types,
                handle_pbc=step.handle_pbc, layout=layout, classes=classes,
                bond_mol=step.bond_mol, **geometry, **kw))

        print(f"kernel {tag} {name}: B={n_frames} samples="
              f"{step.bond_type.shape[0]} T={n_types} categories "
              f"{[f'{c}:{n}' for c, n in step.layout]}"
              + (f" map {spec.n0} x {spec.n1} tiles" if spec is not None
                 else ""), flush=True)
        try:
            got = compare(f"{tag} {name}", kernel, plain,
                          lambda c=("ua_i32_launches" if name == "i32"
                                    else count): getattr(ua, c),
                          len(step.layout), shape)
        except RuntimeError:
            if leaflets or spec is not None or geom is not None:
                raise
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
            raise RuntimeError(f"{tag} {name}: " + "; ".join(detail))
        index_tensors = [ix for d in step.indices.values()
                         for ix in d.values()]
        # a map state is read and written once
        moved = n_bytes(coords, scale, *frame, step.bond_type, classes,
                        got["out"], *index_tensors,
                        geometry.get("reference")) + 2 * n_bytes(
                            got.get("map"))
        numbers[name] = with_bound(f"{tag} {name}", got, moved, ops)
        # the classifiers and ua_problem give classes in {0, 1} only
        if leaflets and not torch.equal(got["out"][:, 1] + got["out"][:, 2],
                                        got["out"][:, 0]):
            raise RuntimeError(f"{tag} {name}: upper + lower != total")
    return numbers


def check_p2_map(label, db, normal=None, bond_mol=None, pair_alone=False):
    """The pair_quantized P2 kernel with its map output against the plain
    version on a map run's batch (`DeviceBatch`): integer positions (int16,
    or int32 from s6 or d8) and, as the f32 input, the same dequantized,
    with the classes the step used.
    `normal` with `bond_mol` replaces the run's static normal with
    per-molecule (B, M, 3) normals. The type sums and a freshly zeroed map
    state must be equal in int64. With `pair_alone`, also the
    pair_quantized int16 type sums without a map (the TPU variant as it
    is). → {input: numbers}."""
    from gorder_tpu_torch.core.ordermap import init_map_state
    from gorder_tpu_torch.ops import p2

    step = db.step
    spec = step.map_spec
    n_types = step.n_types
    n_frames = db.mask.shape[0]
    normal = db.normal if normal is None else normal
    per_mol = normal.dim() == 3
    classes = db.classes
    n_classes = 3 if classes is not None else 1
    extra = dict(classes=classes,
                 bond_mol=(bond_mol if bond_mol is not None
                           else step.bond_mol)
                 if classes is not None or per_mol else None)
    frame = (db.box, normal, db.mask, step.bond_type)
    shape = ((n_frames, 3, 2, n_types) if classes is not None
             else (n_frames, 2, n_types))
    tag = (f"{label}{' leaflets' if classes is not None else ''}"
           f"{' normals' if per_mol else ''} map")
    print(f"kernel {tag}: {db.kind} batch, B={n_frames} "
          f"N={step.bond_type.shape[0]} T={n_types}, map {spec.n0} x "
          f"{spec.n1} tiles, {n_classes} x 2 x "
          f"{n_types * spec.ncells + 1} int64", flush=True)
    numbers = {}
    for name, (coords, scale) in wire_inputs(db).items():
        def run(fn, coords=coords, scale=scale):
            state = init_map_state(n_classes, n_types, spec, coords.device)
            return fn(coords, step.atom_a, step.atom_b, scale, *frame,
                      n_types, handle_pbc=step.handle_pbc, pair=True,
                      map_spec=spec, map_state=state, **extra), state

        got = compare(f"{tag} {name}", lambda r=run: r(p2.p2_positions),
                      lambda r=run: r(p2.p2_positions_plain),
                      lambda c=f"p2_{name}_map_launches": getattr(p2, c), 1,
                      shape)
        numbers[name] = with_bound(
            f"{tag} {name}", got,
            n_bytes(coords, scale, step.atom_a, step.atom_b, *frame,
                    got["out"], *extra.values()) + 2 * n_bytes(got["map"]),
            int(db.mask.sum()) * step.bond_type.shape[0]
            * (P2_OPS + MAP_OPS + (PAIR_OPS if name != "f32" else 0)
               + (P2_NORMAL_OPS if per_mol else 0)))
    if pair_alone:
        coords, scale = wire_inputs(db)["i16"]

        def alone(fn):
            return fn(coords, step.atom_a, step.atom_b, scale, *frame,
                      n_types, handle_pbc=step.handle_pbc, pair=True,
                      **extra)

        got = compare(f"{label} i16 pair, no map",
                      lambda: alone(p2.p2_positions),
                      lambda: alone(p2.p2_positions_plain),
                      lambda: p2.p2_i16_pair_launches, 1, shape)
        numbers["i16_pair"] = with_bound(
            f"{label} i16 pair, no map", got,
            n_bytes(coords, scale, step.atom_a, step.atom_b, *frame,
                    got["out"], *extra.values()),
            int(db.mask.sum()) * step.bond_type.shape[0]
            * (P2_OPS + PAIR_OPS + (P2_NORMAL_OPS if per_mol else 0)))
    return numbers


def check_p2_geom(label, db, classes=None, normal=None, bond_mol=None,
                  map_spec=None):
    """The with_geom P2 kernel against its plain version on a geometry
    run's batch (`DeviceBatch`), with the bitplane the step was given (the
    last wire tensor): the packed b7 wire (b7geo), or int16 positions and,
    as the f32 input, the same dequantized (i16G). `classes` with `bond_mol` add
    the with_leaflets variant; `normal` (B, M, 3) with `bond_mol` the
    per_bond_normal one. With `map_spec`, the pair_quantized int16 input
    with the map output into a freshly zeroed state instead, whose entries,
    the dump included, must sum to the batch's type sums. The int64
    outputs must be equal, and every valid sample counted must be one
    whose bit is set. → {input: numbers}."""
    import torch

    from gorder_tpu_torch.core.ordermap import init_map_state
    from gorder_tpu_torch.engine.wire import geo_bits
    from gorder_tpu_torch.ops import p2

    step = db.step
    geo = db.wire[-1]
    normal = db.normal if normal is None else normal
    per_mol = normal.dim() == 3
    n_types = step.n_types
    n_frames = db.mask.shape[0]
    n_bonds = step.bond_type.shape[0]
    n_classes = 3 if classes is not None else 1
    extra = dict(classes=classes, geo=geo,
                 bond_mol=bond_mol if classes is not None or per_mol
                 else None)
    frame = (db.box, normal, db.mask, step.bond_type)
    shape = ((n_frames, 3, 2, n_types) if classes is not None
             else (n_frames, 2, n_types))
    inside = int(geo_bits(geo, n_bonds)[db.mask].sum())
    tag = (f"{label} geometry{' leaflets' if classes is not None else ''}"
           f"{' normals' if per_mol else ''}"
           f"{' map' if map_spec is not None else ''}")
    print(f"kernel {tag}: {db.kind} batch, B={n_frames} N={n_bonds} "
          f"T={n_types}, bitplane {tuple(geo.shape)} uint8: {inside} of "
          f"{int(db.mask.sum()) * n_bonds} valid samples inside", flush=True)
    inputs = wire_inputs(db)
    if map_spec is not None:
        inputs = {"i16_pair": inputs["i16"]}
    numbers = {}
    for name, inp in inputs.items():
        if name == "b7":
            kernel, plain, args, kw = p2.p2_b7, p2.p2_b7_plain, inp, {}
        else:
            coords, scale = inp
            kernel, plain = p2.p2_positions, p2.p2_positions_plain
            args = (coords, step.atom_a, step.atom_b, scale)
            kw = dict(pair=True, map_spec=map_spec) if map_spec else {}

        def run(fn, args=args, kw=kw):
            if map_spec is None:
                return fn(*args, *frame, n_types, handle_pbc=step.handle_pbc,
                          **kw, **extra)
            state = init_map_state(n_classes, n_types, map_spec,
                                   db.box.device)
            return fn(*args, *frame, n_types, handle_pbc=step.handle_pbc,
                      map_state=state, **kw, **extra), state

        count = {"b7": "p2_geom_launches", "i16": "p2_i16_geom_launches",
                 "i16_pair": "p2_i16_pair_geom_launches",
                 "f32": "p2_f32_geom_launches"}[name]
        got = compare(f"{tag} {name}", lambda r=run, k=kernel: r(k),
                      lambda r=run, f=plain: r(f),
                      lambda c=count: getattr(p2, c), 1, shape)
        out = got["out"] if classes is not None else got["out"][:, None]
        if int(out[:, 0, 1].sum()) != inside:
            raise RuntimeError(f"{tag} {name}: {int(out[:, 0, 1].sum())} "
                               f"samples counted, {inside} inside")
        if map_spec is not None:
            if not torch.equal(got["map"].sum(-1), out[db.mask].sum((0, 3))):
                raise RuntimeError(f"{tag} {name}: the map's entries do not "
                                   f"sum to the inside-only type sums")
            print(f"check {tag} {name}: the map's entries, dump included, "
                  f"sum to the batch's inside-only type sums "
                  f"{got['map'].sum(-1).tolist()}", flush=True)
        # the bytes the function must move: the b7 codes of the samples
        # inside only, every other input once
        per_bond = args[0] if name == "b7" else None
        share = inside / max(int(db.mask.sum()) * n_bonds, 1)
        moved = (n_bytes(*args[1:] if per_bond is not None else args,
                         *frame, got["out"], *extra.values())
                 + (int(n_bytes(per_bond) * share) if per_bond is not None
                    else 0) + 2 * n_bytes(got.get("map")))
        numbers[name] = with_bound(
            f"{tag} {name}", got, moved,
            inside * (P2_OPS + (P2_NORMAL_OPS if per_mol else 0)
                      + (MAP_OPS + PAIR_OPS if map_spec is not None
                         else 0)))
    return numbers


class TypeSums:
    """Over a run, per bond type, the int64 [Σq, count] of its total class
    on the valid frames. Call with each `DeviceBatch`."""

    def __init__(self):
        self.value = None

    def __call__(self, db):
        out = db.out if db.out.dim() == 3 else db.out[:, 0]
        sums = out[db.mask].sum(0)
        self.value = sums if self.value is None else self.value + sums


class Conservation:
    """Over a map run, per class: the Σq and counts of every batch's type
    sums (valid frames, all types), and the run's map state, whose entries
    (the dump included) must add up to them exactly. Call with each
    `DeviceBatch`; then `check`."""

    def __init__(self):
        self.sums = None
        self.state = None

    def __call__(self, db):
        out = db.out if db.out.dim() == 4 else db.out[:, None]
        sums = out[db.mask].sum(dim=(0, 3))                    # (C, 2)
        self.sums = sums if self.sums is None else self.sums + sums
        self.state = db.map_state

    def check(self, label):
        import torch

        got = self.state.sum(dim=-1)
        if not torch.equal(got, self.sums):
            raise RuntimeError(f"{label}: the map holds {got.tolist()} "
                               f"[Σq, count] per class, the type sums "
                               f"{self.sums.tolist()}")
        dump = self.state[:, 1, -1].tolist()
        print(f"check {label}: map conservation holds exactly: per class "
              f"[Σq, count] {got.tolist()} == the run's type sums; samples "
              f"outside the grid (dump) {dump}", flush=True)


def check_map_files(label, results, directory):
    """The map directory of a run: plot.py and one .dat file per class for
    the system, each molecule type, atom and bond, each with n0 x n1 tile
    lines. → (files, tile lines)."""
    _, spec = results.map_params
    n_classes = len(results.average_maps)
    per_class = 1 + sum(1 + len(m.bonds) + sum(1 + len(a.bonds)
                                               for a in m.atoms)
                        for m in results.molecules)
    dats = []
    for root, _, files in os.walk(directory):
        dats += [os.path.join(root, f) for f in files if f.endswith(".dat")]
    if (not os.path.exists(os.path.join(directory, "plot.py"))
            or len(dats) != n_classes * per_class):
        raise RuntimeError(f"{label}: {len(dats)} .dat files in "
                           f"{directory}, expected {n_classes} x "
                           f"{per_class}, and plot.py")
    for path in dats:
        with open(path) as fh:
            tiles = sum(1 for ln in fh if ln[0] not in "#@$")
        if tiles != spec.ncells:
            raise RuntimeError(f"{label}: {path} holds {tiles} tile lines, "
                               f"expected {spec.n0} x {spec.n1}")
    print(f"check {label}: {directory} holds plot.py and {len(dats)} .dat "
          f"files, each {spec.n0} x {spec.n1} tile lines", flush=True)
    return len(dats), len(dats) * spec.ncells


def map_params(cache, label):
    """The chip runs' ordermap: bench.py's default grid (0.1 nm bins, auto
    spans; the plane from the static z normal, xy), written to the cache."""
    from gorder_tpu_torch.input.config import OrderMapParams

    return OrderMapParams(output_directory=os.path.join(cache,
                                                        f"{label}_maps"))


def check_ua_synthetic():
    """The UA kernel on `ua_problem`'s batch, the one with all four carbon
    categories (the UA cell has no CH1s), int16 and f32, without and with
    seeded classes."""
    import torch

    from gorder_tpu_torch.core.ua import make_ua_step

    pb = ua_problem(17, BATCH, 2000, n_types=68)
    dev = torch.device("cuda")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    frame = (t(pb["box"]), t(np.array([0.0, 0.0, 1.0], np.float32)),
             t(pb["mask"]))
    inputs = {"i16": (t(pb["q16"]), t(pb["inv16"])),
              "f32": (t(pb["coords"]), None)}
    for leaflets in (False, True):
        step = make_ua_step(pb["categories"], pb["bond_type"],
                            pb["bond_mol"], pb["n_types"], handle_pbc=True,
                            device=dev, with_leaflets=leaflets)
        check_ua("synthetic", step, inputs, frame,
                 t(pb["classes"]) if leaflets else None)


def ua_problem(seed, n_frames, n_mols, n_types=7, type_major=False):
    """A numpy-seeded UA problem with all four categories, laid out as
    tests/test_pallas_ua.py `_ua_problem` lays its own: molecules of 10
    atoms with 1 CH3, 3 CH2, 1 CH1u and 1 CH1s each, uniform positions in
    a 6 nm box, the last two frames masked, sample types (i·K + k) mod
    n_types per category, and seeded leaflet classes in {0, 1} per frame
    and molecule. With `type_major`, each category's targets are laid out
    as the compiled UA topology lays them (topology/ua.py): for each
    carbon, that carbon of every molecule, and the samples of its k-th
    hydrogens of one type, (c·K + k) mod n_types for the category's c-th
    carbon. → dict of numpy arrays, with the positions also as int16 XTC
    integers at precision 1000."""
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
    types = {}
    for c, d in categories.items():
        n = len(d["target"])
        sample = np.arange(n * k_of[c])
        if type_major:
            carbons = n // n_mols
            order = (np.arange(n_mols)[None, :] * carbons
                     + np.arange(carbons)[:, None]).ravel()
            for key in d:
                d[key] = d[key][order]
            sample = sample // k_of[c] // n_mols * k_of[c] + sample % k_of[c]
        d["mol"] = (d["target"] // per).astype(np.int32)
        types[c] = sample % n_types
    bond_type = np.concatenate(list(types.values())).astype(np.int32)
    bond_mol = np.concatenate([
        np.repeat(d["mol"], k_of[c])
        for c, d in categories.items()]).astype(np.int32)
    return dict(coords=coords, q16=np.round(coords * 1000).astype(np.int16),
                inv16=np.full(n_frames, 1e-3, np.float32),
                box=np.full((n_frames, 3), 6.0, np.float32), mask=mask,
                categories=categories, bond_type=bond_type,
                bond_mol=bond_mol, n_types=n_types,
                classes=rng.integers(0, 2, (n_frames, n_mols))
                .astype(np.int32))


def time_classifiers(gro, bnd, xtc, cache):
    """CUDA-event time of each every-frame leaflet classifier on the first
    B = 512 frames (f32 coordinates of the run's atom space), the device
    work it adds to a batch beside the P2 kernel; for the local one, whose
    sums are a kernel, also its plain version's time (`LocalClassifier
    .plain`) and the kernel's bound. → {mode: ms}."""
    from gorder_tpu_torch.core.leaflets import LocalClassifier
    import torch

    from gorder_tpu_torch.engine.leaflet_runtime import build_leaflet_runtime
    from gorder_tpu_torch.engine.prepare import (
        _AXIS_INDEX, _build_atom_space, _prepare_bond_kinds, load_structure)
    from gorder_tpu_torch.io.traj import Trajectory

    out = {}
    # the global classifier with its own COG on the device: what non-XTC
    # input and frequency-gated runs use (b7g runs take the decoder's)
    for mode in ("aa-leaflets", "aa-local-leaflets",
                 "aa-individual-leaflets"):
        analysis = leaflet_analysis(mode, gro, bnd, xtc, cache)
        system = load_structure(analysis)
        kinds, compiled = _prepare_bond_kinds(system, analysis)
        space, remap = _build_atom_space(system, analysis,
                                         [compiled.atom_a, compiled.atom_b])
        runtime = build_leaflet_runtime(
            system, analysis, kinds, compiled.n_molecules,
            _AXIS_INDEX[analysis.membrane_normal.axis], remap,
            device="cuda")
        traj = Trajectory(analysis.trajectory, expected_atoms=system.n_atoms)
        coords, boxes, _, _ = traj.read_frames(
            traj.select_frames(None, None, 1)[:BATCH], space,
            n_threads=analysis.n_threads)
        coords = torch.as_tensor(coords, device="cuda")
        box = torch.as_tensor(np.ascontiguousarray(
            boxes[:, [0, 1, 2], [0, 1, 2]]), device="cuda")
        classify = runtime.fused_classify()
        out[mode] = cuda_ms(lambda: classify(coords, box), reps=3, warmup=1)
        if isinstance(classify, LocalClassifier):
            plain_ms = cuda_ms(lambda: classify.plain(coords, box), reps=1,
                               warmup=1)
            n_heads, n_members = len(classify.heads), len(classify.membrane)
            pairs = BATCH * n_heads * n_members
            bound_ms, _ = bound(0, LOCAL_PAIR_OPS[classify.handle_pbc] * pairs)
            print(f"classify {mode}: {out[mode]:.4f} ms a batch with the "
                  f"kernel, {plain_ms:.4f} ms plain; {pairs} pairs, bound by "
                  f"operations {bound_ms:.4f} ms (the masked pairs' sums "
                  f"left out)", flush=True)
    print("classify: device ms per batch of 512 frames (f32 coordinates): "
          + ", ".join(f"{m} {ms:.4f}" for m, ms in out.items()), flush=True)
    return out


def time_normals(gro, bnd, xtc, cache):
    """CUDA-event time of the dynamic normals of `aa-dynamic` on the first
    B = 512 frames (f32 coordinates of the run's atom space): the device
    work they add to a batch beside the P2 kernel, and the share of it
    that the (B, M) batched 3×3 eigensolve takes. → (ms, eigh ms)."""
    import torch

    from gorder_tpu_torch.core.normals import (dynamic_normals_plain,
                                               smallest_eigvec_3x3)
    from gorder_tpu_torch.engine.normals_runtime import _build_normals
    from gorder_tpu_torch.engine.prepare import (
        _build_atom_space, _prepare_bond_kinds, load_structure)
    from gorder_tpu_torch.io.traj import Trajectory

    analysis = normals_analysis("aa-dynamic", gro, bnd, xtc, cache)
    system = load_structure(analysis)
    kinds, compiled = _prepare_bond_kinds(system, analysis)
    space, remap = _build_atom_space(system, analysis,
                                     [compiled.atom_a, compiled.atom_b])
    _, _, runtime = _build_normals(system, analysis, kinds,
                                   compiled.n_molecules, remap, "cuda")
    traj = Trajectory(analysis.trajectory, expected_atoms=system.n_atoms)
    coords, boxes, _, _ = traj.read_frames(
        traj.select_frames(None, None, 1)[:BATCH], space,
        n_threads=analysis.n_threads)
    coords = torch.as_tensor(coords, device="cuda")
    box = torch.as_tensor(np.ascontiguousarray(
        boxes[:, [0, 1, 2], [0, 1, 2]]), device="cuda")
    compute = runtime.compute
    ms = cuda_ms(lambda: compute(coords, box), reps=3, warmup=1)
    heads, cloud = compute.heads, compute.cloud
    plain_ms = cuda_ms(lambda: dynamic_normals_plain(
        coords, box, heads, cloud, compute.radius, compute.handle_pbc),
        reps=3, warmup=1)
    normals, counts = compute(coords, box)
    pairs = BATCH * len(heads) * len(cloud)
    bound_ms, _ = bound(0, CLOUD_PAIR_OPS[compute.handle_pbc] * pairs
                        + CLOUD_MASKED_OPS * int(counts.sum()))
    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn(normals.shape[:2] + (3, 3), device="cuda", generator=g)
    cov = a @ a.transpose(-1, -2)
    eigh_ms = cuda_ms(lambda: smallest_eigvec_3x3(cov), reps=3, warmup=1)
    print(f"normals: device ms per batch of {BATCH} frames (f32 coordinates,"
          f" M={normals.shape[1]} heads, C={len(compute.cloud_indices)} "
          f"cloud atoms, radius {compute.radius} nm): {ms:.4f} with the "
          f"kernel, of which the batched 3x3 eigh {eigh_ms:.4f}; plain "
          f"{plain_ms:.4f}; the kernel's bound by operations "
          f"{bound_ms:.4f}; cloud counts min {int(counts.min())} mean "
          f"{float(counts.mean()):.1f}", flush=True)
    return ms, eigh_ms


def first_calls():
    """Wall seconds of the process's first batched 3×3 eigensolve on the
    card (cuSOLVER's start) and first `normal_cloud` launch, each on a
    small input, then of the same calls again: what the first run with
    dynamic normals pays once, measured apart so that `aa-dynamic`'s
    `dispatch` holds none of it."""
    import torch

    from gorder_tpu_torch.core.normals import smallest_eigvec_3x3
    from gorder_tpu_torch.ops import neighbors

    g = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn((256, 3, 3), device="cuda", generator=g)
    cov = a @ a.transpose(-1, -2)
    coords = torch.rand((2, 16, 3), device="cuda", generator=g) * 5.0
    box = torch.full((2, 3), 5.0, device="cuda")
    idx = torch.arange(16, device="cuda")
    times = []
    for fn in (lambda: smallest_eigvec_3x3(cov),
               lambda: neighbors.normal_cloud(coords, box, idx[:8], idx, 2.0,
                                              True)):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    print(f"first calls: the batched 3x3 eigh {times[0]:.4f} s, then "
          f"{times[1]:.4f} s; normal_cloud {times[2]:.4f} s, then "
          f"{times[3]:.4f} s", flush=True)


def check_f32_matmuls():
    """Clustering's products must run in full f32: TF32 off, the f32
    matmul precision "highest" (PyTorch's defaults;
    ops/spectral.py `require_f32_matmuls`)."""
    from gorder_tpu_torch.ops import spectral

    spectral.require_f32_matmuls("cuda")
    print("clustering: f32 matmuls in full precision (allow_tf32 False, "
          "precision 'highest')", flush=True)


def cluster_heads(analysis):
    """The run's clustering head cloud, as indices into its atom space."""
    from gorder_tpu_torch.engine.leaflet_runtime import _cluster_head_cloud
    from gorder_tpu_torch.engine.prepare import (
        _build_atom_space, _prepare_bond_kinds, load_structure)

    system = load_structure(analysis)
    kinds, compiled = _prepare_bond_kinds(system, analysis)
    _, remap = _build_atom_space(system, analysis,
                                 [compiled.atom_a, compiled.atom_b])
    cloud, _ = _cluster_head_cloud(system, kinds, analysis.leaflets.heads)
    return remap(cloud)


def spectral_counters(calls):
    """The spectral classifier's launch counts after `calls` calls of its
    dense matmul branch: each pass once, the thin QR six times."""
    return {"affinity_launches": calls, "qr_launches": 6 * calls,
            "span_launches": calls, "kmeans_launches": calls}


def time_clustering(label, analysis, db):
    """CUDA-event time of the run's clustering classifier on its first
    batch (`db`, the f32 coordinates of the int16 wire), per batch of 512
    frames: spectral in both algebras (the card's matmul branch, whose
    passes are the kernels of csrc/spectral.cu, and batched `eigh`) and its
    matmul chain through the plain versions, spherical in its one. The
    spectral raw labels are compared frame by frame with the plain
    chain's, the other algebra's and the CPU's (LAPACK eigh), and the
    frames that differ counted: none may differ from the plain chain's or
    the CPU's. → {branch: ms}."""
    from gorder_tpu_torch.core import clustering

    heads = cluster_heads(analysis)
    coords = wire_inputs(db)["f32"][0]
    valid = db.mask
    out, labels = {}, {}
    if analysis.leaflets.kind == "spherical":
        branches = {"spherical": clustering.make_spherical_classifier(
            heads, analysis.handle_pbc, device="cuda")}
    else:
        branches = {f"spectral {algebra}": clustering.make_spectral_labels(
            heads, analysis.handle_pbc, device="cuda", algebra=algebra)
            for algebra in ("matmul", "eigh")}
        branches["spectral matmul plain"] = \
            branches["spectral matmul"].plain
    for name, fn in branches.items():
        labels[name] = fn(coords, db.box)[valid].cpu()
        out[name] = cuda_ms(lambda f=fn: f(coords, db.box), reps=3, warmup=1)
    cpu = (clustering.make_spectral_labels if len(branches) > 1 else
           clustering.make_spherical_classifier)(heads, analysis.handle_pbc)(
        coords[valid].cpu(), db.box[valid].cpu())
    differ = {f"{name} vs cpu": int((l != cpu).any(1).sum())
              for name, l in labels.items()}
    if len(branches) > 1:
        differ["spectral matmul vs plain"] = int(
            (labels["spectral matmul"] != labels["spectral matmul plain"])
            .any(1).sum())
    print(f"classify {label}: device ms per batch of {int(valid.sum())} "
          f"frames, M={len(heads)} heads: "
          + ", ".join(f"{name} {ms:.4f}" for name, ms in out.items())
          + "; frames whose raw labels differ: "
          + ", ".join(f"{k} {v}" for k, v in differ.items()), flush=True)
    bad = {k: v for k, v in differ.items()
           if v and k in ("spectral matmul vs cpu", "spectral matmul vs plain",
                          "spherical vs cpu")}
    if bad:
        raise RuntimeError(f"{label}: raw labels differ in {bad} frames")
    return out


def check_spectral(label, analysis, db):
    """The spectral classifier's kernels (ops/spectral.py, csrc/
    spectral.cu) against their plain versions on a batch the main path
    handed to its step (`db`: the valid frames' f32 coordinates of the
    int16 wire, the run's head cloud), at the shapes the chain gives each:
    the similarity and degrees (within SPECTRAL_S_RTOL and _DEGREE_RTOL);
    the thin QR on the chain's start basis and on the filter's `gp @ q`
    (orthonormal, and the projectors of the columns whose singular values
    stand clear of f64 rounding within SPECTRAL_BASIS_TOL); the deflated
    span's two directions (the same); the k-means labels of every frame
    equal. Each kernel's launch count must grow by one a call. Then
    CUDA-event times in turns, plain, kernel, kernel, plain, and of the
    one PyTorch call that computes the same function where there is one
    (`torch.linalg.qr`; `torch.linalg.svd` of the deflated span), each
    kernel's bound, and the whole classifier call's device operations (a
    `torch.profiler` count of its kernels, copies and sets), its time and
    the plain chain's, and the bound of its 12 squarings. → {kernel:
    dict(max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by)}."""
    import torch

    from gorder_tpu_torch.core import clustering as cl
    from gorder_tpu_torch.ops import spectral

    heads = cluster_heads(analysis)
    valid = db.mask
    coords = wire_inputs(db)["f32"][0][valid].contiguous()
    box = db.box[valid].contiguous()
    pbc = analysis.handle_pbc
    here = coords.device
    h = coords.index_select(1, torch.as_tensor(heads, device=here))
    n_frames, n = h.shape[:2]

    def grew(name, fn):
        before = getattr(spectral, name)
        got = fn()
        torch.cuda.synchronize()
        if getattr(spectral, name) != before + 1:
            raise RuntimeError(f"{label}: {name} grew by "
                               f"{getattr(spectral, name) - before}")
        return got

    def times(kernel, plain, library=None):
        """CUDA-event ms per call in turns, plain, kernel, kernel, plain
        (`ms`, `plain_ms`: the lower of each pair), and the kernel's
        device time (`device_ms`: the calls queued behind a sleep), which
        is shorter where the host's launches, not the kernel, set `ms`."""
        plain_ms = cuda_ms(plain, reps=5, warmup=1)
        ms = cuda_ms(kernel, reps=20, warmup=3)
        ms2 = cuda_ms(kernel, reps=20, warmup=0)
        plain_ms2 = cuda_ms(plain, reps=5, warmup=0)
        lib = (None if library is None
               else cuda_ms(library, reps=5, warmup=1))
        dev = device_ms(kernel)
        return dict(ms=min(ms, ms2), device_ms=dev,
                    plain_ms=min(plain_ms, plain_ms2), library_ms=lib), \
            (plain_ms, ms, ms2, plain_ms2, dev)

    def share_of_bound(numbers):
        return (f"{numbers['bound_ms'] / numbers['ms']:.1%} of bound by CUDA "
                f"events, {numbers['bound_ms'] / numbers['device_ms']:.1%} "
                f"by device time")

    def projector_err(a, b, k):
        a, b = a.double()[..., :k], b.double()[..., :k]
        return float((a @ a.transpose(1, 2) - b @ b.transpose(1, 2))
                     .abs().max())

    def orthonormality(q):
        q = q.double()
        eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
        return float(torch.linalg.matrix_norm(q.transpose(1, 2) @ q - eye,
                                              ord=2).max())

    def gap(a, b, k):
        a, b = a.double()[..., :k], b.double()[..., :k]
        return float(torch.linalg.matrix_norm(
            a @ a.transpose(1, 2) - b @ b.transpose(1, 2), ord=2).max())

    out = {}
    # the similarity
    s_mat, degree = grew("affinity_launches", lambda: spectral.
                         spectral_affinity(h, box, pbc, cl.PRECISE_SIGMA))
    want_s, want_degree = spectral.spectral_affinity_plain(
        h, box, pbc, cl.PRECISE_SIGMA)
    d_err = (degree - want_degree).abs()
    s_err = (s_mat - want_s).abs()
    if bool((d_err > SPECTRAL_DEGREE_RTOL * want_degree.abs()).any()
            or (s_err > SPECTRAL_S_RTOL * want_s.abs() + TINY_F32).any()):
        raise RuntimeError(f"{label}: similarity off by up to "
                           f"{float(s_err.max()):.3e}, degrees "
                           f"{float(d_err.max()):.3e}")
    numbers, seq = times(
        lambda: spectral.spectral_affinity(h, box, pbc, cl.PRECISE_SIGMA),
        lambda: spectral.spectral_affinity_plain(h, box, pbc,
                                                 cl.PRECISE_SIGMA))
    print(f"kernel spectral_affinity {label}: B={n_frames}, n={n} heads; "
          f"S within {SPECTRAL_S_RTOL:g} of plain's, max |diff| "
          f"{float(s_err.max()):.3e}; degrees within "
          f"{SPECTRAL_DEGREE_RTOL:g}, max |diff| {float(d_err.max()):.3e}; "
          "ms per call: plain {:.4f}, kernel {:.4f}, kernel {:.4f}, plain "
          "{:.4f}; kernel device time {:.4f}".format(*seq), flush=True)
    out["spectral_affinity"] = with_bound(
        f"spectral_affinity {label}",
        dict(numbers, max_abs_err=float(s_err.max())),
        n_bytes(h, box, s_mat, degree),
        AFFINITY_WEIGHT_OPS[pbc] * n_frames * n * (n + 1) // 2
        + AFFINITY_ENTRY_OPS * n_frames * n * n
        + AFFINITY_HEAD_OPS * n_frames * n)
    print(f"kernel spectral_affinity {label}: "
          f"{spectral.affinity_plan(n).path} path, "
          f"{share_of_bound(out['spectral_affinity'])}", flush=True)

    # the thin QR: the chain's start basis and the filter's gp @ q
    v0 = torch.sqrt(torch.clamp(want_degree, min=0.0))
    v0 = v0 / torch.clamp(cl._norm(v0), min=1e-30)
    i = torch.arange(n, dtype=torch.float32, device=here)
    start = torch.stack([v0, torch.sin(0.7 * i + 0.3).expand_as(v0),
                         torch.cos(1.3 * i + 0.1).expand_as(v0)], -1)
    gp = want_s / cl._frame_max(want_s)
    for _ in range(12):
        gp = gp @ gp
        gp = gp / cl._frame_max(gp)
    ill = gp @ spectral.thin_qr3_plain(start)
    qr_err, notes = 0.0, []
    for name, a in (("start", start), ("gp @ q", ill)):
        q = grew("qr_launches", lambda a=a: spectral.thin_qr3(a))
        want = spectral.thin_qr3_plain(a)
        sv = torch.linalg.svdvals(a.double())
        k = int((sv >= 1e-6 * sv[:, :1]).all(0).sum())
        ortho = max(orthonormality(q), orthonormality(want))
        err = gap(q, want, k)
        if ortho > SPECTRAL_BASIS_TOL or err > SPECTRAL_BASIS_TOL:
            raise RuntimeError(f"{label}: thin_qr3 on {name}: "
                               f"||Q'Q - I|| {ortho:.3e}, projectors of "
                               f"{k} columns {err:.3e}")
        qr_err = max(qr_err, projector_err(q, want, k))
        notes.append(f"{name} (largest condition number "
                     f"{float((sv[:, 0] / sv[:, 2]).max()):.3e}): "
                     f"||Q'Q - I|| <= {ortho:.3e}, projectors of {k} "
                     f"columns within {err:.3e}")
    numbers, seq = times(lambda: spectral.thin_qr3(ill),
                         lambda: spectral.thin_qr3_plain(ill),
                         lambda: torch.linalg.qr(ill, mode="reduced"))
    print(f"kernel thin_qr3 {label}: B={n_frames}, n={n}; "
          + "; ".join(notes)
          + "; ms per call: plain {:.4f}, kernel {:.4f}, kernel {:.4f}, "
          "plain {:.4f}; kernel device time {:.4f}".format(*seq)
          + f", torch.linalg.qr {numbers['library_ms']:.4f}", flush=True)
    out["thin_qr3"] = with_bound(
        f"thin_qr3 {label}", dict(numbers, max_abs_err=qr_err),
        2 * n_bytes(ill), 0, QR_ROW_F64_OPS * n_frames * n)

    # the deflated span's two leading directions
    span = cl._top3_subspace(want_s, v0, spectral.thin_qr3_plain)
    u2 = grew("span_launches", lambda: spectral.top2_span(span, want_degree))
    want_u2 = spectral.top2_span_plain(span, want_degree)
    ortho, err = orthonormality(u2), gap(u2, want_u2, 2)
    if ortho > SPECTRAL_BASIS_TOL or err > SPECTRAL_BASIS_TOL:
        raise RuntimeError(f"{label}: top2_span: ||U'U - I|| {ortho:.3e}, "
                           f"projectors {err:.3e}")
    v = torch.sqrt(want_degree)
    v = v / cl._norm(v)
    deflated = span - v[..., None] * (v[:, None, :] @ span)
    numbers, seq = times(
        lambda: spectral.top2_span(span, want_degree),
        lambda: spectral.top2_span_plain(span, want_degree),
        lambda: torch.linalg.svd(deflated, full_matrices=False))
    print(f"kernel top2_span {label}: B={n_frames}, n={n}; ||U'U - I|| "
          f"{ortho:.3e}, projectors within {err:.3e}; ms per call: plain "
          "{:.4f}, kernel {:.4f}, kernel {:.4f}, plain {:.4f}; kernel "
          "device time {:.4f}".format(*seq)
          + f", torch.linalg.svd of the deflated span "
          f"{numbers['library_ms']:.4f}", flush=True)
    out["top2_span"] = with_bound(
        f"top2_span {label}",
        dict(numbers, max_abs_err=projector_err(u2, want_u2, 2)),
        n_bytes(span, want_degree, u2), 0, SPAN_ROW_F64_OPS * n_frames * n)

    # the embedding's k-means, stopped at its fixed point: its labels
    # against the plain 100 steps', its steps against the plain version
    # of its exit (`kmeans2_fixed_point`, whose labels must equal the 100
    # steps' too)
    lu2 = want_u2 - want_s @ want_u2
    iters = cl.KMEANS_ITERS
    steps = torch.empty(n_frames, dtype=torch.int32, device=here)
    labels = grew("kmeans_launches", lambda: spectral.rayleigh_kmeans(
        want_u2, lu2, iters, steps=steps))
    want_labels = spectral.rayleigh_kmeans_plain(want_u2, lu2, iters)
    fixed_labels, plain_steps = spectral.kmeans2_fixed_point(
        spectral.rayleigh_embedding(want_u2, lu2), iters)
    differ = int((labels != want_labels).any(1).sum())
    differ_fixed = int((fixed_labels != want_labels).any(1).sum())
    if differ or differ_fixed:
        raise RuntimeError(f"{label}: rayleigh_kmeans labels differ from "
                           f"plain's in {differ} of {n_frames} frames, the "
                           f"plain fixed point's in {differ_fixed}")
    numbers, seq = times(
        lambda: spectral.rayleigh_kmeans(want_u2, lu2, iters),
        lambda: spectral.rayleigh_kmeans_plain(want_u2, lu2, iters))

    def spread(t):
        t = t.cpu()
        return f"{int(t.min())} / {int(t.median())} / {int(t.max())}"

    moves = (f"kernel {spread(steps)}, plain {spread(plain_steps)} "
             f"({int((steps != plain_steps).sum())} frames differ)")
    print(f"kernel rayleigh_kmeans {label}: B={n_frames}, n={n}, "
          f"{spectral.kmeans_plan(n).path} path, at most {iters} steps; the "
          f"labels of all {n_frames} frames == plain's and the plain fixed "
          f"point's; centroid updates min / median / max: {moves}; ms per "
          "call: plain {:.4f}, kernel {:.4f}, kernel {:.4f}, plain "
          "{:.4f}; kernel device time {:.4f}".format(*seq), flush=True)
    # the bound twice: every frame `iters` centroid updates, and the
    # updates these inputs need (s of a frame: s + 1 passes of labels)
    moved = n_bytes(want_u2, lu2, labels)
    for ran, what in ((iters * n_frames, f"{iters} steps"),
                      (int(steps.long().sum()), "the steps these inputs "
                                                "need")):
        numbers = with_bound(
            f"rayleigh_kmeans {label} over {what}",
            dict(numbers, max_abs_err=0), moved,
            (KMEANS_ROW_OPS * n_frames + KMEANS_STEP_OPS * (ran + n_frames))
            * n,
            (KMEANS_ROW_F64_OPS * n_frames + KMEANS_STEP_F64_OPS * ran) * n)
    out["rayleigh_kmeans"] = numbers
    print(f"kernel rayleigh_kmeans {label}: {share_of_bound(numbers)}",
          flush=True)

    # the whole call: its device operations, its time and the plain chain's
    from torch.profiler import ProfilerActivity, profile

    classify = cl.make_spectral_labels(heads, pbc, device="cuda")
    classify(coords, box)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        classify(coords, box)
        torch.cuda.synchronize()
    device_ops = sum(1 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    call_ms = cuda_ms(lambda: classify(coords, box), reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: classify.plain(coords, box), reps=2, warmup=1)
    squarings_ms, _ = bound(0, 12 * 2 * n ** 3 * n_frames)
    print(f"classify spectral {label}: one call on B={n_frames} frames: "
          f"{device_ops} device operations (torch.profiler: kernels, copies, "
          f"sets); {call_ms:.4f} ms with the kernels, {plain_ms:.4f} ms "
          f"through the plain versions; the 12 squarings' bound "
          f"{squarings_ms:.4f} ms (operations)", flush=True)
    return out


def run_sharded(label, analysis, n_shards, counters, reference, cache,
                force=None):
    """`analysis` as `n_shards` frame shards through `Analysis.run_partial`
    on the card, each state written with `save_partial` and read back with
    `load_partial`, then `Analysis.merge`; with every launch count set to
    0 just before the shards and read just after (`counters` as in
    `_run`). The merged YAML must equal the `reference` file byte for
    byte. → launches."""
    import torch

    from gorder_tpu_torch.parallel.shard import load_partial, save_partial

    zero_launches()
    paths = []
    t0 = time.perf_counter()
    for i in range(n_shards):
        with forced_wire(force):
            state = analysis.run_partial(i, n_shards)
        paths.append(os.path.join(cache, f"{label}_part{i}.npz"))
        save_partial(paths[-1], state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_launches(label, launches, counters)
    t0 = time.perf_counter()
    results = analysis.merge([load_partial(p) for p in paths])
    results.write()
    merge = time.perf_counter() - t0
    with open(analysis.output_yaml) as fh, open(reference) as ref:
        if fh.read() != ref.read():
            raise RuntimeError(f"{label}: the merged YAML differs from "
                               f"{reference}")
    print(f"check {label}: {n_shards} shards in {wall:.3f} s, merged and "
          f"written in {merge:.3f} s; launches {counters} as expected; the "
          f"merged YAML equals {os.path.basename(reference)} byte for byte",
          flush=True)
    return launches


def check_exported_normals(results, path, first):
    """The export of `aa-dynamic-export`: the normals file holds one finite
    unit vector per analyzed frame and molecule, its first batch's rows are
    those the first batch's step used (`DeviceBatch.normal`) as printed,
    and the normals the run collected are those, bit for bit."""
    import re

    frames = results.normals_data["frames"]
    used = first.normal[first.mask].cpu().numpy()
    if not np.array_equal(frames[:len(used)], used):
        raise RuntimeError("aa-dynamic-export: the collected normals differ "
                           "from those the first batch's step used")
    with open(path) as fh:
        rows = "".join(ln for ln in fh if ln.startswith("  - ["))
    values = np.array(re.findall(r"-?\d+\.\d+|nan",
                                 rows.replace(".nan", "nan")), np.float64)
    want = (N_FRAMES, used.shape[1], 3)
    if values.size != np.prod(want):
        raise RuntimeError(f"aa-dynamic-export: {values.size} numbers in "
                           f"{path}, expected {want}")
    values = values.reshape(want)
    norm = np.linalg.norm(values, axis=-1)
    if not np.isfinite(values).all() or np.abs(norm - 1).max() > 1e-5:
        raise RuntimeError(f"aa-dynamic-export: normals not finite unit "
                           f"vectors (max ||n| - 1| {np.abs(norm - 1).max()})")
    printed = np.abs(values[:len(used)] - used).max()
    if printed > 5.0001e-7:
        raise RuntimeError(f"aa-dynamic-export: the file's first rows differ "
                           f"from the first batch's normals by {printed}")
    print(f"check aa-dynamic-export: {path} holds {want[0]} x {want[1]} "
          f"finite unit vectors (max ||n| - 1| {np.abs(norm - 1).max():.2e});"
          f" its first {len(used)} rows are the first batch's normals as "
          f"printed (max |diff| {printed:.2e}), collected bit for bit",
          flush=True)


def check_z_plane(aa_first, dyn_first, ua_first, ua_dyn_first, p2_static,
                  ua_static):
    """On the card, per-molecule normals that are all (0, 0, 1) must give
    the static kernels' integers bit for bit: the P2 kernel on the `aa`
    run's first b7 batch, the UA kernel on the `ua` run's first int16
    batch."""
    import torch

    from gorder_tpu_torch.ops import p2, ua

    z = torch.tensor([0.0, 0.0, 1.0], device="cuda")
    n_frames = aa_first.mask.shape[0]
    plane = z.expand(n_frames, dyn_first.normal.shape[1], 3).contiguous()
    step = aa_first.step
    got = p2.p2_b7(*wire_inputs(aa_first)["b7"], aa_first.box, plane,
                   aa_first.mask, step.bond_type, step.n_types,
                   handle_pbc=step.handle_pbc,
                   bond_mol=dyn_first.step.bond_mol)
    if not torch.equal(got, p2_static):
        raise RuntimeError("p2 normals: the z plane != the static normal")
    coords, scale = wire_inputs(ua_first)["i16"]
    ustep, dstep = ua_first.step, ua_dyn_first.step
    plane = z.expand(n_frames, ua_dyn_first.normal.shape[1], 3).contiguous()
    # the static run's atom indices, with each carbon's molecule
    indices = {cat: dict(ix, mol=dstep.indices[cat]["mol"])
               for cat, ix in ustep.indices.items()}
    got = ua.ua_positions(coords, scale, ua_first.box, plane, ua_first.mask,
                          indices, ustep.bond_type, ustep.n_types,
                          handle_pbc=ustep.handle_pbc, layout=ustep.layout)
    if not torch.equal(got, ua_static):
        raise RuntimeError("ua normals: the z plane != the static normal")
    print("kernel: per-molecule normals all (0, 0, 1) == the static normal, "
          "bit for bit, for the P2 kernel (b7, aa batch) and the UA kernel "
          "(int16, ua batch)", flush=True)


@contextlib.contextmanager
def environ(**values):
    """The environment variables `values` (None: unset) for the runs
    inside, restored after."""
    old = {name: os.environ.get(name) for name in values}
    try:
        for name, value in values.items():
            os.environ.pop(name, None)
            if value is not None:
                os.environ[name] = value
        yield
    finally:
        for name, value in old.items():
            os.environ.pop(name, None)
            if value is not None:
                os.environ[name] = value


def forced_wire(wire):
    """GORDER_TPU_WIRE = `wire` for the runs inside (None: the pick)."""
    return environ(GORDER_TPU_WIRE=wire)


def _run(label, analysis, counters, n_frames, watch=None, compat=False,
         force=None, device="cuda", batch_size=None):
    """`gorder_tpu_torch.run` with every launch count set to 0 just before
    and read just after; the counts named in `counters` must have their
    value there and every other count must be 0. `watch`, if given, sees
    every batch's `DeviceBatch`. With `compat`, `analysis` is a
    `gorder_tpu_torch.compat.Analysis` run as pygorder code runs it,
    `analysis.run()` with no argument (on the card by default), which
    hands out no batch. `force` names the wire GORDER_TPU_WIRE forces (the
    earlier phases that rode int16 before the wire pick preferred s6 and
    d8 keep it so; the runs of the b7 kinds force b7, since on the card
    the wire pick weighs the link rate and may take int16). `batch_size`
    replaces the default batch of 512 frames
    (`engine.drivers.run_analysis`). With `counters` None the launch counts
    are not checked here. The rate pick's and the frame mesh's log lines,
    if any, are printed with the run's. → (results, wall s, launches by
    count name, wire-format log line, the first batch's `DeviceBatch` as
    the run handed it to its step (its first slice under a mesh), or None
    with `compat`)."""
    import torch

    import gorder_tpu_torch
    from gorder_tpu_torch.engine.drivers import run_analysis
    from gorder_tpu_torch.utils.timers import timers

    wires, notes = [], []
    first = []

    class Wire(logging.Handler):
        def emit(self, record):
            message = record.getMessage()
            if message.startswith("wire format"):
                wires.append(message)
            elif message.startswith(("wire: ", "data-parallel")):
                notes.append(message)

    def on_batch(db):
        if db.index == 0:
            first.append(db)
        if watch is not None:
            watch(db)

    logger = logging.getLogger("gorder")
    handler = Wire(logging.INFO)
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    zero_launches()
    timers.reset()
    try:
        with forced_wire(force):
            t0 = time.perf_counter()
            if compat:
                results = analysis.run()
            elif batch_size is not None:
                results = run_analysis(analysis, device, batch_size,
                                       on_batch=on_batch)
            else:
                results = gorder_tpu_torch.run(analysis, device=device,
                                               on_batch=on_batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    launches = read_launches()
    t0 = time.perf_counter()
    results.write()
    write = time.perf_counter() - t0
    print(f"run {label}: {n_frames} frames in {wall:.3f} s = "
          f"{n_frames / wall:.1f} frames/s end to end; {wires[-1]}; "
          + "".join(f"{note}; " for note in notes)
          + f"launches {launches}; phases: {timers.summary()}; outputs "
          f"written in {write:.3f} s", flush=True)
    analyzed = (results.n_analyzed_frames() if compat
                else results.n_analyzed_frames)
    if analyzed != n_frames:
        raise RuntimeError(f"{label}: analyzed {analyzed} frames, expected "
                           f"{n_frames}")
    if counters is not None:
        check_launches(label, launches, counters)
    run_notes[label] = notes
    return results, wall, launches, wires[-1], first[0] if first else None


#: the rate pick's and the frame mesh's log lines of each `_run`, by label
run_notes = {}


def _launch_counts():
    from gorder_tpu_torch.ops import neighbors, p2, spectral, ua

    return [(mod, name) for mod in (p2, ua, neighbors, spectral)
            for name in dir(mod) if name.endswith("_launches")]


def zero_launches():
    """Set every kernel wrapper's launch count to 0."""
    for mod, name in _launch_counts():
        setattr(mod, name, 0)


def read_launches():
    return {name: getattr(mod, name) for mod, name in _launch_counts()}


def check_launches(label, launches, counters):
    """The counts named in `counters` must have their value, every other
    count must be 0."""
    for name, got in launches.items():
        if got != counters.get(name, 0):
            raise RuntimeError(f"{label}: {name} {got} != "
                               f"{counters.get(name, 0)} (expected "
                               f"{counters})")


def off_lines(yaml_path, label, n_frames):
    """The lines of the YAML that differ from the pinned golden, counted by
    their key (`total`, `upper`, `lower`, ...)."""
    import bench

    def lines(path):
        with open(path) as fh:
            return [ln for ln in fh.read().splitlines()
                    if not ln.startswith("#")]

    golden = os.path.join(bench.GOLDEN_DIR, f"{label}_{n_frames}.yaml")
    return dict(collections.Counter(
        g.strip().split(":")[0]
        for g, w in zip(lines(yaml_path), lines(golden)) if g != w))


def run_golden(label, analysis, counters, n_frames, golden=None, wire=None,
               exact=False, watch=None, compat=False, force=None):
    """`_run`, then the YAML must pass bench.validate_output against the
    pinned golden {golden}_{n_frames}.yaml (golden: the label by default),
    exactly if `exact`; the wire-format log line must hold `wire` if
    given. → (launches, results, first batch)."""
    import bench

    golden = golden or label
    results, _, launches, wire_line, first = _run(label, analysis, counters,
                                                  n_frames, watch, compat,
                                                  force)
    if wire is not None and wire not in wire_line:
        raise RuntimeError(f"{label}: rode {wire_line!r}, expected {wire!r}")
    status = bench.validate_output(analysis.output_yaml, golden, n_frames)
    if status is None:
        raise RuntimeError(f"no pinned golden for {golden}_{n_frames}")
    if exact and status != "exact":
        raise RuntimeError(f"{label}: {status} against {golden}, expected "
                           f"exact")
    values = ([m.average_order().total().value() for m in results.molecules()]
              if compat else
              [m.average_order.total.value for m in results.molecules])
    if not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"{label}: non-finite average order: {values}")
    where = ("" if status == "exact" else
             f" (lines off, by key: "
             f"{off_lines(analysis.output_yaml, golden, n_frames)})")
    print(f"check {label}: launches {counters} as expected; golden "
          f"{golden}_{n_frames}.yaml: {status}{where}; average order "
          f"{values}", flush=True)
    return launches, results, first


def _orders(results, cls):
    """Every order value of class `cls` in the results tree, in order."""
    out = []
    for mol in results.molecules:
        out.append(getattr(mol.average_order, cls).value)
        out += [getattr(bond.order, cls).value for bond in mol.bonds]  # CG
        for atom in mol.atoms:
            out.append(getattr(atom.order, cls).value)
            out += [getattr(bond.order, cls).value for bond in atom.bonds]
    return out


def kernel_entry(name, source, replaces, launches, numbers):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": numbers["max_abs_err"], "ms": numbers["ms"],
            "plain_ms": numbers["plain_ms"],
            "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            # one PyTorch call that computes the same function, where there
            # is one (the spectral QR and SVD); none computes the order-
            # parameter or neighbour sums
            "library_ms": numbers.get("library_ms"),
            # the spectral kernels' calls queued on the card (`device_ms`)
            **({"device_ms": numbers["device_ms"]}
               if "device_ms" in numbers else {})}


def cg_analysis(g, gro, bnd, trajectory, output_yaml=None, **kw):
    """tools/bench_modes.py `_make_analysis("cg")`, built from the
    namespace `g`: the pygorder drop-in `gorder_tpu_torch.compat` or the
    package itself."""
    return g.Analysis(structure=gro, bonds=bnd, trajectory=trajectory,
                      analysis_type=g.analysis_types.CGOrder("resname POPC"),
                      output_yaml=output_yaml, n_threads=os.cpu_count() or 1,
                      silent=True, overwrite=True, **kw)


def _mean_error(node):
    """(mean, error) of a YAML order entry: `total: v`, or `total:` with
    `mean:` and `error:` under it (error estimation)."""
    node = node["total"]
    return ((node["mean"], node["error"]) if isinstance(node, dict)
            else (node, None))


def cg_yaml_orders(path):
    """A CG run's YAML as {molecule: {"average" or bond key: (mean,
    error)}}, bond keys as printed ("POPC NC3 (0) - POPC PO4 (1)")."""
    import yaml

    with open(path) as fh:
        doc = yaml.safe_load(fh)
    return {name: {"average": _mean_error(node["average order"]),
                   **{key: _mean_error(bond) for key, bond
                      in node["order parameters"].items()}}
            for name, node in doc.items() if name != "average order"}


def check_cg_views(label, results, yaml_path):
    """The method-style views of a CG run (pygorder's `results`): every
    molecule's `average_order().total()` and every bond's
    `order().total()`, their `value()` printed at 4 decimals, must be the
    YAML's values. → {(molecule, key): (value(), error())}."""
    printed = cg_yaml_orders(yaml_path)
    views = {}
    for mol in results.molecules():
        name = mol.molecule()
        views[name, "average"] = mol.average_order().total()
        for bond in mol.bonds():
            a, b = bond.atoms()
            views[name, f"{a.residue_name()} {a.atom_name()} "
                        f"({a.relative_index()}) - {b.residue_name()} "
                        f"{b.atom_name()} ({b.relative_index()})"] = \
                bond.order().total()
    if len(views) != sum(len(v) for v in printed.values()):
        raise RuntimeError(f"{label}: {len(views)} views, the YAML holds "
                           f"{sum(len(v) for v in printed.values())} values")
    for (name, key), order in views.items():
        if float(f"{order.value():.4f}") != printed[name][key][0]:
            raise RuntimeError(f"{label}: {name} {key}: value() "
                               f"{order.value()}, the YAML "
                               f"{printed[name][key][0]}")
    print(f"check {label}: {len(views)} values through the method-style "
          f"views (average_order().total().value(), order().total()"
          f".value()) print as the YAML's at 4 decimals", flush=True)
    return {key: (order.value(), order.error())
            for key, order in views.items()}


def check_cg_files(label, analysis, molecules):
    """The TAB and CSV files and the XVG file of each molecule type of a
    CG run with error estimation must hold the YAML's means and errors at
    their printed 4 decimals (the XVG, the means), every bond and average
    once. → {file: values compared}."""
    import re

    from gorder_tpu_torch.present.xvg_out import xvg_path_for

    want = {}
    for name, orders in cg_yaml_orders(analysis.output_yaml).items():
        for key, mean_error in orders.items():
            short = "AVERAGE" if key == "average" else re.sub(
                r"\S+ (\S+) \(\d+\) - \S+ (\S+) \(\d+\)", r"\1 - \2", key)
            want[name, short] = mean_error
    seen = collections.Counter()

    def same(kind, name, short, mean, error=None):
        m, e = want[name, short]
        if float(mean) != m or (error is not None and float(error) != e):
            raise RuntimeError(f"{label}: {kind} {name} {short}: {mean} ± "
                               f"{error}, the YAML {m} ± {e}")
        seen[kind] += 1

    with open(analysis.output_csv) as fh:
        for row in fh.read().splitlines()[1:]:
            mol, a, b, mean, error = row.split(",")
            same("csv", mol, f"{a} - {b}", mean, error)
    mol = None
    with open(analysis.output_tab) as fh:
        for line in fh:
            if line.startswith("Molecule type "):
                mol = line.split()[-1]
            elif line.startswith("All molecule types"):
                mol = None
            found = re.match(r"(\S+ - \S+|AVERAGE)\s+(-?\d+\.\d+) ± "
                             r"(\d+\.\d+)", line)
            if found and mol is not None:
                same("tab", mol, found[1], found[2], found[3])
    for name in molecules:
        with open(xvg_path_for(analysis.output_xvg, name)) as fh:
            lines = fh.read().splitlines()
        for head, row in zip(lines, lines[1:]):
            found = re.match(r"# Bond (\S+ - \S+):", head)
            if found:
                same("xvg", name, found[1], row.split()[1])
    n_bonds = len(want) - len(molecules)
    expected = {"csv": n_bonds, "tab": len(want), "xvg": n_bonds}
    if dict(seen) != expected:
        raise RuntimeError(f"{label}: values found {dict(seen)}, expected "
                           f"{expected}")
    print(f"check {label}: TAB, CSV and {len(molecules)} XVG file(s) hold "
          f"the YAML's values at 4 decimals ({dict(seen)} values)",
          flush=True)
    return dict(seen)


def same_lines(label, path, reference):
    """The YAML at `path` must equal `reference` line for line but the
    `#` header."""
    def lines(p):
        with open(p) as fh:
            return [ln for ln in fh.read().splitlines()
                    if not ln.startswith("#")]

    if lines(path) != lines(reference):
        raise RuntimeError(f"{label}: {path} differs from {reference}")
    print(f"check {label}: the YAML equals {os.path.basename(reference)} "
          f"line for line but the header ({len(lines(path))} lines)",
          flush=True)


def same_bytes(label, path, reference):
    """The file at `path` must equal `reference` byte for byte."""
    with open(path, "rb") as a, open(reference, "rb") as b:
        if a.read() != b.read():
            raise RuntimeError(f"{label}: {path} differs from {reference}")
    print(f"check {label}: {os.path.basename(path)} equals "
          f"{os.path.basename(reference)} byte for byte", flush=True)


def same_tree(label, directory, reference):
    """Every file under `directory` must equal the one at the same path
    under `reference` byte for byte, and neither may hold one the other
    lacks."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, names in os.walk(root) for f in names)

    got, want = files(directory), files(reference)
    if got != want:
        raise RuntimeError(f"{label}: {directory} holds {len(got)} files, "
                           f"{reference} {len(want)}, or other names")
    for rel in got:
        with open(os.path.join(directory, rel), "rb") as a, \
                open(os.path.join(reference, rel), "rb") as b:
            if a.read() != b.read():
                raise RuntimeError(f"{label}: {rel} differs from "
                                   f"{reference}'s")
    print(f"check {label}: all {len(got)} files of {directory} equal "
          f"{os.path.basename(reference)}'s byte for byte", flush=True)


def check_decoder(label, db):
    """The card's reconstruction of a batch of the s6 or d8 wire (the
    int32 XTC integers the step takes) against the CPU's on the same
    payload: equal integer for integer. → CUDA-event ms of one decode."""
    import torch

    from gorder_tpu_torch.engine.fused import decode_positions

    got = decode_positions(db.kind, db.wire, 0)
    want = decode_positions(db.kind, tuple(w.cpu() for w in db.wire), 0)
    if got.dtype != torch.int32 or not torch.equal(got.cpu(), want):
        raise RuntimeError(f"{label}: the card's {db.kind} decode differs "
                           f"from the CPU's")
    ms = cuda_ms(lambda: decode_positions(db.kind, db.wire, 0), reps=10)
    print(f"check {label}: the {db.kind} decode on the card == the CPU's, "
          f"{tuple(got.shape)} int32, values {int(got.min())}.."
          f"{int(got.max())}; {ms:.4f} ms a batch on the card "
          f"({n_bytes(*db.wire)} wire bytes)", flush=True)
    return ms


def trace_summary(label, directory, wall, top=12):
    """The device operations of the torch.profiler trace a run wrote into
    `directory` (GORDER_TPU_PROFILE): each kernel's time summed under the
    PyTorch operation that launched it (the trace's "External id"), or
    under its own name where none did (the hand-written kernels, launched
    through ctypes); the `top` ones printed with their share, and the
    device's busy share of the run's wall (which the tracing lengthens).
    → {operation: ms}."""
    import glob

    paths = glob.glob(os.path.join(directory, "trace-*.json"))
    if len(paths) != 1:
        raise RuntimeError(f"{label}: {len(paths)} traces in {directory}")
    with open(paths[0]) as fh:
        events = json.load(fh)["traceEvents"]
    op_of = {ev["args"]["External id"]: ev["name"] for ev in events
             if ev.get("cat") == "cpu_op"
             and "External id" in ev.get("args", {})}
    device = collections.Counter()
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            name = op_of.get(ev.get("args", {}).get("External id"),
                             ev["name"])
            device[name] += ev.get("dur", 0) / 1e3
    total = sum(device.values())
    if not total:
        raise RuntimeError(f"{label}: the trace holds no device time")
    print(f"trace {label}: {len(events)} events, device busy {total:.3f} ms "
          f"of the {wall * 1e3:.1f} ms wall ({total / (wall * 1e3):.1%}); "
          f"{len(device)} device operations, the top {top}:", flush=True)
    for name, ms in device.most_common(top):
        print(f"trace {label}:   {ms:10.3f} ms {ms / total:6.1%} "
              f"{name[:100]}", flush=True)
    ours = sum(ms for n, ms in device.items()
               if any(k in n for k in ("p2_kernel", "ua_kernel",
                                       "normal_cloud_kernel",
                                       "local_sums_kernel")))
    print(f"trace {label}: the hand-written kernels {ours:.3f} ms "
          f"({ours / total:.1%} of the device time)", flush=True)
    return dict(device)


def check_chain(label, files, cache):
    """The first `CHAIN_FRAMES` frames of ves-spherical on the card and on
    the CPU, whose run the CPU tests hold to gorder_tpu's: the int32
    integers decoded and the leaflet classes must be equal, and the card's
    per-frame, per-type int64 sums must equal the CPU plain step's on the
    CPU's integers with the card's classes and normals. The normals come
    from two eigensolvers (cuSOLVER, LAPACK); their largest difference, up
    to sign, and the difference of the two runs' own sums are printed, the
    sums held to the port's bar: equal counts and |Δsum| ≤ the samples of
    each (frame, type). The batch is the chain's frames, so that the CPU
    computes no padding frame."""
    import torch

    from gorder_tpu_torch.engine.fused import decode_positions
    from gorder_tpu_torch.ops import p2

    end = (CHAIN_FRAMES - 1) * 10.0
    firsts = {}
    for device in ("cuda", "cpu"):
        _, _, _, wire_line, firsts[device] = _run(
            f"{label} on {device}", vesicle_analysis(
                files, os.path.join(cache, f"smoke_{label}-{device}.yaml"),
                spherical=True, end=end),
            {"p2_i32_normals_launches": 1, "normals_launches": 1}
            if device == "cuda" else {},
            CHAIN_FRAMES, device=device, batch_size=CHAIN_FRAMES)
        if not any(f"wire format: {w}" in wire_line for w in ("s6", "d8")):
            raise RuntimeError(f"{label} on {device}: {wire_line}")
    card, host = firsts["cuda"], firsts["cpu"]
    q = decode_positions(host.kind, host.wire, 0)
    if not torch.equal(decode_positions(card.kind, card.wire, 0).cpu(), q):
        raise RuntimeError(f"{label}: the decoded integers differ")
    if not torch.equal(card.classes.cpu(), host.classes):
        raise RuntimeError(f"{label}: the leaflet classes differ")
    step = host.step
    want = p2.p2_positions_plain(
        q, step.atom_a, step.atom_b, host.scale, host.box,
        card.normal.cpu(), host.mask, step.bond_type, step.n_types,
        handle_pbc=step.handle_pbc, classes=card.classes.cpu(),
        bond_mol=step.bond_mol)
    got = card.out.cpu()
    if not torch.equal(got, want):
        raise RuntimeError(f"{label}: the card's sums differ from the CPU "
                           f"plain step's with the card's normals")
    valid = host.mask
    a, b = card.normal.cpu()[valid], host.normal[valid]
    normal_diff = float(torch.minimum((a - b).abs(), (a + b).abs()).max())
    own = host.out
    off = (own - got)[valid]
    if (not torch.equal(own[valid][..., 1, :], got[valid][..., 1, :])
            or (off[..., 0, :].abs() > got[valid][..., 1, :]).any()):
        raise RuntimeError(f"{label}: the CPU run's own sums leave the bar")
    print(f"check {label}: {int(valid.sum())} frames, card == CPU: the "
          f"{host.kind} integers and the classes equal; the card's int64 "
          f"sums == the CPU plain step's with the card's normals; the CPU's "
          f"own normals "
          f"differ from the card's by at most {normal_diff:.3e} (up to "
          f"sign), its own sums in {int((off != 0).sum())} of "
          f"{off.numel()} entries, by at most {int(off.abs().max())} "
          f"quanta (counts equal)", flush=True)


def _input_of(kind):
    """The P2 or UA kernel input a wire kind feeds: b7, i16 (i16, i12),
    i32 (s6, d8) or f32."""
    base = kind.rstrip("gG")
    return ("b7" if kind.startswith("b7") else "i32" if base in ("s6", "d8")
            else "f32" if base == "f32" else "i16")


def pick_phase(gro, bnd, xtc, ua_files, cg_files, cache):
    """aa, ua and cg with no GORDER_TPU_WIRE: the wire the rate pick takes
    on the card (`engine/wire.py`: the link rate measured, the host's
    int16 decode rate, the model), each YAML against its golden, the
    launch count of the kernel input the pick fed (one a batch, UA one a
    category), and the P2 kernel against plain on the first batch of the
    aa and cg runs. → ({kernel entry: launches}, {input: check_p2
    numbers} of the P2 inputs the picks fed)."""
    import bench
    import gorder_tpu_torch
    from gorder_tpu_torch.engine.wire import measure_link_mbps
    from tools import bench_modes

    link = measure_link_mbps("cuda")
    print(f"pick: host-to-device rate of one pageable 6 MiB copy "
          f"(measure_link_mbps): {link:.1f} MiB/s", flush=True)
    launches, numbers = {}, {}
    ua_frames, cg_frames = bench_modes.UA_FRAMES, bench_modes.CG_FRAMES
    for label, golden, n_frames, analysis in (
            ("aa-pick", "aa", N_FRAMES, aa_analysis(
                gro, bnd, xtc, os.path.join(cache, "smoke_aa-pick.yaml"))),
            ("ua-pick", "ua", ua_frames, ua_analysis(
                "ua", *ua_files, os.path.join(cache, "smoke_ua-pick.yaml"))),
            ("cg-pick", "cg", cg_frames, cg_analysis(
                gorder_tpu_torch, *cg_files,
                os.path.join(cache, "smoke_cg-pick.yaml")))):
        kinds = set()
        _, wall, got, wire_line, first = _run(
            label, analysis, None, n_frames,
            watch=lambda db: kinds.add(db.kind))
        inputs = {_input_of(k) for k in kinds}
        if len(inputs) != 1:
            raise RuntimeError(f"{label}: batches of kinds {kinds}")
        inp = inputs.pop()
        batches = math.ceil(n_frames / BATCH)
        if label == "ua-pick":
            count = "ua_i32_launches" if inp == "i32" else "ua_launches"
            counters = {count: batches * 3}
            entry = "ua_i32" if inp == "i32" else "ua"
        else:
            count = "p2_i32_launches" if inp == "i32" else "p2_launches"
            counters = {count: batches}
            entry = "p2" if inp == "b7" else f"p2_{inp}"
        check_launches(label, got, counters)
        launches[entry] = launches.get(entry, 0) + got[count]
        status = bench.validate_output(analysis.output_yaml, golden,
                                       n_frames)
        if status is None:
            raise RuntimeError(f"{label}: no pinned golden {golden}")
        print(f"check {label}: the pick took {wire_line!r} "
              f"({' '.join(sorted(kinds))}): {n_frames / wall:.1f} frames/s"
              f"; {'; '.join(run_notes[label]) or 'no rate-pick line'}; "
              f"launches {counters} as expected; golden {golden}_{n_frames}"
              f".yaml: {status}", flush=True)
        if label != "ua-pick" and inp not in numbers:
            numbers[inp] = check_p2(label, first, leaflets=False)[inp]
    return launches, numbers


def mesh_phase(gro, bnd, xtc, ua_files, cache):
    """aa (b7), ua (int16) and ua on d8 (each slice's integers on top of
    the slice before it) split over two copies of cuda:0
    (`parallel.context.visible_devices` replaced): the log line, exactly
    two launches a batch (UA: a category), each YAML byte for byte the
    single-device run's, and each slice's output on the first batch equal
    to the plain version on that slice's inputs alone; then, where more
    than one card is visible, aa over all of them. → {kernel entry:
    launches}."""
    import torch

    from gorder_tpu_torch.engine.fused import decode_positions
    from gorder_tpu_torch.ops import p2, ua
    from gorder_tpu_torch.parallel import context
    from tools import bench_modes

    ua_frames = bench_modes.UA_FRAMES
    aa_batches = math.ceil(N_FRAMES / BATCH)
    ua_batches = math.ceil(ua_frames / BATCH)
    card = torch.device("cuda", 0)
    visible = context.visible_devices
    launches = {}

    def path(label):
        return os.path.join(cache, f"smoke_{label}.yaml")

    runs = (
        ("aa-mesh", aa_analysis(gro, bnd, xtc, path("aa-mesh")), N_FRAMES,
         "b7", {"p2_launches": 2 * aa_batches}, "p2", "smoke_order.yaml"),
        ("ua-mesh", ua_analysis("ua", *ua_files, path("ua-mesh")),
         ua_frames, "i16", {"ua_launches": 2 * ua_batches * 3}, "ua",
         "smoke_ua.yaml"),
        ("ua-mesh-d8", ua_analysis("ua", *ua_files, path("ua-mesh-d8")),
         ua_frames, "d8", {"ua_i32_launches": 2 * ua_batches * 3},
         "ua_i32", "smoke_ua-d8.yaml"))
    try:
        context.visible_devices = lambda device: [card, card]
        with environ(GORDER_TPU_MESH=None):
            for (label, analysis, n_frames, wire, counters, entry,
                 ref) in runs:
                slices = []
                _, _, got, _, _ = _run(
                    label, analysis, counters, n_frames,
                    watch=lambda db: slices.append(db) if db.index == 0
                    else None, force=wire)
                if run_notes[label] != [
                        "data-parallel over 2 devices ('frames' mesh)"]:
                    raise RuntimeError(f"{label}: {run_notes[label]}")
                launches[entry] = got[next(iter(counters))]
                same_bytes(label, analysis.output_yaml,
                           os.path.join(cache, ref))
                if [db.shard for db in slices] != [0, 1]:
                    raise RuntimeError(f"{label}: first batch slices "
                                       f"{[db.shard for db in slices]}")
                for db in slices:
                    step = db.step
                    if db.kind.startswith("b7"):
                        want = p2.p2_b7_plain(
                            *db.wire[:4], db.scale, db.box, db.normal,
                            db.mask, step.bond_type, step.n_types,
                            handle_pbc=step.handle_pbc)
                    else:
                        want = ua.ua_positions_plain(
                            decode_positions(db.kind, db.wire, 0), db.scale,
                            db.box, db.normal, db.mask, step.indices,
                            step.bond_type, step.n_types,
                            handle_pbc=step.handle_pbc, layout=step.layout)
                    if not torch.equal(db.out, want):
                        raise RuntimeError(f"{label}: slice {db.shard} of "
                                           f"the first batch != plain")
                print(f"check {label}: the first batch's two slices of "
                      f"{slices[0].mask.shape[0]} frames ({slices[0].kind})"
                      f" each equal the plain version on their own inputs",
                      flush=True)
    finally:
        context.visible_devices = visible
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"mesh over all cards: not run ({n_cards} card visible)",
              flush=True)
        return launches
    n = n_cards
    while BATCH % n:
        n -= 1
    with environ(GORDER_TPU_MESH=None):
        _, _, got, _, _ = _run("aa-mesh-cards", aa_analysis(
            gro, bnd, xtc, path("aa-mesh-cards")),
            {"p2_launches": n * aa_batches}, N_FRAMES, force="b7")
    same_bytes("aa-mesh-cards", path("aa-mesh-cards"),
               os.path.join(cache, "smoke_order.yaml"))
    print(f"mesh over all cards: {n_cards} visible, batches split over "
          f"{n}", flush=True)
    launches["p2"] += got["p2_launches"]
    return launches


def knob_phase(gro, bnd, xtc, ua_files, cache):
    """The environment knobs on the card: GORDER_TPU_BATCH_SIZE=256 (aa,
    twice the batches, the same YAML), GORDER_TPU_B7_LEAFLETS=0
    (aa-leaflets with b7 asked for: no b7 kind and no decoder COG, the
    membrane center taken on the card, against the golden),
    GORDER_TPU_GEO_CHANNEL=0 (aa-geometry with b7 asked for: no decoder
    bitplane, the inside test on the card, against the golden) and
    GORDER_TPU_PREFETCH=2 (ua, the same YAML). → {kernel entry:
    launches}."""
    from tools import bench_modes

    n_batches = math.ceil(N_FRAMES / BATCH)
    ua_frames = bench_modes.UA_FRAMES
    launches = {}
    with environ(GORDER_TPU_BATCH_SIZE="256"):
        path = os.path.join(cache, "smoke_aa-batch256.yaml")
        _, _, got, _, _ = _run("aa-batch256", aa_analysis(gro, bnd, xtc, path),
                               {"p2_launches": math.ceil(N_FRAMES / 256)},
                               N_FRAMES, force="b7")
    same_bytes("aa-batch256", path, os.path.join(cache, "smoke_order.yaml"))
    launches["p2"] = got["p2_launches"]
    for label, knob, golden, analysis, count, entry in (
            ("aa-leaflets-b7off", "GORDER_TPU_B7_LEAFLETS", "aa-leaflets",
             leaflet_analysis("aa-leaflets", gro, bnd, xtc, cache, os.path.join(
                 cache, "smoke_aa-leaflets-b7off.yaml")),
             "p2_i16_leaflets_launches", "p2_i16_leaflets"),
            ("aa-geometry-geooff", "GORDER_TPU_GEO_CHANNEL", "aa-geometry",
             aa_analysis(gro, bnd, xtc, os.path.join(
                 cache, "smoke_aa-geometry-geooff.yaml"),
                 geometry=geometry_params()),
             "p2_i16_geom_launches", "p2_i16_geom")):
        kinds = set()
        with environ(**{knob: "0"}):
            got, _, _ = run_golden(label, analysis, {count: n_batches},
                                   N_FRAMES, golden=golden,
                                   watch=lambda db: kinds.add(db.kind),
                                   force="b7")
        if kinds != {"i16"}:
            raise RuntimeError(f"{label}: batch kinds {kinds}, expected "
                               f"i16 alone (no b7 kind, no decoder side "
                               f"channel)")
        print(f"check {label}: {knob}=0 with b7 asked for: every batch "
              f"rode i16, with no decoder side channel", flush=True)
        launches[entry] = got[count]
    with environ(GORDER_TPU_PREFETCH="2"):
        path = os.path.join(cache, "smoke_ua-prefetch2.yaml")
        _, _, got, _, _ = _run(
            "ua-prefetch2", ua_analysis("ua", *ua_files, path),
            {"ua_launches": math.ceil(ua_frames / BATCH) * 3}, ua_frames,
            force="i16")
    same_bytes("ua-prefetch2", path, os.path.join(cache, "smoke_ua.yaml"))
    launches["ua"] = got["ua_launches"]
    return launches


def main_path_batch_ms(db):
    """CUDA-event time of a b7 batch's whole device work on the main path:
    the P2 kernel, from the packed wire in to the type sums out."""
    from gorder_tpu_torch.ops import p2

    step = db.step
    batch_ms = cuda_ms(lambda: p2.p2_b7(
        *db.wire[:4], db.scale, db.box, db.normal, db.mask, step.bond_type,
        step.n_types, handle_pbc=step.handle_pbc))
    print(f"kernel: device time per batch on the main path (the P2 kernel, "
          f"packed b7 wire in, type sums out): {batch_ms:.4f} ms",
          flush=True)
    return batch_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    started = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)

    from gorder_tpu_torch.ops import build

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
    # every phase but the mesh phase runs on one card: a run on "cuda"
    # would split its batches over every visible card
    os.environ["GORDER_TPU_MESH"] = "0"

    # 2. build
    t0 = time.perf_counter()
    so_path, log = build.build()
    build.load()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"build: {os.path.relpath(so_path, root)} in "
          f"{time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(ptxas)}",
          flush=True)

    # 3. the UA kernel on a synthetic batch with all four carbon categories
    check_ua_synthetic()

    # 4. synth
    cache = os.path.join(tempfile.gettempdir(), "gorder_tpu_torch_smoke")
    os.makedirs(cache, exist_ok=True)
    t0 = time.perf_counter()
    gro, bnd, _ = synthesize_structure(cache)
    # the pinned golden's trajectory starts from the positions as read
    # back from bench.gro (3 decimals), as bench.py does once bench.gro
    # is cached
    from gorder_tpu_torch.engine.prepare import load_structure

    system = load_structure(
        aa_analysis(gro, bnd, os.path.join(cache, "missing.xtc")))
    xtc = synthesize_trajectory(cache, system, N_FRAMES)
    print(f"synth: {system.n_atoms} atoms, {N_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s ({os.path.getsize(xtc)} bytes "
          f"of XTC)", flush=True)

    # 5. the main path, end to end; then the P2 kernel against plain on
    # its first batch
    n_batches = math.ceil(N_FRAMES / BATCH)
    launches, _, aa_first = run_golden(
        "aa", aa_analysis(gro, bnd, xtc,
                          os.path.join(cache, "smoke_order.yaml")),
        {"p2_launches": n_batches}, N_FRAMES, force="b7")
    p2_plain = check_p2("aa", aa_first, leaflets=False)
    batch_ms = main_path_batch_ms(aa_first)
    print(f"run aa on {kind}: device work ~{n_batches} x {batch_ms:.3f} ms "
          f"per batch", flush=True)

    # 6. the AA leaflet modes, end to end; then the with_leaflets P2
    # kernel against plain on the first batch of the global (b7g) and the
    # local (int16) runs, with the classes each run's step used
    leaflet_launches = {}
    firsts = {}
    for mode in LEAFLET_MODES:
        local = mode == "aa-local-leaflets"
        count = ("p2_i16_leaflets_launches" if local
                 else "p2_leaflets_launches")
        # the local classifier: one launch of its kernel a batch
        counters = ({count: n_batches, "local_launches": n_batches} if local
                    else {count: n_batches})
        got, _, firsts[mode] = run_golden(
            mode, leaflet_analysis(mode, gro, bnd, xtc, cache,
                                   os.path.join(cache, f"smoke_{mode}.yaml")),
            counters, N_FRAMES, force="i16" if local else "b7")
        leaflet_launches[mode] = got[count]
        if local:
            local_runs = got["local_launches"]
    p2_global = check_p2("aa-leaflets", firsts["aa-leaflets"], True)
    local = firsts["aa-local-leaflets"]
    p2_positions = check_p2("aa-local-leaflets", local, False)
    p2_local = check_p2("aa-local-leaflets", local, True)
    if not torch.equal(p2_plain["b7"]["out"], p2_positions["i16"]["out"]):
        raise RuntimeError("b7 wire input and int16 positions disagree: "
                           "both must give the same integer bond vectors")
    print("kernel: b7 wire input == int16 positions on the first batch "
          "(same integer bond vectors)", flush=True)
    local_numbers = check_local("aa-local-leaflets", local)
    del local

    time_classifiers(gro, bnd, xtc, cache)

    # 18. spherical clustering on the aa membrane (int16, the classifier
    # with the step): its golden, then the with_leaflets P2 kernel against
    # plain on its first batch, and the classifier's time a batch
    check_f32_matmuls()
    clustering_launches = {}
    spherical = leaflet_analysis(
        "aa-spherical-leaflets", gro, bnd, xtc, cache,
        os.path.join(cache, "smoke_aa-spherical-leaflets.yaml"))
    got, _, first = run_golden(
        "aa-spherical-leaflets", spherical,
        {"p2_i16_leaflets_launches": n_batches}, N_FRAMES,
        wire="wire format: i16", force="i16")
    clustering_launches["aa-spherical-leaflets"] = \
        got["p2_i16_leaflets_launches"]
    check_p2("aa-spherical-leaflets", first, True)
    time_clustering("aa-spherical-leaflets", spherical, first)
    del first

    # 19a. aa as 3 frame shards on the card, merged: byte for byte the YAML
    # of phase 5
    from gorder_tpu_torch.engine.batches import _shard_block

    shard_batches = sum(math.ceil(len(range(*block)) / BATCH) for block in (
        _shard_block(N_FRAMES, (i, 3), 1) for i in range(3)))
    sharded = run_sharded(
        "aa-sharded", aa_analysis(gro, bnd, xtc, os.path.join(
            cache, "smoke_aa-sharded.yaml")), 3,
        {"p2_launches": shard_batches}, os.path.join(cache,
                                                     "smoke_order.yaml"),
        cache, force="b7")

    # 7. the AA runs with membrane normals that are not static: the two
    # dynamic modes ride b7x (the normal-heads cloud as aux atoms) and
    # pass their goldens; the manual (0, 0, 1) map rides int16 and must
    # equal the static golden exactly. Then the per_bond_normal P2 kernel
    # against plain on their first batches, with the normals each step
    # used: b7 (aa-dynamic), int16 and f32 (aa-manual-z), and with both
    # classes and normals (aa-leaflets' classes on aa-dynamic's batch)
    from types import SimpleNamespace

    import bench
    from gorder_tpu_torch.engine.normals_runtime import _manual_normals_table

    first_calls()
    normal_launches = {}
    normals_runs = 0
    for mode in NORMAL_MODES:
        manual = mode == "aa-manual-z"
        analysis = normals_analysis(mode, gro, bnd, xtc, cache,
                                    os.path.join(cache, f"smoke_{mode}.yaml"))
        if manual:
            t0 = time.perf_counter()
            _manual_normals_table(
                analysis.membrane_normal.normals_map,
                [SimpleNamespace(name="POPC", n_molecules=bench.N_LIPIDS)])
            print(f"normals: the {N_FRAMES} x {bench.N_LIPIDS} manual table "
                  f"takes {time.perf_counter() - t0:.3f} s on the host",
                  flush=True)
        count = ("p2_i16_normals_launches" if manual
                 else "p2_normals_launches")
        # dynamic normals: one launch of their kernel a batch
        counters = ({count: n_batches} if manual
                    else {count: n_batches, "normals_launches": n_batches})
        got, results, firsts[mode] = run_golden(
            mode, analysis, counters, N_FRAMES,
            golden="aa" if manual else None,
            wire="wire format: i16" if manual else "aux channel",
            exact=manual, force="i16" if manual else "b7")
        normal_launches[mode] = got[count]
        normals_runs += got["normals_launches"]
        if analysis.membrane_normal.collect.enabled:
            check_exported_normals(results,
                                   analysis.membrane_normal.collect.path,
                                   firsts[mode])
    dyn_first = firsts["aa-dynamic"]
    check_normals("aa-dynamic", dyn_first)
    check_neighbor_ties()
    p2_normals = check_p2("aa-dynamic", dyn_first, False)
    p2_i16_normals = check_p2("aa-manual-z", firsts["aa-manual-z"], False)
    check_p2("aa-dynamic with aa-leaflets classes",
             dataclasses.replace(dyn_first,
                                 classes=firsts["aa-leaflets"].classes),
             True)

    # 14. the AA geometry runs: b7 with the decoder's bitplane (b7geo), and
    # forced onto int16 (i16G, the same bitplane), both against the
    # aa-geometry golden; then the with_geom P2 kernel against plain on
    # their first batches: b7 as handed over, with aa-leaflets' classes and
    # with aa-dynamic's normals; int16, f32, and the pair input with a map
    from gorder_tpu_torch.core.ordermap import build_map_spec
    from gorder_tpu_torch.input.config import OrderMapParams

    geom_launches, geom_checks = {}, {}
    for label, count, wire in (
            ("aa-geometry", "p2_geom_launches", "geometry mask bitplane"),
            ("aa-geometry-i16", "p2_i16_geom_launches",
             "wire format: i16")):
        got, results, first = run_golden(
            label, aa_analysis(gro, bnd, xtc,
                               os.path.join(cache, f"smoke_{label}.yaml"),
                               geometry=geometry_params()),
            {count: n_batches}, N_FRAMES, golden="aa-geometry", wire=wire,
            force="i16" if label == "aa-geometry-i16" else "b7")
        geom_launches[label] = got[count]
        if label == "aa-geometry":
            geom_checks["b7"] = check_p2_geom(label, first)["b7"]
            check_p2_geom(label, first,
                          classes=firsts["aa-leaflets"].classes,
                          bond_mol=firsts["aa-leaflets"].step.bond_mol)
            check_p2_geom(label, first, normal=dyn_first.normal,
                          bond_mol=dyn_first.step.bond_mol)
        else:
            geom_checks.update(check_p2_geom(label, first))
            geom_checks.update(check_p2_geom(
                label, first, map_spec=build_map_spec(
                    OrderMapParams(plane="xy"),
                    np.diag(bench.BOX).astype(np.float32))))
        del results, first
    del firsts
    time_normals(gro, bnd, xtc, cache)

    # 12. the AA ordermap runs, on int16 (with the decoder's COG for the
    # global leaflets): goldens, the map's conservation law over the whole
    # run, the map files; then the pair_quantized P2 kernel with its map
    # output against plain on each run's first batch, with the classes the
    # step used, and with aa-dynamic's normals
    from gorder_tpu_torch.input.config import LeafletClassification

    map_launches, map_checks, map_firsts = {}, {}, {}
    for label, golden, wire, kw in (
            ("aa-ordermap", "aa", "wire format: i16", {}),
            ("aa-ordermap-leaflets", "aa-leaflets", "membrane-COG",
             dict(leaflets=LeafletClassification.global_("resname POPC",
                                                         P_HEADS)))):
        conservation = Conservation()
        analysis = aa_analysis(gro, bnd, xtc,
                               os.path.join(cache, f"smoke_{label}.yaml"),
                               map=map_params(cache, label), **kw)
        got, results, map_firsts[label] = run_golden(
            label, analysis, {"p2_i16_map_launches": n_batches}, N_FRAMES,
            golden=golden, wire=wire, watch=conservation, force="i16")
        map_launches[label] = got["p2_i16_map_launches"]
        conservation.check(label)
        check_map_files(label, results, analysis.map.output_directory)
        map_checks[label] = check_p2_map(label, map_firsts[label],
                                         pair_alone=label == "aa-ordermap")
        del results
    leaflet_first = map_firsts["aa-ordermap-leaflets"]
    check_p2_map("aa-ordermap with aa-dynamic", map_firsts["aa-ordermap"],
                 normal=dyn_first.normal,
                 bond_mol=leaflet_first.step.bond_mol)
    check_p2_map("aa-ordermap-leaflets with aa-dynamic", leaflet_first,
                 normal=dyn_first.normal)
    del map_firsts, leaflet_first

    # 28. aa-ordermap forced onto d8: int32 positions through the
    # pair_quantized kernel with its map; the YAML and every map file
    # equal the int16 run's; then that kernel against plain on its first
    # batch, int32 and f32
    label = "aa-ordermap-d8"
    conservation = Conservation()
    analysis = aa_analysis(gro, bnd, xtc,
                           os.path.join(cache, f"smoke_{label}.yaml"),
                           map=map_params(cache, label))
    got, results, first = run_golden(
        label, analysis, {"p2_i32_map_launches": n_batches}, N_FRAMES,
        golden="aa", wire="wire format: d8", watch=conservation,
        force="d8")
    d8_map_launches = got["p2_i32_map_launches"]
    conservation.check(label)
    check_map_files(label, results, analysis.map.output_directory)
    same_lines(label, analysis.output_yaml,
               os.path.join(cache, "smoke_aa-ordermap.yaml"))
    same_tree(label, analysis.map.output_directory,
              map_params(cache, "aa-ordermap").output_directory)
    map_checks[label] = check_p2_map(label, first)
    del results, first

    # 20. the sn-1 chain of the AA membrane (tools/bench_modes.py
    # aa-palmitoyl) through the pygorder drop-in, run() with no argument:
    # its golden, one p2_b7 launch a batch
    import gorder_tpu_torch.compat as gorder

    palmitoyl_launches, _, _ = run_golden(
        "aa-palmitoyl", gorder.Analysis(
            structure=gro, bonds=bnd, trajectory=xtc,
            analysis_type=gorder.analysis_types.AAOrder(*PALMITOYL),
            output_yaml=os.path.join(cache, "smoke_aa-palmitoyl.yaml"),
            n_threads=os.cpu_count() or 1, silent=True, overwrite=True),
        {"p2_launches": n_batches}, N_FRAMES, wire="wire format: b7",
        compat=True, force="b7")

    # 21. aa over the XTC split in two at frame 4,000 (byte copies of the
    # frame records): the YAML of phase 5 but the header
    t0 = time.perf_counter()
    parts = [copy_frames(xtc, os.path.join(cache, "aa_part1.xtc"),
                         range(CONCAT_AT)),
             copy_frames(xtc, os.path.join(cache, "aa_part2.xtc"),
                         range(CONCAT_AT, N_FRAMES))]
    print(f"split: {xtc} into 2 files at frame {CONCAT_AT} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    concat_yaml = os.path.join(cache, "smoke_aa-concat.yaml")
    _, _, concat_launches, _, _ = _run(
        "aa-concat", aa_analysis(gro, bnd, parts, concat_yaml),
        {"p2_launches": n_batches}, N_FRAMES, force="b7")
    same_lines("aa-concat", concat_yaml, os.path.join(cache,
                                                      "smoke_order.yaml"))
    for part in parts:
        os.remove(part)

    # 22. aa over a time window (begin, end, step), and over an XTC of just
    # the frames the window selects (byte copies): equal YAMLs
    from gorder_tpu_torch.io import native

    begin, end, stride = WINDOW
    frames = select_window(native.xtc_scan(xtc)["times"], begin, end, stride)
    window_batches = math.ceil(len(frames) / BATCH)
    window_xtc = copy_frames(xtc, os.path.join(cache, "aa_window.xtc"),
                             frames)
    window_launches = 0
    for label, traj, kw in (
            ("aa-window", xtc, dict(begin=begin, end=end, step=stride)),
            ("aa-window-file", window_xtc, {})):
        _, _, got, _, _ = _run(label, aa_analysis(
            gro, bnd, traj, os.path.join(cache, f"smoke_{label}.yaml"), **kw),
            {"p2_launches": window_batches}, len(frames), force="b7")
        window_launches += got["p2_launches"]
    same_lines("aa-window", os.path.join(cache, "smoke_aa-window.yaml"),
               os.path.join(cache, "smoke_aa-window-file.yaml"))
    print(f"check aa-window: begin {begin} end {end} step {stride} selects "
          f"{len(frames)} frames, {frames[0]}..{frames[-1]}", flush=True)
    os.remove(window_xtc)

    # 8. UA synth
    t0 = time.perf_counter()
    from tools import bench_modes

    ua_frames = bench_modes.UA_FRAMES
    ua_files = synthesize_ua(cache, ua_frames)
    print(f"synth ua: {ua_frames} frames in {time.perf_counter() - t0:.1f} "
          f"s ({os.path.getsize(ua_files[2])} bytes of XTC)", flush=True)

    # 9. the UA runs, end to end; then the UA kernel against plain on the
    # first batch of the ua run
    ua_batches = math.ceil(ua_frames / BATCH)
    ua_sums = TypeSums()
    ua_launches, ua_results, ua_first = run_golden(
        "ua", ua_analysis("ua", *ua_files, os.path.join(cache,
                                                        "smoke_ua.yaml")),
        {"ua_launches": ua_batches * 3}, ua_frames,    # ch3, ch2, ch1u
        watch=ua_sums, wire="wire format: i16", force="i16")
    ua_plain = check_ua("ua_3000", ua_first.step, wire_inputs(ua_first),
                        (ua_first.box, ua_first.normal, ua_first.mask))

    # 27. ua forced onto d8, then s6: int32 XTC integers, the same as the
    # int16 ones, so each YAML equals the ua run's line for line (and so
    # its golden); ua_positions_i32 against plain on the d8 run's first
    # batch, and each decoder on the card against the CPU's
    ua_i32_runs, decode_ms = 0, {}
    for wire in ("d8", "s6"):
        label = f"ua-{wire}"
        path = os.path.join(cache, f"smoke_{label}.yaml")
        _, _, got, wire_line, first = _run(
            label, ua_analysis("ua", *ua_files, path),
            {"ua_i32_launches": ua_batches * 3}, ua_frames, force=wire)
        if f"wire format: {wire}" not in wire_line:
            raise RuntimeError(f"{label}: {wire_line}")
        same_lines(label, path, os.path.join(cache, "smoke_ua.yaml"))
        ua_i32_runs += got["ua_i32_launches"]
        decode_ms[label] = check_decoder(label, first)
        if wire == "d8":
            ua_i32 = check_ua(label, first.step,
                              {"i32": wire_inputs(first)["i32"]},
                              (first.box, first.normal, first.mask))
    del first
    run_golden("ua-palmitoyl",
               ua_analysis("ua-palmitoyl", *ua_files,
                           os.path.join(cache, "smoke_ua-palmitoyl.yaml")),
               {"ua_launches": ua_batches * 2}, ua_frames,   # ch3, ch2
               force="i16")

    # 10. UA with global leaflets (int16 + the decoder's COG): no golden;
    # totals must equal the ua run's, upper and lower must be finite; then
    # the with_leaflets UA kernel against plain on its first batch, with
    # the classes its step used

    a = ua_analysis("ua", *ua_files,
                    os.path.join(cache, "smoke_ua-leaflets.yaml"))
    a.leaflets = LeafletClassification.global_("resname POPC", P_HEADS)
    results, _, ua_leaflet_runs, _, first = _run(
        "ua-leaflets", a, {"ua_leaflets_launches": ua_batches * 3},
        ua_frames, force="i16")
    if _orders(results, "total") != _orders(ua_results, "total"):
        raise RuntimeError("ua-leaflets: total order parameters differ from "
                           "the ua run's")
    sides = _orders(results, "upper") + _orders(results, "lower")
    if not all(math.isfinite(v) for v in sides):
        raise RuntimeError("ua-leaflets: non-finite upper/lower values")
    print(f"check ua-leaflets: totals == the ua run's "
          f"({len(_orders(results, 'total'))} values); upper and lower "
          f"finite; average order upper "
          f"{[m.average_order.upper.value for m in results.molecules]} "
          f"lower {[m.average_order.lower.value for m in results.molecules]}",
          flush=True)
    print(f"kernel ua leaflets ua-leaflets: {first.kind} batch, classes: "
          f"{int((first.classes == 0).sum())} upper, "
          f"{int((first.classes == 1).sum())} lower (molecule-frames)",
          flush=True)
    ua_leaflets = check_ua("ua-leaflets", first.step, wire_inputs(first),
                           (first.box, first.normal, first.mask),
                           first.classes)

    # 18b. UA with spherical clustering leaflets (int16, the classifier
    # with the step): no golden; totals must equal the ua run's
    a = ua_analysis("ua", *ua_files,
                    os.path.join(cache, "smoke_ua-spherical-leaflets.yaml"))
    a.leaflets = LeafletClassification.spherical(P_HEADS)
    results, _, got_spherical, _, _ = _run(
        "ua-spherical-leaflets", a,
        {"ua_leaflets_launches": ua_batches * 3}, ua_frames, force="i16")
    if _orders(results, "total") != _orders(ua_results, "total"):
        raise RuntimeError("ua-spherical-leaflets: total order parameters "
                           "differ from the ua run's")
    print("check ua-spherical-leaflets: totals == the ua run's", flush=True)

    # 11. UA with dynamic normals on the P heads (int16): no golden; the
    # totals must be finite; then the per_bond_normal UA kernel against
    # plain on the run's first batch with the normals its step used, and
    # the z-plane invariant of both kernels on the card
    from gorder_tpu_torch.input.config import MembraneNormal

    a = ua_analysis("ua", *ua_files,
                    os.path.join(cache, "smoke_ua-dynamic.yaml"))
    a.membrane_normal = MembraneNormal.dynamic(P_HEADS)
    results, _, ua_dyn, wire_line, first = _run(
        "ua-dynamic", a, {"ua_normals_launches": ua_batches * 3,
                          "normals_launches": ua_batches}, ua_frames,
        force="i16")
    normals_runs += ua_dyn["normals_launches"]
    totals = _orders(results, "total")
    if "wire format: i16" not in wire_line or not all(
            math.isfinite(v) for v in totals):
        raise RuntimeError(f"ua-dynamic: {wire_line}; totals {totals}")
    print(f"check ua-dynamic: {len(totals)} finite totals; average order "
          f"{[m.average_order.total.value for m in results.molecules]}",
          flush=True)
    ua_normals = check_ua("ua-dynamic", first.step, wire_inputs(first),
                          (first.box, first.normal, first.mask))
    check_z_plane(aa_first, dyn_first, ua_first, first,
                  p2_plain["b7"]["out"], ua_plain["i16"]["out"])

    # 13. UA with the ordermap (int16): its golden, the conservation law,
    # the map files; then the UA kernel's map output against plain on the
    # run's first batch
    conservation = Conservation()
    a = ua_analysis("ua", *ua_files,
                    os.path.join(cache, "smoke_ua-ordermap.yaml"),
                    map=map_params(cache, "ua-ordermap"))
    ua_map_runs, results, first = run_golden(
        "ua-ordermap", a, {"ua_map_launches": ua_batches * 3}, ua_frames,
        golden="ua", wire="wire format: i16", watch=conservation,
        force="i16")
    conservation.check("ua-ordermap")
    check_map_files("ua-ordermap", results, a.map.output_directory)
    ua_map = check_ua("ua-ordermap", first.step, wire_inputs(first),
                      (first.box, first.normal, first.mask))

    # 15. UA with the geometry cylinder, and inverted (int16): no golden;
    # per bond type, the two runs' int64 sums and counts add up to the ua
    # run's exactly; then the UA kernel's geometry test against plain on
    # the first batch, with the reference the step computed
    halves = {}
    ua_geom_runs = 0
    for label, invert in (("ua-geometry", False),
                          ("ua-geometry-invert", True)):
        halves[label] = TypeSums()
        a = ua_analysis("ua", *ua_files,
                        os.path.join(cache, f"smoke_{label}.yaml"),
                        geometry=geometry_params(invert))
        _, _, geo_launches, wire_line, first = _run(
            label, a, {"ua_geom_launches": ua_batches * 3}, ua_frames,
            watch=halves[label], force="i16")
        if "wire format: i16" not in wire_line:
            raise RuntimeError(f"{label}: {wire_line}")
        ua_geom_runs += geo_launches["ua_geom_launches"]
        if label == "ua-geometry":
            ua_geom = check_ua(label, first.step, wire_inputs(first),
                               (first.box, first.normal, first.mask),
                               geom_ref=first.geom_ref)
    inside, outside = (halves[k].value for k in halves)
    if not torch.equal(inside + outside, ua_sums.value):
        raise RuntimeError("ua-geometry + ua-geometry-invert != ua: "
                           f"{(inside + outside - ua_sums.value).abs().max()}"
                           " quanta off")
    print(f"check ua-geometry: per bond type, the int64 sums and counts of "
          f"the cylinder ({int(inside[1].sum())} samples) and of its inverse "
          f"({int(outside[1].sum())}) add up to the ua run's "
          f"({int(ua_sums.value[1].sum())}) exactly", flush=True)

    # 23. synth cg: tools/bench_modes.py synth_cg (512 POPC of 12 beads,
    # 16,800 beads, 10,000 frames, seed 23)
    t0 = time.perf_counter()
    cg_frames = bench_modes.CG_FRAMES
    cg_files = synthesize_cg(cache, cg_frames)
    print(f"synth cg: {cg_frames} frames in {time.perf_counter() - t0:.1f} "
          f"s ({os.path.getsize(cg_files[2])} bytes of XTC)", flush=True)

    # 24. cg as pygorder code runs it (gorder_tpu_torch.compat, run() with
    # no argument): its golden, one p2_b7 launch a batch, and the
    # method-style views' values printed as the YAML's
    import gorder_tpu_torch

    cg_batches = math.ceil(cg_frames / BATCH)
    cg_launches, cg_results, _ = run_golden(
        "cg", cg_analysis(gorder, *cg_files,
                          os.path.join(cache, "smoke_cg.yaml")),
        {"p2_launches": cg_batches}, cg_frames, wire="wire format: b7",
        compat=True, force="b7")
    cg_values = check_cg_views("cg", cg_results,
                               os.path.join(cache, "smoke_cg.yaml"))

    # 25. cg with error estimation and every output file: the same values,
    # finite errors, convergence curves ending at the averages, and TAB,
    # CSV and XVG files holding the YAML's values
    out = os.path.join(cache, "cg-errors")
    os.makedirs(out, exist_ok=True)
    errors = cg_analysis(
        gorder, *cg_files, os.path.join(out, "order.yaml"),
        output_tab=os.path.join(out, "order.tab"),
        output_csv=os.path.join(out, "order.csv"),
        output_xvg=os.path.join(out, "order.xvg"),
        estimate_error=gorder.estimate_error.EstimateError(
            n_blocks=5, output_convergence=os.path.join(out, "conv.xvg")))
    errors_results, _, errors_launches, _, _ = _run(
        "cg-errors", errors, {"p2_launches": cg_batches}, cg_frames,
        compat=True, force="b7")
    errors_values = check_cg_views("cg-errors", errors_results,
                                   errors.output_yaml)
    if ({key: v for key, (v, _) in errors_values.items()}
            != {key: v for key, (v, _) in cg_values.items()}):
        raise RuntimeError("cg-errors: value() differs from the cg run's")
    bad = [key for key, (_, e) in errors_values.items()
           if e is None or not math.isfinite(e)]
    if bad:
        raise RuntimeError(f"cg-errors: no finite error() for {bad}")
    for mol in errors_results.molecules():
        last = mol.convergence().total()[-1]
        average = mol.average_order().total().value()
        if f"{last:.4f}" != f"{average:.4f}":
            raise RuntimeError(f"cg-errors: {mol.molecule()}'s convergence "
                               f"curve ends at {last}, its average is "
                               f"{average}")
        print(f"check cg-errors: {mol.molecule()}: value() == the cg run's "
              f"for all {len(errors_values)} values, errors finite (average "
              f"{average:.6f} ± {mol.average_order().total().error():.6f}), "
              f"the convergence curve of {len(mol.convergence().frames())} "
              f"frames ends at {last:.6f}", flush=True)
    check_cg_files("cg-errors", errors,
                   [mol.molecule() for mol in errors_results.molecules()])
    if not os.path.exists(os.path.join(out, "conv.xvg")):
        raise RuntimeError("cg-errors: no convergence file")

    # 26. the first 1,024 CG frames as read back from the XTC, written as a
    # single-precision TRR, through the f32 wire: within bench
    # .validate_output's tolerance of cg over the same frames of the XTC;
    # then the P2 kernel against plain on its first batch (f32 positions)
    from gorder_tpu_torch.io.traj import Trajectory

    t0 = time.perf_counter()
    source = Trajectory(cg_files[2])
    coords, boxes, times, steps = source.read_frames(
        np.arange(TRR_FRAMES), int(source.files[0].natoms[0]))
    trr = write_trr(os.path.join(cache, f"cg_bench_{TRR_FRAMES}.trr"),
                    coords, boxes, times, steps)
    i12_xtc = os.path.join(cache, f"cg_bench_{TRR_FRAMES}_p100.xtc")
    native.xtc_write(i12_xtc, coords, boxes, times, steps.astype(np.int32),
                     precision=I12_PRECISION)
    del coords
    print(f"trr: the first {TRR_FRAMES} CG frames as read back, written in "
          f"{time.perf_counter() - t0:.1f} s ({os.path.getsize(trr)} bytes)",
          flush=True)
    trr_batches = math.ceil(TRR_FRAMES / BATCH)
    reference = os.path.join(cache, f"cg-xtc_{TRR_FRAMES}.yaml")
    _, _, xtc_launches, wire_line, _ = _run(
        "cg-xtc", cg_analysis(gorder_tpu_torch, *cg_files, reference,
                              end=float(times[-1])),
        {"p2_launches": trr_batches}, TRR_FRAMES, force="b7")
    if "wire format: b7" not in wire_line:
        raise RuntimeError(f"cg-xtc: {wire_line}")
    kinds = set()
    trr_yaml = os.path.join(cache, "smoke_cg-trr.yaml")
    _, _, trr_launches, wire_line, trr_first = _run(
        "cg-trr", cg_analysis(gorder_tpu_torch, *cg_files[:2], trr, trr_yaml),
        {"p2_launches": trr_batches}, TRR_FRAMES,
        watch=lambda db: kinds.add(db.kind))
    if "wire format: f32" not in wire_line or kinds != {"f32"}:
        raise RuntimeError(f"cg-trr: {wire_line}; batch kinds {kinds}")
    golden_dir = bench.GOLDEN_DIR
    bench.GOLDEN_DIR = cache
    try:
        status = bench.validate_output(trr_yaml, "cg-xtc", TRR_FRAMES)
    finally:
        bench.GOLDEN_DIR = golden_dir
    print(f"check cg-trr: every batch rode the f32 wire; {trr_batches} P2 "
          f"launches (p2_positions_f32); against cg over the XTC's same "
          f"frames: {status}", flush=True)
    p2_f32 = check_p2("cg-trr", trr_first, leaflets=False)["f32"]
    del trr_first
    os.remove(trr)

    # 29. cg-i12: the same frames re-encoded at precision 100 (Martini's
    # published compressed-x-precision), forced onto i12 (12-bit packed
    # integers, unpacked to int16 on the card) and onto int16: every batch
    # rides the kind forced, and the two YAMLs are equal line for line
    for wire in ("i16", "i12"):
        kinds = set()
        _run(f"cg-{wire}", cg_analysis(
            gorder_tpu_torch, *cg_files[:2], i12_xtc,
            os.path.join(cache, f"smoke_cg-{wire}.yaml")),
            {"p2_launches": trr_batches}, TRR_FRAMES,
            watch=lambda db: kinds.add(db.kind), force=wire)
        if kinds != {wire}:
            raise RuntimeError(f"cg-{wire}: batch kinds {kinds}")
    same_lines("cg-i12", os.path.join(cache, "smoke_cg-i12.yaml"),
               os.path.join(cache, "smoke_cg-i16.yaml"))
    os.remove(i12_xtc)

    # 32. aa, ua and cg as the wire pick takes them on the card, by the
    # link rate (the runs above force the wires they check)
    pick_launches, pick_numbers = pick_phase(gro, bnd, xtc, ua_files,
                                             cg_files, cache)
    # 33. aa and ua split over two copies of cuda:0 by frames
    mesh_launches = mesh_phase(gro, bnd, xtc, ua_files, cache)
    # 34. the environment knobs
    knob_launches = knob_phase(gro, bnd, xtc, ua_files, cache)

    # 30. synth ves: the CG vesicle in a 36 nm box (`synthesize_vesicle`:
    # 6,650 POPC of 12 beads on shells of 15.0 and 11.0 nm, water to
    # 150,000 beads, 1,000 frames, seed 37)
    t0 = time.perf_counter()
    ves_files = synthesize_vesicle(cache, VESICLE_FRAMES)
    print(f"synth ves: {VESICLE_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({os.path.getsize(ves_files[2])} bytes of XTC)", flush=True)

    # 31. the vesicle: `ves` (CGOrder, static normal) rides b7;
    # `ves-spherical` (spherical leaflets and dynamic normals every frame)
    # rides the pick's s6 or d8 into p2_positions_i32 with classes and
    # normals, its decoder checked against the CPU's and the kernel against
    # plain on its first batch; forced onto the other of the two, the same
    # YAML (or, where s6 cannot carry the box, d8 again); forced onto f32,
    # the wire the port rode before it had s6 and d8, the values move (the
    # gap, printed); traced once with torch.profiler (the same YAML); then
    # its first 64 frames on the card against the CPU
    ves_batches = math.ceil(VESICLE_FRAMES / BATCH)
    _, _, ves_launches, wire_line, _ = _run(
        "ves", vesicle_analysis(ves_files, os.path.join(cache,
                                                        "smoke_ves.yaml")),
        {"p2_launches": ves_batches}, VESICLE_FRAMES)
    if "wire format: b7" not in wire_line:
        raise RuntimeError(f"ves: {wire_line}")
    spherical_yaml = os.path.join(cache, "smoke_ves-spherical.yaml")
    # spherical leaflets and dynamic normals: one P2 launch and one of the
    # normals' kernel a batch
    ves_counters = {"p2_i32_normals_launches": ves_batches,
                    "normals_launches": ves_batches}
    ves_results, _, ves_runs, wire_line, ves_first = _run(
        "ves-spherical", vesicle_analysis(ves_files, spherical_yaml,
                                          spherical=True),
        ves_counters, VESICLE_FRAMES)
    picked = next((w for w in ("s6", "d8")
                   if f"wire format: {w}" in wire_line), None)
    if picked is None:
        raise RuntimeError(f"ves-spherical: {wire_line}")
    values = {cls: _orders(ves_results, cls)
              for cls in ("total", "upper", "lower")}
    if not all(math.isfinite(v) for vs in values.values() for v in vs):
        raise RuntimeError(f"ves-spherical: non-finite values {values}")
    print(f"check ves-spherical: {picked}; {len(values['total'])} finite "
          f"values a class; average order total/upper/lower "
          f"{[values[c][0] for c in ('total', 'upper', 'lower')]}; first "
          f"batch classes {int((ves_first.classes == 0).sum())} upper, "
          f"{int((ves_first.classes == 1).sum())} lower (molecule-frames)",
          flush=True)
    decode_ms["ves-spherical"] = check_decoder("ves-spherical", ves_first)
    p2_i32 = check_p2("ves-spherical", ves_first, True)
    normals_numbers = check_normals("ves-spherical", ves_first)
    del ves_first
    other = {"s6": "d8", "d8": "s6"}[picked]
    other_yaml = os.path.join(cache, f"smoke_ves-spherical-{other}.yaml")
    _, _, other_runs, wire_line, first = _run(
        f"ves-spherical-{other}", vesicle_analysis(ves_files, other_yaml,
                                                   spherical=True),
        ves_counters, VESICLE_FRAMES, force=other)
    same_lines(f"ves-spherical-{other}", other_yaml, spherical_yaml)
    if f"wire format: {other}" in wire_line:
        decode_ms[f"ves-spherical-{other}"] = check_decoder(
            f"ves-spherical-{other}", first)
    else:
        print(f"check ves-spherical-{other}: {other} cannot carry the "
              f"{VESICLE['box']} nm box (s6 keeps each residue's median "
              f"a frame in int16): {wire_line}", flush=True)
    del first
    f32_yaml = os.path.join(cache, "smoke_ves-spherical-f32.yaml")
    f32_results, _, f32_runs, _, _ = _run(
        "ves-spherical-f32", vesicle_analysis(ves_files, f32_yaml,
                                              spherical=True),
        {"p2_f32_normals_launches": ves_batches,
         "normals_launches": ves_batches}, VESICLE_FRAMES, force="f32")
    gap = [abs(a - b) for cls in ("total", "upper", "lower")
           for a, b in zip(_orders(f32_results, cls), values[cls])]
    with open(f32_yaml) as fa, open(spherical_yaml) as fb:
        lines_off = sum(a != b for a, b in zip(fa, fb)
                        if not a.startswith("#"))
    print(f"gap ves-spherical-f32: {sum(g > 0 for g in gap)} of {len(gap)} "
          f"values differ from {picked}'s, by at most {max(gap):.3e}; "
          f"{lines_off} YAML lines differ", flush=True)
    del f32_results
    trace_dir = os.path.join(cache, "ves-spherical_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.environ["GORDER_TPU_PROFILE"] = trace_dir
    try:
        traced_yaml = os.path.join(cache, "smoke_ves-spherical-traced.yaml")
        _, traced_wall, traced_runs, _, _ = _run(
            "ves-spherical-traced", vesicle_analysis(
                ves_files, traced_yaml, spherical=True),
            ves_counters, VESICLE_FRAMES)
    finally:
        del os.environ["GORDER_TPU_PROFILE"]
    same_lines("ves-spherical-traced", traced_yaml, spherical_yaml)
    trace_summary("ves-spherical", trace_dir, traced_wall)
    shutil.rmtree(trace_dir, ignore_errors=True)
    check_chain("ves-chain", ves_files, cache)
    os.remove(ves_files[2])

    # 16. the clustering benchmark's bilayer (tools/bench_modes.py
    # synth_aa_bilayer): 256 POPC, heads 2 nm from the midplane, chains
    # inward, 64,500 atoms, 10,000 frames, seed 31; the AA trajectory is
    # done with, and goes first to bound the disk
    os.remove(xtc)
    t0 = time.perf_counter()
    aab = synthesize_aab(cache, N_FRAMES)
    print(f"synth aab: {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s "
          f"({os.path.getsize(aab[2])} bytes of XTC)", flush=True)

    # 17. spectral clustering over all frames (int16, labels oriented on
    # the host): its golden, then the with_leaflets P2 kernel against plain
    # on its first batch and the classifier's time a batch, both algebras;
    # every 10th frame (b7 with the class plane): totals equal the
    # every-frame run's
    clustering = leaflet_analysis(
        "aa-clustering-leaflets", *aab, cache,
        os.path.join(cache, "smoke_aa-clustering-leaflets.yaml"))
    got, clustered, first = run_golden(
        "aa-clustering-leaflets", clustering,
        {"p2_i16_leaflets_launches": n_batches,
         **spectral_counters(n_batches)}, N_FRAMES,
        wire="wire format: i16", force="i16")
    clustering_launches["aa-clustering-leaflets"] = \
        got["p2_i16_leaflets_launches"]
    spectral_runs = collections.Counter(
        {k: got[k] for k in spectral_counters(0)})
    check_p2("aa-clustering-leaflets", first, True)
    spectral_numbers = check_spectral("aa-clustering-leaflets", clustering,
                                      first)
    time_clustering("aa-clustering-leaflets", clustering, first)
    del first
    # every batch holds frames of the every-10th assignment
    results, _, got_every10, _, _ = _run(
        "aa-clustering-leaflets-every10", leaflet_analysis(
            "aa-clustering-leaflets-every10", *aab, cache,
            os.path.join(cache, "smoke_aa-clustering-every10.yaml")),
        {"p2_leaflets_launches": n_batches, **spectral_counters(n_batches)},
        N_FRAMES, force="b7")
    spectral_runs.update({k: got_every10[k] for k in spectral_counters(0)})
    if _orders(results, "total") != _orders(clustered, "total"):
        raise RuntimeError("aa-clustering-leaflets-every10: totals differ "
                           "from the every-frame run's")
    print("check aa-clustering-leaflets-every10: totals == the every-frame "
          "run's", flush=True)

    # 19b. aa-clustering-leaflets as 2 frame shards: shard 1 orients its
    # clusters against global frame 0's; byte for byte phase 17's YAML
    # (the classifier runs once a batch and once more for shard 1's frame 0)
    shard_batches = 2 * math.ceil(N_FRAMES / 2 / BATCH)
    sharded_clustering = run_sharded(
        "aa-clustering-sharded", leaflet_analysis(
            "aa-clustering-leaflets", *aab, cache,
            os.path.join(cache, "smoke_aa-clustering-sharded.yaml")), 2,
        {"p2_i16_leaflets_launches": shard_batches,
         **spectral_counters(shard_batches + 1)},
        clustering.output_yaml, cache, force="i16")
    spectral_runs.update({k: sharded_clustering[k]
                          for k in spectral_counters(0)})

    p2_src, ua_src = ("gorder_tpu_torch/csrc/p2.cu",
                      "gorder_tpu_torch/csrc/ua.cu")
    p2_tpu, ua_tpu = ("gorder_tpu/ops/pallas_p2.py:163",
                      "gorder_tpu/ops/pallas_ua.py:69")
    neighbors_src = "gorder_tpu_torch/csrc/neighbors.cu"
    kernels = [
        kernel_entry("p2", p2_src, p2_tpu, launches["p2_launches"]
                     + sharded["p2_launches"]
                     + palmitoyl_launches["p2_launches"]
                     + concat_launches["p2_launches"] + window_launches
                     + cg_launches["p2_launches"]
                     + errors_launches["p2_launches"]
                     + xtc_launches["p2_launches"]
                     + ves_launches["p2_launches"], p2_plain["b7"]),
        kernel_entry("p2_f32", p2_src, p2_tpu, trr_launches["p2_launches"],
                     p2_f32),
        kernel_entry("p2_leaflets", p2_src, p2_tpu,
                     sum(n for mode, n in leaflet_launches.items()
                         if mode != "aa-local-leaflets")
                     + got_every10["p2_leaflets_launches"],
                     p2_global["b7"]),
        kernel_entry("p2_i16_leaflets", p2_src, p2_tpu,
                     leaflet_launches["aa-local-leaflets"]
                     + sum(clustering_launches.values())
                     + sharded_clustering["p2_i16_leaflets_launches"],
                     p2_local["i16"]),
        kernel_entry("ua", ua_src, ua_tpu, ua_launches["ua_launches"],
                     ua_plain["i16"]),
        kernel_entry("ua_leaflets", ua_src, ua_tpu,
                     ua_leaflet_runs["ua_leaflets_launches"]
                     + got_spherical["ua_leaflets_launches"],
                     ua_leaflets["i16"]),
        kernel_entry("p2_normals", p2_src, p2_tpu,
                     normal_launches["aa-dynamic"]
                     + normal_launches["aa-dynamic-export"],
                     p2_normals["b7"]),
        kernel_entry("p2_i16_normals", p2_src, p2_tpu,
                     normal_launches["aa-manual-z"], p2_i16_normals["i16"]),
        kernel_entry("ua_normals", ua_src, ua_tpu,
                     ua_dyn["ua_normals_launches"], ua_normals["i16"]),
        kernel_entry("p2_i16_map", p2_src, p2_tpu,
                     map_launches["aa-ordermap"],
                     map_checks["aa-ordermap"]["i16"]),
        kernel_entry("p2_i16_map_leaflets", p2_src, p2_tpu,
                     map_launches["aa-ordermap-leaflets"],
                     map_checks["aa-ordermap-leaflets"]["i16"]),
        kernel_entry("ua_map", ua_src, ua_tpu,
                     ua_map_runs["ua_map_launches"], ua_map["i16"]),
        kernel_entry("p2_geom", p2_src, p2_tpu,
                     geom_launches["aa-geometry"], geom_checks["b7"]),
        kernel_entry("p2_i16_geom", p2_src, p2_tpu,
                     geom_launches["aa-geometry-i16"], geom_checks["i16"]),
        kernel_entry("ua_geom", ua_src, ua_tpu, ua_geom_runs,
                     ua_geom["i16"]),
        # the int32 positions of the s6 and d8 wires: the TPU kernel's
        # quantized path on int32 coords (pallas_p2.py:287-294 single
        # difference, :295-304 pair; pallas_ua.py:202-203)
        kernel_entry("p2_i32_normals_leaflets", p2_src,
                     "gorder_tpu/ops/pallas_p2.py:287",
                     ves_runs["p2_i32_normals_launches"]
                     + other_runs["p2_i32_normals_launches"]
                     + traced_runs["p2_i32_normals_launches"],
                     p2_i32["i32"]),
        kernel_entry("p2_i32_pair_map", p2_src,
                     "gorder_tpu/ops/pallas_p2.py:295", d8_map_launches,
                     map_checks["aa-ordermap-d8"]["i32"]),
        kernel_entry("ua_i32", ua_src, "gorder_tpu/ops/pallas_ua.py:202",
                     ua_i32_runs, ua_i32["i32"]),
        # the dense neighbour passes replace no Pallas kernel: gorder_tpu
        # computes both with XLA ops, in the functions named
        kernel_entry("normals", neighbors_src,
                     "gorder_tpu/core/normals.py:34",
                     normals_runs + sum(
                         got["normals_launches"] for got in (
                             ves_runs, other_runs, f32_runs, traced_runs)),
                     normals_numbers),
        kernel_entry("local_leaflets", neighbors_src,
                     "gorder_tpu/core/leaflets.py:107", local_runs,
                     local_numbers)]
    # nor do the spectral classifier's passes: XLA ops in gorder_tpu's
    # `_spectral_labels`, at the lines named
    for name, count, line in (
            ("spectral_affinity", "affinity_launches", 160),
            ("thin_qr3", "qr_launches", 136),
            ("top2_span", "span_launches", 190),
            ("rayleigh_kmeans", "kmeans_launches", 198)):
        kernels.append(kernel_entry(
            name, "gorder_tpu_torch/csrc/spectral.cu",
            f"gorder_tpu/core/clustering.py:{line}", spectral_runs[count],
            spectral_numbers[name]))
    # the launches of the pick, mesh and knob phases, by kernel entry; the
    # inputs the pick fed that no entry above has get their own
    extra = collections.Counter()
    for got in (pick_launches, mesh_launches, knob_launches):
        extra.update(got)
    for k in kernels:
        k["launches"] += extra.pop(k["name"], 0)
    for inp, numbers in pick_numbers.items():
        name = f"p2_{inp}"
        if name in extra:
            kernels.append(kernel_entry(
                name, p2_src, "gorder_tpu/ops/pallas_p2.py:287"
                if inp == "i32" else p2_tpu, extra.pop(name), numbers))
    if extra:
        raise RuntimeError(f"launches of no kernel entry: {dict(extra)}")
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise RuntimeError(f"kernels never launched on their runs: {idle}")
    print("decode: CUDA-event ms of one batch's reconstruction on the card: "
          + ", ".join(f"{k} {v:.4f}" for k, v in decode_ms.items()),
          flush=True)
    print(f"total: {time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
