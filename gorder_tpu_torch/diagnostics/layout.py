"""Time the order kernels on one batch with its samples in the topology's
type-major order and permuted molecule-major, on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 -m gorder_tpu_torch.diagnostics.layout [--frames 512]

The AA and UA benchmark membranes of `chip_smoke.py` are synthesized for
`--frames` frames (their first frames are those of the full trajectories)
and run once each through `gorder_tpu_torch.run`; on the first batch of
each run:

- P2 (AA, b7 wire): the kernel (`p2_b7`, which unpacks the wire) with the
  bonds as the topology lays them out (`compile_bonds`: for each bond
  type, that bond of every molecule) and with the same bonds permuted
  molecule-major (every bond of molecule 0, then of molecule 1, ...), the
  wire re-encoded in that order;
- UA (int16): one category, CH2, with its targets in the compiled order
  (for each carbon, that carbon of every molecule) and permuted
  molecule-major (target, helpers and sample types alike).

The int64 sums of both orders must be equal. Prints the CUDA-event
times of both and, last, one JSON line with them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch


def run_rank(keys: np.ndarray) -> np.ndarray:
    """The rank of each entry within its run of equal keys: in a
    type-major layout of one molecule kind, the entry's molecule."""
    starts = np.r_[0, np.flatnonzero(np.diff(keys)) + 1]
    lengths = np.diff(np.r_[starts, len(keys)])
    return np.arange(len(keys)) - np.repeat(starts, lengths)


def molecule_major(keys: np.ndarray) -> np.ndarray:
    """The permutation that orders a type-major layout molecule-major."""
    return np.lexsort((np.arange(len(keys)), run_rank(keys)))


def encode_b7(r: torch.Tensor, cap: int):
    """(B, nv) int16 residuals → the b7 wire (pk (B, stride) uint8, gp
    (B, cap) u16 gaps carried in int16, vl (B, cap) int16): 7-bit codes
    for −64..63, an escape for every other value."""
    from ..io.native import b7_stride

    r = r.to(torch.int64).cpu()
    b, nv = r.shape
    stride = b7_stride(nv // 3)
    esc = (r < -64) | (r > 63)
    codes = torch.where(esc, 0, r) & 127
    groups = torch.zeros((b, stride // 7 * 8), dtype=torch.int64)
    groups[:, :nv] = codes
    words = (groups.reshape(b, -1, 8)
             << (7 * torch.arange(8, dtype=torch.int64))).sum(-1)
    pk = ((words[..., None] >> (8 * torch.arange(7, dtype=torch.int64)))
          & 255).to(torch.uint8).reshape(b, stride)
    gp = torch.zeros((b, cap), dtype=torch.int64)
    vl = torch.zeros((b, cap), dtype=torch.int16)
    for f in range(b):
        pos = esc[f].nonzero().flatten()
        if len(pos) > cap:
            raise ValueError(f"frame {f}: {len(pos)} escapes, cap {cap}")
        gaps = torch.diff(pos, prepend=torch.tensor([-1]))
        if len(gaps) and int(gaps.max()) > 65535:
            raise ValueError("an escape gap above 65535")
        gp[f, :len(pos)] = gaps
        vl[f, :len(pos)] = r[f, pos].to(torch.int16)
    gp = torch.where(gp > 32767, gp - 65536, gp).to(torch.int16)
    return pk, gp, vl


def first_batch(analysis):
    import gorder_tpu_torch

    got = []
    gorder_tpu_torch.run(analysis, device="cuda",
                         on_batch=lambda db: got.append(db)
                         if db.index == 0 else None)
    return got[0]


def p2_orders(db):
    """The P2 kernel on the AA batch, type-major and molecule-major."""
    from ..engine.wire import b7_residuals
    from ..ops import p2

    import chip_smoke

    pk, gp, vl, base = db.wire[:4]
    step = db.step
    nv = base.shape[0]
    bond_type = step.bond_type.cpu().numpy()
    perm = molecule_major(bond_type)
    cols = torch.as_tensor((3 * perm[:, None] + np.arange(3)).ravel(),
                           device=base.device)
    r = b7_residuals(pk, gp, vl, nv)
    wire = {"type-major": (pk, gp, vl, base, step.bond_type),
            "molecule-major": (
                *(t.to(base.device) for t in encode_b7(
                    r.index_select(1, cols), gp.shape[1])),
                base.index_select(0, cols).contiguous(),
                step.bond_type[torch.as_tensor(perm, device=base.device)]
                .contiguous())}
    times, outs = {}, {}
    for name, (pk_, gp_, vl_, base_, bt) in wire.items():
        def call(pk_=pk_, gp_=gp_, vl_=vl_, base_=base_, bt=bt):
            return p2.p2_b7(pk_, gp_, vl_, base_, db.scale, db.box,
                            db.normal, db.mask, bt, step.n_types,
                            handle_pbc=step.handle_pbc)
        outs[name] = call()
        times[name] = chip_smoke.cuda_ms(call)
    return times, outs


def ua_orders(db, category="ch2"):
    """The UA kernel on one category of the UA batch, in the compiled
    order and molecule-major."""
    from ..core.ua import N_HYDROGENS
    from ..ops import ua

    import chip_smoke

    step = db.step
    k = N_HYDROGENS[category]
    offset = 0
    for cat, n in step.layout:
        if cat == category:
            break
        offset += n * N_HYDROGENS[cat]
    n = dict(step.layout)[category]
    bond_type = step.bond_type[offset:offset + n * k]
    ix = step.indices[category]
    perm = molecule_major(bond_type.cpu().numpy()[::k])
    p = torch.as_tensor(perm, device=bond_type.device)
    samples = (k * p[:, None] + torch.arange(k, device=p.device)).flatten()
    orders = {"compiled": ({category: ix}, bond_type.contiguous()),
              "molecule-major": ({category: {key: v[p].contiguous()
                                             for key, v in ix.items()}},
                                 bond_type[samples].contiguous())}
    coords, scale = db.wire[0], db.scale
    times, outs = {}, {}
    for name, (indices, bt) in orders.items():
        def call(indices=indices, bt=bt):
            return ua.ua_positions(coords, scale, db.box, db.normal, db.mask,
                                   indices, bt, step.n_types,
                                   handle_pbc=step.handle_pbc,
                                   layout=((category, n),))
        outs[name] = call()
        times[name] = chip_smoke.cuda_ms(call)
    return times, outs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frames", type=int, default=512)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("layout: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import chip_smoke

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cache = os.path.join(tempfile.gettempdir(), "gorder_tpu_torch_layout")
    os.makedirs(cache, exist_ok=True)
    gro, bnd, _ = chip_smoke.synthesize_structure(cache)
    from ..engine.prepare import load_structure

    system = load_structure(chip_smoke.aa_analysis(
        gro, bnd, os.path.join(cache, "missing.xtc")))
    xtc = chip_smoke.synthesize_trajectory(cache, system, args.frames)
    result = {}
    times, outs = p2_orders(first_batch(chip_smoke.aa_analysis(gro, bnd,
                                                               xtc)))
    if not torch.equal(*outs.values()):
        raise RuntimeError("p2: the two orders give different sums")
    result["p2_b7"] = times
    ua_files = chip_smoke.synthesize_ua(cache, args.frames)
    times, outs = ua_orders(first_batch(chip_smoke.ua_analysis(
        "ua", *ua_files)))
    if not torch.equal(*outs.values()):
        raise RuntimeError("ua: the two orders give different sums")
    result["ua_ch2"] = times
    for name, t in result.items():
        print(f"{name}: ms per call " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + "; int64 sums equal",
            flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
