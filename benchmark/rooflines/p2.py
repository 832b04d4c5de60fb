"""The P2 kernel (`gorder_tpu_torch/ops/p2.py` → `csrc/p2.cu`, every
entry point `p2_b7`, `p2_positions_*` launches `p2_kernel`): the least
time the window's order samples need on the card.

Operations: 33 f32 a bond sample (the dequantize or difference 3-6, the
minimum image 12, the projection 5, d² 5, cos² 3, S 2), 7 more with
per-bond normals (n² once a sample 6, one product in the denominator 1),
counted from the kernel's chain. Bytes: each input byte once and each
output byte once. The input is the fewest bytes any of the port's wires
carries for these frames' bond vectors, reckoned from the frames with a
frozen copy of each wire's size arithmetic, whatever wire the run picked:
b7 (7 bits a bond-vector component, 4 bytes an escape: a residual
outside [-64, 63] against the per-component median of the first 64
frames, and the int32 base once), int16 where the integers fit (6 bytes
an atom), f32 (12), and as lower bounds, their escapes and corrections
left out, s6 (its 6-bit stride and a median triple a molecule) and d8
(a byte a component). Besides: each frame's box and scale, the per-molecule
normals (12 bytes) and classes (4) where the step takes them. The output
is an int64 sum and count per bond type and frame, for each class."""

from __future__ import annotations

from benchmark.peaks import bound_s as bound

import torch

KERNELS = ("p2_kernel",)
OPS_PER_SAMPLE = 33
NORMAL_OPS = 7
BASE_FRAMES = 64


def b7_stride(n_bonds: int) -> int:
    return (n_bonds * 3 + 7) // 8 * 7


def s6_stride(n_atoms: int) -> int:
    return (n_atoms * 3 + 3) // 4 * 3


def start(ref, config):
    bonds = ref.bonds
    atoms = torch.unique(torch.cat([bonds.atom_a, bonds.atom_b]))
    return {"atom_a": bonds.atom_a, "atom_b": bonds.atom_b, "atoms": atoms,
            "n_atoms": int(atoms.numel()),
            "n_bonds": int(bonds.atom_a.numel()), "n_types": bonds.n_types,
            "n_classes": len(ref.classes), "n_molecules": ref.n_molecules,
            "normals": ref.normal is not None, "frames": 0, "escapes": 0,
            "base": None, "max_abs": 0}


def add(state, ints):
    d = (ints.index_select(1, state["atom_b"])
         - ints.index_select(1, state["atom_a"])).reshape(ints.shape[0], -1)
    if state["base"] is None:
        state["base"] = d[:BASE_FRAMES].float().median(dim=0).values.to(
            torch.int32)
    r = d - state["base"]
    state["escapes"] += int(((r < -64) | (r > 63)).sum())
    state["max_abs"] = max(state["max_abs"], int(
        ints.index_select(1, state["atoms"]).abs().max()))
    state["frames"] += ints.shape[0]


def finish(state, ref):
    for key in ("atom_a", "atom_b", "atoms", "base"):
        state.pop(key, None)


def bound_s(state, peaks):
    """The least seconds of one analysis's P2 work on a card of `peaks`."""
    f, nb, na = state["frames"], state["n_bonds"], state["n_atoms"]
    wires = [f * b7_stride(nb) + 4 * state["escapes"] + 12 * nb,
             f * 12 * na,
             f * (s6_stride(na) + (state["n_molecules"] + 1) * 6),
             f * 3 * na]
    if state["max_abs"] <= 32767:
        wires.append(f * 6 * na)
    moved = min(wires) + f * 16
    if state["normals"]:
        moved += f * state["n_molecules"] * 12
    if state["n_classes"] > 1:
        moved += f * state["n_molecules"] * 4
    moved += f * state["n_types"] * 16 * state["n_classes"]
    ops = f * nb * (OPS_PER_SAMPLE + NORMAL_OPS * state["normals"])
    return bound(peaks, moved, ops)
