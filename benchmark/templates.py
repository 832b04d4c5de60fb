"""Lipid templates of the benchmark's systems: atom names in file order and
bonds as pairs of indices within the molecule. Frozen copies of the
templates the repository's synthetic systems use (a CHARMM-like all-atom
POPC and a Martini-like POPC), so that the benchmark's inputs do not move
when those change. A configuration names its template under `template`."""

from __future__ import annotations


def popc_aa():
    """CHARMM-like POPC: 10 head atoms (N, C11..C15, P, O11..O13), two
    16-carbon chains; every carbon carries hydrogens (2 a CH2, 3 the
    terminal CH3, 2 each head carbon). 37 C + 76 H + N + P + 3 O = 118
    atoms, 76 C-H bonds."""
    names, bonds = [], []

    def add(name):
        names.append(name)
        return len(names) - 1

    n = add("N")
    c_head = [add(f"C1{i}") for i in range(1, 6)]
    p = add("P")
    o_head = [add(f"O1{i}") for i in range(1, 4)]
    bonds += [(n, c_head[0]), (c_head[0], c_head[1]), (c_head[1], c_head[2]),
              (c_head[2], c_head[3]), (c_head[3], c_head[4]),
              (c_head[2], p), (p, o_head[0]), (p, o_head[1]), (p, o_head[2])]
    for c in c_head:
        for k in ("A", "B"):
            bonds.append((c, add(f"H{names[c][1:]}{k}")))
    for chain, tag in ((1, "2"), (2, "3")):
        prev = c_head[chain + 2]
        for i in range(2, 18):
            c = add(f"C{tag}{i}")
            bonds.append((prev, c))
            prev = c
            for k in ("R", "S", "T")[:3 if i == 17 else 2]:
                bonds.append((c, add(f"H{i}{k}{tag}")))
    return names, bonds


def popc_cg_martini():
    """Martini-like POPC: NC3-PO4-GL1(-GL2)-C1A..C4A / C1B..C4B, 12 beads,
    11 bonds."""
    names = ["NC3", "PO4", "GL1", "GL2",
             "C1A", "C2A", "C3A", "C4A", "C1B", "C2B", "C3B", "C4B"]
    bonds = [(0, 1), (1, 2), (2, 3), (2, 4), (4, 5), (5, 6), (6, 7),
             (3, 8), (8, 9), (9, 10), (10, 11)]
    return names, bonds


TEMPLATES = {"popc-aa": popc_aa, "popc-cg-martini": popc_cg_martini}
