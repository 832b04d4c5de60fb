"""`popc-cg-martini`: a Martini-like POPC, a frozen copy of the template
the repository's synthetic coarse-grained systems use."""


def template():
    """NC3-PO4-GL1(-GL2)-C1A..C4A / C1B..C4B: 12 beads, 11 bonds.
    → (bead names in file order, bonds as index pairs in the molecule)."""
    names = ["NC3", "PO4", "GL1", "GL2",
             "C1A", "C2A", "C3A", "C4A", "C1B", "C2B", "C3B", "C4B"]
    bonds = [(0, 1), (1, 2), (2, 3), (2, 4), (4, 5), (5, 6), (6, 7),
             (3, 8), (8, 9), (9, 10), (10, 11)]
    return names, bonds
