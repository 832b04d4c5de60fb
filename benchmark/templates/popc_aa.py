"""`popc-aa`: CHARMM36m's POPC, RESI POPC of `top_all36_lipid.rtf`
(Klauda et al., J. Phys. Chem. B 114:7830, 2010; the lipid residues of
CHARMM36m), its atoms in the residue's order as CHARMM-GUI and the
GROMACS port of the force field write them: choline and phosphate,
glycerol with its two esters, the sn-2 oleoyl chain C22..C218 with its
cis double bond C29=C210, then the sn-1 palmitoyl chain C32..C316."""

#: the head group, the glycerol and the two esters, in the residue's order
HEAD = ("N C12 C13 C14 C15 H12A H12B H13A H13B H13C H14A H14B H14C "
        "H15A H15B H15C C11 H11A H11B P O13 O14 O11 O12 C1 HA HB "
        "C2 HS O21 C21 O22 C22 H2R H2S "
        "C3 HX HY O31 C31 O32 C32 H2X H2Y").split()
#: the residue's bonds among HEAD, a pair of names each
HEAD_BONDS = (
    "N C12  N C13  N C14  N C15  C12 C11  C11 O12  O12 P  P O13  P O14  "
    "P O11  O11 C1  C1 C2  C2 O21  O21 C21  C21 O22  C21 C22  C2 C3  "
    "C3 O31  O31 C31  C31 O32  C31 C32  "
    "C12 H12A  C12 H12B  C13 H13A  C13 H13B  C13 H13C  C14 H14A  "
    "C14 H14B  C14 H14C  C15 H15A  C15 H15B  C15 H15C  C11 H11A  "
    "C11 H11B  C1 HA  C1 HB  C2 HS  C22 H2R  C22 H2S  C3 HX  C3 HY  "
    "C32 H2X  C32 H2Y").split()


def _chain(tag, last, hydrogens):
    """Carbons C<tag>3 .. C<tag><last> after C<tag>2, each followed by its
    hydrogens (`hydrogens(k)`: their names on carbon k) → (names, bonds
    as pairs of names)."""
    names, bonds, prev = [], [], f"C{tag}2"
    for k in range(3, last + 1):
        c = f"C{tag}{k}"
        names.append(c)
        bonds.append((prev, c))
        for h in hydrogens(k, k == last):
            names.append(h)
            bonds.append((c, h))
        prev = c
    return names, bonds


def _oleoyl(k, last):
    """sn-2: one hydrogen on each carbon of the double bond C29=C210."""
    if k in (9, 10):
        return [f"H{k}1"]
    return [f"H{k}{s}" for s in ("RST" if last else "RS")]


def _palmitoyl(k, last):
    return [f"H{k}{s}" for s in ("XYZ" if last else "XY")]


def template():
    """134 atoms: 42 C, 82 H, N, P, 8 O; 133 bonds, 82 of them C-H.
    → (atom names in file order, bonds as index pairs in the molecule)."""
    sn2, sn2_bonds = _chain("2", 18, _oleoyl)
    sn1, sn1_bonds = _chain("3", 16, _palmitoyl)
    names = HEAD + sn2 + sn1
    index = {name: i for i, name in enumerate(names)}
    pairs = list(zip(HEAD_BONDS[::2], HEAD_BONDS[1::2])) + sn2_bonds \
        + sn1_bonds
    return names, [(index[a], index[b]) for a, b in pairs]
