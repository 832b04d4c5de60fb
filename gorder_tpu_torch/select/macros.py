"""Selection macros (@membrane, @protein, @water, @ion, @dna, @rna).

The reference resolves these through groan_rs's curated residue-name tables
(CHANGELOG.md §1.1.0: "@membrane macro = curated lipid-residue table"). The
tables below are our own curation covering the major force fields (CHARMM36,
Martini 2/3, Slipids, Berger/GROMOS, AMBER Lipid17/21).
"""

from __future__ import annotations

# --- lipids -----------------------------------------------------------------
_GLYCEROPHOSPHOLIPID_HEADS = ["PC", "PE", "PG", "PS", "PA", "PI", "SM"]
_TAIL_CODES = [
    "PO", "DP", "DO", "DM", "DL", "DS", "DA", "DU", "DY", "DB", "DG", "DI",
    "DF", "DR", "DT", "DV", "DX", "PL", "PY", "PE", "PI", "PU", "SO", "SD",
    "SL", "OS", "OP", "LP", "MY", "PP",
]

_EXTRA_LIPIDS = {
    # sterols
    "CHOL", "CHL1", "CHMS", "ERGO", "SITO", "STIG", "CAMP",
    # sphingomyelins / ceramides (CHARMM)
    "PSM", "SSM", "ASM", "BSM", "LSM", "NSM", "OSM", "CER1", "CER2", "CER3",
    "CER160", "CER180", "CER181", "CER241",
    # PIPs
    "POPI", "POP1", "POP2", "POP3", "PIP1", "PIP2", "PIP3", "SAPI",
    "SAPI13", "SAPI14", "SAPI15", "SAPI24", "SAPI25", "SAPI2D",
    # cardiolipins
    "CDL0", "CDL1", "CDL2", "TOCL", "TOCL1", "TOCL2", "TLCL", "TLCL1",
    "TMCL", "TMCL1", "TMCL2", "TYCL", "TYCL1", "TYCL2", "CL4P",
    "CL4M", "CL4O",
    # lyso-lipids & misc (Martini + CHARMM)
    "LPPC", "LOPC", "LPPE", "LOPE", "LPPG", "LPPS", "LPPA",
    "DHPC", "DHPE", "DEPC", "DEPE", "DEPG", "DEPS", "DGPC", "DGPE", "DGPG",
    "DGPS", "DNPC", "DNPE", "DTPC", "DTPE", "DVPC", "DVPE", "DVPG", "DVPS",
    "DXPC", "DXPE", "DBPC", "DBPE", "DBPG", "DBPS", "DFPC", "DFPE",
    "DIPC", "DIPE", "DRPC", "DRPE", "DYPC", "DYPE", "DYPG", "DYPS",
    "DPP", "DOP", "POP",
    # glycolipids
    "DPG1", "DPG3", "DPGS", "DXG1", "DXG3", "DPCE", "DPGG", "DPMG", "DPSG",
    "PNCE", "POCE", "XNCE", "XNG1", "XNG3", "XNSM",
    # PEGylated / special
    "PEO", "DOTAP", "DODAP",
    # GROMOS/Berger common names
    "DPPC", "DMPC", "DOPC", "POPC", "POPE", "POPG", "POPS", "DOPE", "DOPS",
    "DOPG", "DPPE", "DPPG", "DPPS", "DMPE", "DMPG", "DMPS", "DLPC", "DLPE",
    "DLPG", "DLPS", "DSPC", "DSPE", "DSPG", "DSPS", "DAPC", "DAPE", "DUPC",
    "PYPC", "PLPC", "PLPE", "PLPG", "PLPS", "PLPI", "SOPC", "SOPE", "SDPC",
    "SDPE", "SDPS", "SLPC", "SLPE", "OSPC", "OPPC", "PAPC", "PAPE", "PAPS",
    "PAPI", "PEPC", "PGPC", "PIPC", "PUPC", "PUPE", "PUPS", "PRPC",
    "POPX", "PEPE",
}


def _lipid_residues() -> frozenset:
    lipids = set(_EXTRA_LIPIDS)
    for tail in _TAIL_CODES:
        for head in _GLYCEROPHOSPHOLIPID_HEADS:
            lipids.add(tail + head)
    return frozenset(lipids)


MEMBRANE_RESIDUES = _lipid_residues()

WATER_RESIDUES = frozenset({
    "SOL", "WAT", "HOH", "H2O", "W", "WF", "PW", "TIP", "TIP3", "TIP3P",
    "TIP4", "TIP4P", "TIP5", "TIP5P", "T3P", "T4P", "T5P", "SPC", "SPCE",
    "SPC/E", "OPC", "W5",
})

ION_RESIDUES = frozenset({
    "ION", "NA", "CL", "SOD", "CLA", "POT", "K", "CA", "CAL", "MG", "MG2",
    "ZN", "ZN2", "LI", "LIT", "RB", "RUB", "CS", "CES", "BA", "BAR", "BR",
    "F", "I", "IOD", "NA+", "CL-", "K+", "CA2+", "MG2+", "ZN2+", "LI+",
    "CU", "CU2", "FE", "FE2", "FE3", "MN", "NI", "CD", "SR", "YB", "NC3+",
    "TMA", "NH4", "ACE-",  # molecular ions occasionally used as counterions
})

PROTEIN_RESIDUES = frozenset({
    "ALA", "ARG", "ASN", "ASP", "ASPH", "ASH", "CYS", "CYS2", "CYSH", "CYM",
    "CYX", "GLN", "GLU", "GLUH", "GLH", "GLY", "HIS", "HIS1", "HISA", "HISB",
    "HISH", "HID", "HIE", "HIP", "HSD", "HSE", "HSP", "ILE", "LEU", "LYS",
    "LYSH", "LYN", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "ACE", "NME", "NMA", "NAC", "FOR", "HYP", "MSE", "PGLU", "SEC", "PYL",
    "ORN", "DAB", "ABU", "AIB", "NLE", "CME", "CSO", "OCS", "SEP", "TPO",
    "PTR", "KCX", "LLP", "MLY", "M3L",
})

DNA_RESIDUES = frozenset({
    "DA", "DT", "DG", "DC", "DA5", "DT5", "DG5", "DC5", "DA3", "DT3", "DG3",
    "DC3", "DAN", "DTN", "DGN", "DCN",
})

RNA_RESIDUES = frozenset({
    "RA", "RU", "RG", "RC", "RA5", "RU5", "RG5", "RC5", "RA3", "RU3", "RG3",
    "RC3", "A", "U", "G", "C", "URA", "ADE", "GUA", "CYT",
})

MACROS = {
    "membrane": MEMBRANE_RESIDUES,
    "water": WATER_RESIDUES,
    "ion": ION_RESIDUES,
    "protein": PROTEIN_RESIDUES,
    "dna": DNA_RESIDUES,
    "rna": RNA_RESIDUES,
}
