"""PDB structure-file reader (ATOM/HETATM + CONECT bonds + CRYST1 box).

Behavioral reference: groan_rs PDB parser as used by gorder; PDB is the only
plain-text structure format that can carry bonds (CONECT records) —
SURVEY.md §2.1 "Structure reading".

Coordinates are converted from Å to nm.
"""

from __future__ import annotations

import numpy as np

from ..errors import StructureError
from ..system import System, canonical_bonds


def read_pdb(path: str) -> System:
    try:
        with open(path, "r") as fh:
            lines = fh.read().splitlines()
    except OSError as e:
        raise StructureError(f"could not read pdb file '{path}': {e}") from None

    names, resids, resnames, serials, chains = [], [], [], [], []
    positions = []
    box = None
    conect_pairs = []
    serial_to_index = {}
    title = ""

    for line in lines:
        record = line[0:6]
        if record in ("ATOM  ", "HETATM"):
            try:
                serial = int(line[6:11])
                name = line[12:16].strip()
                resname = line[17:21].strip()  # groan reads 4-char resnames
                chain = line[21:22].strip()
                resid = int(line[22:26])
                x = float(line[30:38]) / 10.0
                y = float(line[38:46]) / 10.0
                z = float(line[46:54]) / 10.0
            except (ValueError, IndexError):
                raise StructureError(
                    f"could not parse pdb atom line in '{path}': '{line}'"
                ) from None
            serial_to_index[serial] = len(names)
            names.append(name)
            resids.append(resid)
            resnames.append(resname)
            serials.append(serial)
            chains.append(chain)
            positions.append((x, y, z))
        elif record == "CRYST1":
            try:
                a = float(line[6:15]) / 10.0
                b = float(line[15:24]) / 10.0
                c = float(line[24:33]) / 10.0
                alpha = float(line[33:40])
                beta = float(line[40:47])
                gamma = float(line[47:54])
            except (ValueError, IndexError):
                raise StructureError(f"could not parse CRYST1 in '{path}'") from None
            box = _cell_to_box(a, b, c, alpha, beta, gamma)
        elif record == "CONECT":
            fields = line[6:].split()
            if len(fields) >= 2:
                try:
                    target = int(fields[0])
                    partners = [int(f) for f in fields[1:]]
                except ValueError:
                    raise StructureError(
                        f"could not parse CONECT line in '{path}': '{line}'"
                    ) from None
                for p in partners:
                    conect_pairs.append((target, p))
        elif record == "TITLE ":
            title = line[6:].strip()

    if not names:
        raise StructureError(f"no atoms found in pdb file '{path}'")

    if conect_pairs and len(serial_to_index) != len(serials):
        # wording: src/errors.rs:334-336 (ConfigError::InvalidPdbTopology)
        from ..errors import ConfigError

        raise ConfigError(
            f"cannot parse topology from the provided PDB file '{path}' - "
            f"non-unique atom numbers make the CONECT information ambiguous "
            f"(see: https://www.wwpdb.org/documentation/"
            f"file-format-content/format33/sect10.html)")

    bond_idx = []
    for s1, s2 in conect_pairs:
        if s1 in serial_to_index and s2 in serial_to_index:
            bond_idx.append((serial_to_index[s1], serial_to_index[s2]))

    system = System(
        name=title or "PDB structure",
        atom_names=np.array(names, dtype="U8"),
        resids=np.array(resids, np.int64),
        resnames=np.array(resnames, dtype="U8"),
        serials=np.array(serials, np.int64),
        positions=np.array(positions, np.float32),
        box=box,
        chains=np.array(chains, dtype="U2"),
    )
    if bond_idx:
        system.bonds = canonical_bonds(np.array(bond_idx, np.int64))
    return system


def _cell_to_box(a, b, c, alpha, beta, gamma) -> np.ndarray:
    """Unit-cell parameters → GROMACS triclinic box matrix (rows) [nm]."""
    alpha, beta, gamma = np.radians([alpha, beta, gamma])
    box = np.zeros((3, 3), np.float32)
    box[0, 0] = a
    box[1, 0] = b * np.cos(gamma)
    box[1, 1] = b * np.sin(gamma)
    box[2, 0] = c * np.cos(beta)
    if np.sin(gamma) != 0:
        box[2, 1] = c * (np.cos(alpha) - np.cos(beta) * np.cos(gamma)) / np.sin(gamma)
    box[2, 2] = np.sqrt(max(c * c - box[2, 0] ** 2 - box[2, 1] ** 2, 0.0))
    # Degenerate all-zero cell (e.g. CRYST1 1 1 1 90 90 90 placeholder) stays as-is.
    return box
