"""GRO structure-file reader.

Behavioral reference: groan_rs GRO parser as used by gorder
(src/analysis/structure.rs:27-88). GRO carries no bonds and no
elements; those come from a .bnd file / element guessing respectively.
"""

from __future__ import annotations

import numpy as np

from ..errors import StructureError
from ..system import System


def read_gro(path: str) -> System:
    try:
        with open(path, "r") as fh:
            lines = fh.read().splitlines()
    except OSError as e:
        raise StructureError(f"could not read gro file '{path}': {e}") from None

    if len(lines) < 3:
        raise StructureError(f"gro file '{path}' is too short")

    title = lines[0].strip()
    try:
        n_atoms = int(lines[1].strip())
    except ValueError:
        raise StructureError(
            f"could not parse atom count from gro file '{path}'"
        ) from None

    if len(lines) < 2 + n_atoms + 1:
        raise StructureError(f"gro file '{path}' has fewer lines than expected")

    resids = np.empty(n_atoms, np.int64)
    resnames = np.empty(n_atoms, dtype="U8")
    names = np.empty(n_atoms, dtype="U8")
    serials = np.empty(n_atoms, np.int64)
    positions = np.empty((n_atoms, 3), np.float32)
    velocities = np.zeros((n_atoms, 3), np.float32)
    has_velocities = False

    for i in range(n_atoms):
        line = lines[2 + i]
        try:
            resids[i] = int(line[0:5])
            resnames[i] = line[5:10].strip()
            names[i] = line[10:15].strip()
            serials[i] = int(line[15:20])
            values = line[20:].split()
            positions[i] = [float(v) for v in values[0:3]]
            if len(values) >= 6:
                velocities[i] = [float(v) for v in values[3:6]]
                has_velocities = True
        except (ValueError, IndexError):
            raise StructureError(
                f"could not parse line {2 + i + 1} of gro file '{path}': '{line}'"
            ) from None

    box_values = lines[2 + n_atoms].split()
    box = _parse_gro_box(box_values, path)

    return System(
        name=title,
        atom_names=names,
        resids=resids,
        resnames=resnames,
        serials=serials,
        positions=positions,
        velocities=velocities if has_velocities else None,
        box=box,
    )


def _parse_gro_box(values, path) -> np.ndarray:
    try:
        v = [float(x) for x in values]
    except ValueError:
        raise StructureError(f"could not parse box line of gro file '{path}'") from None
    box = np.zeros((3, 3), np.float32)
    if len(v) >= 3:
        box[0, 0], box[1, 1], box[2, 2] = v[0], v[1], v[2]
    if len(v) == 9:
        # v(1,y) v(1,z) v(2,x) v(2,z) v(3,x) v(3,y)
        box[0, 1], box[0, 2] = v[3], v[4]
        box[1, 0], box[1, 2] = v[5], v[6]
        box[2, 0], box[2, 1] = v[7], v[8]
    elif len(v) not in (0, 3):
        raise StructureError(f"invalid box line in gro file '{path}'")
    return box


def write_gro(path: str, system: System, positions=None, box=None, comment=None) -> None:
    """Write a GRO file (used for tests and synthetic fixtures)."""
    pos = system.positions if positions is None else positions
    b = system.box if box is None else box
    with open(path, "w") as fh:
        fh.write((comment or system.name or "Generated by gorder-tpu") + "\n")
        fh.write(f"{system.n_atoms:>5d}\n")
        for i in range(system.n_atoms):
            fh.write(
                f"{int(system.resids[i]) % 100000:>5d}{system.resnames[i]:<5.5s}"
                f"{system.atom_names[i]:>5.5s}{int(system.serials[i]) % 100000:>5d}"
                f"{pos[i, 0]:8.3f}{pos[i, 1]:8.3f}{pos[i, 2]:8.3f}\n"
            )
        if b is None:
            fh.write("   0.00000   0.00000   0.00000\n")
        else:
            bb = np.asarray(b, dtype=np.float64)
            off_diag = [bb[0, 1], bb[0, 2], bb[1, 0], bb[1, 2], bb[2, 0], bb[2, 1]]
            if any(abs(x) > 0 for x in off_diag):
                fh.write(
                    " ".join(f"{x:10.5f}" for x in [bb[0, 0], bb[1, 1], bb[2, 2]] + off_diag)
                    + "\n"
                )
            else:
                fh.write(f"{bb[0, 0]:10.5f}{bb[1, 1]:10.5f}{bb[2, 2]:10.5f}\n")
