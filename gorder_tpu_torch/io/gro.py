"""GRO structure-file reader.

Behavioral reference: groan_rs GRO parser as used by gorder
(src/analysis/structure.rs:27-88). GRO carries no bonds and no
elements; those come from a .bnd file / element guessing respectively.
"""

from __future__ import annotations

import io

import numpy as np

from ..errors import StructureError
from ..system import System, distinct_strings
from ..utils.timers import timers

_POWERS = 10.0 ** np.arange(4, -1, -1)


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

    atoms = _atoms_by_columns(lines[2:2 + n_atoms])
    if atoms is None:
        timers.count("slow_parse_lines", n_atoms)
        atoms = _atoms_by_lines(lines, n_atoms, path)
    else:
        timers.count("slow_parse_lines", 0)
    resids, resnames, names, serials, positions, velocities = atoms

    box_values = lines[2 + n_atoms].split()
    box = _parse_gro_box(box_values, path)

    return System(
        name=title,
        atom_names=names,
        resids=resids,
        resnames=resnames,
        serials=serials,
        positions=positions,
        velocities=velocities,
        box=box,
    )


def _atoms_by_columns(lines):
    """The atom lines as whole columns, or None where they are not the
    regular lines GROMACS writes: all of one length, in ASCII without NUL
    bytes, residue and atom numbers right-aligned integers, and the same
    count of values after column 20 on every line. The values parse as
    `float` does and round to f32 alike; names are stripped once per
    distinct field."""
    n = len(lines)
    if n == 0 or len(set(map(len, lines))) != 1 or len(lines[0]) <= 20:
        return None
    try:
        raw = "".join(lines).encode("ascii")
    except UnicodeEncodeError:
        return None
    if b"\0" in raw:
        return None
    grid = np.frombuffer(raw, np.uint8).reshape(n, -1)
    resids = _right_aligned_ints(grid[:, 0:5])
    serials = _right_aligned_ints(grid[:, 15:20])
    if resids is None or serials is None:
        return None
    tail = np.empty((n, grid.shape[1] - 19), np.uint8)
    tail[:, :-1] = grid[:, 20:]
    tail[:, -1] = ord("\n")
    text = tail.tobytes().decode("ascii")
    if not text.strip():
        return None
    try:
        values = np.loadtxt(io.StringIO(text), dtype=np.float64,
                            comments=None, ndmin=2)
    except ValueError:
        return None
    if values.shape[0] != n or values.shape[1] < 3:
        return None
    velocities = (values[:, 3:6].astype(np.float32)
                  if values.shape[1] >= 6 else None)
    return (resids, _stripped_names(grid[:, 5:10]),
            _stripped_names(grid[:, 10:15]), serials,
            values[:, 0:3].astype(np.float32), velocities)


def _right_aligned_ints(field: np.ndarray):
    """Each row of a 5-byte field as `int` reads it, or None unless every
    row is spaces, an optional minus and digits to the field's end."""
    field = np.ascontiguousarray(field)
    value = field - np.uint8(ord("0"))
    digit = value < 10
    lead = np.logical_and.accumulate(field == ord(" "), axis=1)
    after_lead = np.ones_like(lead)
    after_lead[:, 1:] = lead[:, :-1]
    minus = (field == ord("-")) & after_lead
    if not ((lead | digit | minus).all() and digit[:, -1].all()):
        return None
    # below 10**5, so exact in f64
    magnitude = (np.where(digit, value, 0) @ _POWERS).astype(np.int64)
    return np.where(minus.any(axis=1), -magnitude, magnitude)


def _stripped_names(field: np.ndarray) -> np.ndarray:
    """Each row of a 5-byte field decoded and stripped, as `U8`: each
    distinct field once."""
    distinct, inverse = distinct_strings(
        np.ascontiguousarray(field).view("S5").reshape(-1))
    stripped = [name.decode("ascii").strip() for name in distinct]
    return np.array(stripped, dtype="U8")[inverse]


def _atoms_by_lines(lines, n_atoms: int, path: str):
    """The atom lines one at a time: any GRO the columns refuse, with the
    line of the first fault named."""
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
    return (resids, resnames, names, serials, positions,
            velocities if has_velocities else None)


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
