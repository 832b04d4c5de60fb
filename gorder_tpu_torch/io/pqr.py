"""PQR structure-file reader (whitespace-separated ATOM records).

PQR = PDB-like with charge and radius columns, whitespace-delimited
(tests/files/cg.pqr in the reference corpus). Coordinates Å → nm.
"""

from __future__ import annotations

import numpy as np

from ..errors import StructureError
from ..system import System


def read_pqr(path: str) -> System:
    try:
        with open(path, "r") as fh:
            lines = fh.read().splitlines()
    except OSError as e:
        raise StructureError(f"could not read pqr file '{path}': {e}") from None

    names, resids, resnames, serials, chains = [], [], [], [], []
    positions, charges = [], []
    box = None
    title = ""

    for line in lines:
        record = line[0:6].strip()
        if record in ("ATOM", "HETATM"):
            fields = line.split()
            # ATOM serial name resname [chain] resid x y z charge radius
            try:
                if len(fields) >= 11:
                    chain = fields[4]
                    resid_f, rest = fields[5], fields[6:]
                else:
                    chain = ""
                    resid_f, rest = fields[4], fields[5:]
                serial = int(fields[1])
                name = fields[2]
                resname = fields[3]
                resid = int(resid_f)
                x, y, z = (float(v) / 10.0 for v in rest[0:3])
                charge = float(rest[3]) if len(rest) > 3 else 0.0
            except (ValueError, IndexError):
                raise StructureError(
                    f"could not parse pqr atom line in '{path}': '{line}'"
                ) from None
            names.append(name)
            resids.append(resid)
            resnames.append(resname)
            serials.append(serial)
            chains.append(chain)
            positions.append((x, y, z))
            charges.append(charge)
        elif record == "CRYST1":
            from .pdb import _cell_to_box

            f = line.split()
            box = _cell_to_box(
                float(f[1]) / 10.0, float(f[2]) / 10.0, float(f[3]) / 10.0,
                float(f[4]), float(f[5]), float(f[6]),
            )
        elif record == "TITLE":
            title = line[6:].strip()

    if not names:
        raise StructureError(f"no atoms found in pqr file '{path}'")

    return System(
        name=title or "PQR structure",
        atom_names=np.array(names, dtype="U8"),
        resids=np.array(resids, np.int64),
        resnames=np.array(resnames, dtype="U8"),
        serials=np.array(serials, np.int64),
        positions=np.array(positions, np.float32),
        box=box,
        chains=np.array(chains, dtype="U2"),
    )
