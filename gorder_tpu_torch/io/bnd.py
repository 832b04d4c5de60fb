"""Bonds (.bnd) file reader.

Behavioral reference: src/analysis/structure.rs:121-167 — each line is
`target partner partner ...` with 1-based serial numbers; `#` starts a
comment; duplicate bonds are ignored; self-bonds and out-of-range numbers are
errors. Supplying a bonds file *replaces* all bonds already present in the
system (structure.rs:27-88). Error wording: src/errors.rs:426-441
(BondsError).
"""

from __future__ import annotations

import numpy as np

from ..errors import BondsError
from ..system import System, canonical_bonds


def read_bnd(path: str, system: System) -> None:
    system.bonds = parse_bnd(path, system.n_atoms)


def _not_found(serial: int, n_atoms: int, ) -> BondsError:
    # wording: src/errors.rs:439-440 (BondsError::AtomNotFound)
    return BondsError(
        f"atom with serial number '{serial}' does not exist (the system "
        f"only contains '{n_atoms}' atoms)")


def parse_bnd(path: str, n_atoms: int) -> np.ndarray:
    try:
        with open(path, "r") as fh:
            lines = fh.read().splitlines()
    except OSError:
        # wording: src/errors.rs:427-428 (BondsError::FileNotFound)
        raise BondsError(
            f"could not open the bonds file '{path}'") from None

    pairs = []
    for raw in lines:
        line = raw.split("#")[0]
        fields = line.split()
        if len(fields) < 2:
            continue
        try:
            target = int(fields[0])
        except ValueError:
            # wording: src/errors.rs:433-434 (BondsError::CouldNotParse —
            # the reference's message reads "could read", kept verbatim)
            raise BondsError(
                f"could read '{fields[0]}' as an atom serial number"
            ) from None
        if target < 1 or target > n_atoms:
            raise _not_found(target, n_atoms)
        for token in fields[1:]:
            try:
                partner = int(token)
            except ValueError:
                raise BondsError(
                    f"could read '{token}' as an atom serial number"
                ) from None
            if partner == target:
                # wording: src/errors.rs:436-437 (BondsError::SelfBonding)
                raise BondsError(
                    f"atom with serial number '{target}' claims to be "
                    f"bonded to itself which does not make sense")
            if partner < 1 or partner > n_atoms:
                raise _not_found(partner, n_atoms)
            pairs.append((target - 1, partner - 1))

    if not pairs:
        return np.zeros((0, 2), np.int32)
    return canonical_bonds(np.array(pairs, np.int64))
