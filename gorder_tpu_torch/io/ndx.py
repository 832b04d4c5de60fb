"""GROMACS NDX index-file reader.

Behavioral reference: src/analysis/index.rs:37-62 — invalid or duplicate group
names are downgraded to warnings (the group is skipped), out-of-range atom
numbers are an error.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from ..errors import NdxError
from ..system import System

log = logging.getLogger("gorder")

# groan_rs forbids these characters in group names
_INVALID_CHARS = set("\"'|&!()")


def read_ndx(path: str, system: System) -> None:
    """Read index groups from `path` and register them on `system`."""
    try:
        with open(path, "r") as fh:
            content = fh.read()
    except OSError as e:
        raise NdxError(f"could not read ndx file '{path}': {e}") from None

    groups = parse_ndx(content, n_atoms=system.n_atoms, path=path)
    for name, indices in groups.items():
        system.add_group(name, indices)


def parse_ndx(content: str, n_atoms: int, path: str = "<ndx>",
              protected: tuple = ()) -> Dict[str, np.ndarray]:
    """`protected` names escalate invalid/duplicate warnings to errors — the
    NDX leaflet classifier fails when its upper/lower group is invalid or
    duplicated while ordinary groups only warn (leaflets.rs:1085-1112)."""
    groups: Dict[str, list] = {}
    skipped: set = set()
    current = None

    for raw in content.splitlines():
        line = raw.split(";")[0]
        stripped = line.strip()
        if not stripped:
            continue
        if stripped.startswith("["):
            if not stripped.endswith("]"):
                raise NdxError(f"invalid group header in ndx file '{path}': '{raw}'")
            name = stripped[1:-1].strip()
            if any(c in _INVALID_CHARS for c in name) or not name:
                if name in protected:
                    # wording: src/errors.rs:454-456
                    # (NdxLeafletClassificationError::InvalidName)
                    raise NdxError(
                        f"group name '{name}' specified in an ndx file "
                        f"'{path}' is invalid and cannot be used (hint: "
                        f"following characters are not allowed in group "
                        f"names: '\"&|!@()<>=)")
                log.warning(
                    "groups with invalid names detected in ndx file '%s' (skipped: '%s')",
                    path, name,
                )
                current = None
                skipped.add(name)
                continue
            if name in groups:
                if name in protected:
                    # wording: src/errors.rs:458-459
                    # (NdxLeafletClassificationError::DuplicateName)
                    raise NdxError(
                        f"group '{name}' is defined multiple times in an "
                        f"ndx file '{path}'")
                log.warning(
                    "duplicate groups detected in ndx file '%s' (skipped duplicate: '%s')",
                    path, name,
                )
                current = None
                skipped.add(name)
                continue
            groups[name] = []
            current = name
        else:
            if current is None:
                if skipped:
                    continue  # content of a skipped group
                raise NdxError(
                    f"atom numbers before any group header in ndx file '{path}'"
                )
            for token in stripped.split():
                try:
                    serial = int(token)
                except ValueError:
                    raise NdxError(
                        f"could not parse atom number '{token}' in ndx file '{path}'"
                    ) from None
                if serial < 1 or serial > n_atoms:
                    raise NdxError(
                        f"atom number {serial} in ndx file '{path}' does not exist "
                        f"in the system ({n_atoms} atoms)"
                    )
                groups[current].append(serial - 1)

    return {k: np.array(v, dtype=np.int64) for k, v in groups.items()}
