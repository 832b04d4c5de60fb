"""The atom selections the benchmark's traffic uses, matched plainly: a
conjunction (`and`) of `resname N1 N2 ...` and `name N1 N2 ...` clauses,
where a name may be a regular expression written r'...' (matched with
`re.search`, as the selection language does). Anything else is refused:
a cell whose selections this cannot read has no reference yet."""

from __future__ import annotations

import re

import numpy as np


def _clause(clause: str):
    words = clause.split()
    if len(words) < 2 or words[0] not in ("resname", "name"):
        raise NotImplementedError(
            f"the reference cannot read the selection clause '{clause}'")
    field, rest = words[0], clause.split(None, 1)[1].strip()
    if rest.startswith("r'") and rest.endswith("'"):
        pattern = re.compile(rest[2:-1])
        return field, lambda value: pattern.search(value) is not None
    values = set(rest.split())
    return field, lambda value: value in values


def select(query: str, names, resnames) -> np.ndarray:
    """Indices (ascending) of the atoms that `query` selects."""
    keep = np.ones(len(names), bool)
    for clause in query.split(" and "):
        field, match = _clause(clause.strip())
        column = resnames if field == "resname" else names
        cache = {v: match(v) for v in set(column)}
        keep &= np.fromiter((cache[v] for v in column), bool, len(column))
    return np.flatnonzero(keep)
