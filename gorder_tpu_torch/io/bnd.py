"""Bonds (.bnd) file reader.

Behavioral reference: src/analysis/structure.rs:121-167 — each line is
`target partner partner ...` with 1-based serial numbers; `#` starts a
comment; duplicate bonds are ignored; self-bonds and out-of-range numbers are
errors. Supplying a bonds file *replaces* all bonds already present in the
system (structure.rs:27-88). Error wording: src/errors.rs:426-441
(BondsError).
"""

from __future__ import annotations

import re

import numpy as np

from ..errors import BondsError
from ..system import System, canonical_bonds
from ..utils.timers import timers


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
            text = fh.read()
    except OSError:
        # wording: src/errors.rs:427-428 (BondsError::FileNotFound)
        raise BondsError(
            f"could not open the bonds file '{path}'") from None

    pairs = _pairs_in_one_pass(text)
    if pairs is None:
        lines = text.splitlines()
        timers.count("slow_parse_lines", len(lines))
        return _parse_lines(lines, n_atoms)
    timers.count("slow_parse_lines", 0)
    return _checked_bonds(pairs, n_atoms)


# line ends `str.splitlines` knows besides "\n" and "\r": a comment
# holding one would end there
_OTHER_LINE_ENDS = "\v\f\x1c\x1d\x1e\x85\u2028\u2029"


def _pairs_in_one_pass(text: str):
    """(m, 2) int64 (target, partner) serials, in the loop's order, or
    None unless the file with its comments cut off is ASCII digits and
    blanks alone and no number has more than 18 digits. A line's first
    number is the target of each number after it; a line of one number
    gives nothing."""
    if "#" in text:
        if any(end in text for end in _OTHER_LINE_ENDS):
            return None
        text = re.sub(r"#[^\r\n]*", "", text)
    try:
        raw = text.encode("ascii")
    except UnicodeEncodeError:
        return None
    if raw.translate(None, b"0123456789 \t\r\n"):
        return None
    data = np.frombuffer(raw, np.uint8)
    digit = np.zeros(len(data) + 2, bool)
    digit[1:-1] = data >= ord("0")
    edges = np.flatnonzero(digit[1:] != digit[:-1])
    starts, ends = edges[0::2], edges[1::2]
    if not len(starts):
        return np.zeros((0, 2), np.int64)
    if (ends - starts).max() > 18:
        return None
    serials = np.fromstring(text, dtype=np.int64, sep=" ")
    if len(serials) != len(starts):
        return None
    breaks = np.flatnonzero((data == ord("\n")) | (data == ord("\r")))
    line = np.searchsorted(breaks, starts)
    first = np.ones(len(starts), bool)
    first[1:] = line[1:] != line[:-1]
    target = np.maximum.accumulate(np.where(first, np.arange(len(first)), 0))
    partner = ~first
    return np.stack([serials[target[partner]], serials[partner]], axis=1)


def _checked_bonds(pairs: np.ndarray, n_atoms: int) -> np.ndarray:
    """The line loop's checks on every line at once; the first line at
    fault raises what the loop raises there."""
    target, partner = pairs[:, 0], pairs[:, 1]
    bad_target = (target < 1) | (target > n_atoms)
    itself = partner == target
    bad_partner = (partner < 1) | (partner > n_atoms)
    fault = bad_target | itself | bad_partner
    if fault.any():
        row = int(np.argmax(fault))
        if bad_target[row]:
            raise _not_found(int(target[row]), n_atoms)
        if itself[row]:
            raise _self_bond(int(target[row]))
        raise _not_found(int(partner[row]), n_atoms)
    return canonical_bonds(pairs - 1)


def _self_bond(serial: int) -> BondsError:
    # wording: src/errors.rs:436-437 (BondsError::SelfBonding)
    return BondsError(
        f"atom with serial number '{serial}' claims to be "
        f"bonded to itself which does not make sense")


def _parse_lines(lines, n_atoms: int) -> np.ndarray:
    """One line at a time: every file the one pass refuses (words, signs,
    other blanks or digits, numbers of more than 18 digits), with the
    first fault's own wording."""
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
                raise _self_bond(target)
            if partner < 1 or partner > n_atoms:
                raise _not_found(partner, n_atoms)
            pairs.append((target - 1, partner - 1))

    if not pairs:
        return np.zeros((0, 2), np.int32)
    return canonical_bonds(np.array(pairs, np.int64))
