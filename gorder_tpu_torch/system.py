"""Host-side molecular system model.

The equivalent of the reference's `groan_rs::System` (SURVEY.md layer 0), but
array-oriented: every per-atom attribute is a NumPy array so selections,
grouping and topology compilation are vectorized host operations that produce
static index tensors for the TPU kernels.

Coordinates live here only for the *structure* frame; trajectory frames are
streamed separately (io/traj.py) and never attached to the System.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import numpy as np

from .errors import NdxError, SelectionError

# Group-name prefix for internally created groups, mirroring the reference's
# reserved prefix scheme (src/analysis/common.rs:22).
RESERVED_PREFIX = "xxxGorderReservedxxx-"


@dataclass
class System:
    """Static description of the simulated system (one structure file)."""

    name: str
    atom_names: np.ndarray           # (n,) unicode
    resids: np.ndarray               # (n,) int64 — residue numbers as in file
    resnames: np.ndarray             # (n,) unicode
    serials: np.ndarray              # (n,) int64 — 1-based atom numbers
    positions: Optional[np.ndarray] = None   # (n, 3) float32 [nm]
    velocities: Optional[np.ndarray] = None  # (n, 3) float32 [nm/ps]
    box: Optional[np.ndarray] = None         # (3, 3) float32 [nm] (triclinic rows)
    # bonds as a (m, 2) int32 array of 0-based atom-index pairs, a < b, unique
    bonds: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int32))
    # optional per-atom element names ("carbon", ...), "" when unknown
    elements: Optional[np.ndarray] = None
    # optional per-atom masses (TPR provides them)
    masses: Optional[np.ndarray] = None
    # named groups: name -> sorted unique 0-based atom indices
    groups: Dict[str, np.ndarray] = field(default_factory=dict)
    # chain identifiers (PDB); "" when absent
    chains: Optional[np.ndarray] = None
    # unique residue boundaries, computed lazily
    _residue_starts: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ basics
    @property
    def n_atoms(self) -> int:
        return int(self.atom_names.shape[0])

    def copy_groups(self) -> Dict[str, np.ndarray]:
        return dict(self.groups)

    # ------------------------------------------------------------------ groups
    def add_group(self, name: str, indices: np.ndarray, *, overwrite: bool = True) -> None:
        if not overwrite and name in self.groups:
            raise NdxError(f"group '{name}' already exists")
        idx = np.unique(np.asarray(indices, dtype=np.int64))
        if idx.size and (idx[0] < 0 or idx[-1] >= self.n_atoms):
            raise NdxError(
                f"group '{name}' contains atom indices outside the system "
                f"(0..{self.n_atoms - 1})"
            )
        self.groups[name] = idx

    def get_group(self, name: str) -> np.ndarray:
        try:
            return self.groups[name]
        except KeyError:
            raise SelectionError(f"group '{name}' does not exist") from None

    def group_mask(self, name: str) -> np.ndarray:
        mask = np.zeros(self.n_atoms, dtype=bool)
        mask[self.get_group(name)] = True
        return mask

    # ------------------------------------------------------------------ bonds
    def set_bonds_from_pairs(self, pairs: Iterable[tuple]) -> None:
        """Replace all bonds with the given 0-based (i, j) pairs (deduped)."""
        arr = np.asarray(list(pairs), dtype=np.int64).reshape(-1, 2)
        self.bonds = canonical_bonds(arr)

    def has_bonds(self) -> bool:
        return self.bonds.shape[0] > 0

    def adjacency(self) -> List[np.ndarray]:
        """Per-atom arrays of bonded neighbours (0-based)."""
        return adjacency_from_bonds(self.n_atoms, self.bonds)

    # -------------------------------------------------------------- residues
    def residue_starts(self) -> np.ndarray:
        """Indices where a new residue starts (resid or resname changes)."""
        if self._residue_starts is None:
            if self.n_atoms == 0:
                self._residue_starts = np.zeros(0, np.int64)
            else:
                change = np.ones(self.n_atoms, dtype=bool)
                change[1:] = (self.resids[1:] != self.resids[:-1]) | (
                    self.resnames[1:] != self.resnames[:-1]
                )
                self._residue_starts = np.nonzero(change)[0]
        return self._residue_starts


def canonical_bonds(pairs: np.ndarray) -> np.ndarray:
    """Sort each pair, drop self-bonds and duplicates → (m, 2) int32."""
    if pairs.size == 0:
        return np.zeros((0, 2), np.int32)
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])
    keep = lo != hi
    lo, hi = lo[keep], hi[keep]
    combined = lo.astype(np.int64) * (hi.max(initial=0) + 1) + hi
    _, unique_idx = np.unique(combined, return_index=True)
    out = np.stack([lo[unique_idx], hi[unique_idx]], axis=1).astype(np.int32)
    return out


def distinct_strings(data: np.ndarray):
    """(the distinct strings of `data`, each entry's index into them), in
    no set order. Byte strings, and strings below U+0100, of at most 8
    characters are sorted as one 8-byte integer each, which is several
    times faster than `np.unique`'s sort of strings."""
    kind, size = data.dtype.kind, data.dtype.itemsize
    width = size // 4 if kind == "U" else size
    if kind in "SU" and 0 < width <= 8 and len(data):
        codes = np.ascontiguousarray(data).view(
            np.uint32 if kind == "U" else np.uint8).reshape(-1, width)
        if codes.max() < 256:
            packed = np.zeros((len(data), 8), np.uint8)
            packed[:, :width] = codes
            _, first, inverse = np.unique(packed.view(np.uint64).reshape(-1),
                                          return_index=True,
                                          return_inverse=True)
            return data[first], inverse.reshape(-1)
    distinct, inverse = np.unique(data, return_inverse=True)
    return distinct, inverse.reshape(-1)


def adjacency_from_bonds(n_atoms: int, bonds: np.ndarray) -> List[np.ndarray]:
    adj: List[List[int]] = [[] for _ in range(n_atoms)]
    for a, b in bonds:
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    return [np.array(sorted(x), dtype=np.int64) for x in adj]
