"""Bonds that are atom pairs, as AA and CG order take them: the shared
part of `kinds/aa_order.py` and `kinds/cg_order.py`.

Each bond instance has its two atoms, its type and its molecule (an index
over the analyzed molecules). A molecule kind is the analyzed molecules
that have the same atom names, residue names and analyzed bonds; a bond
type is one pair of atoms (relative to the molecule's first) of one
molecule kind. A bond's vector is the minimum-image difference of its two
atoms' grid integers, in nm, in float64."""

from __future__ import annotations

import numpy as np
import torch

from .order import SCALE


def _kind_name(resnames) -> str:
    return "-".join(dict.fromkeys(resnames))


class PairBonds:
    """The analyzed bonds of a topology from their (N, 2) atom pairs (the
    second atom's minus the first's is the bond vector): per bond instance
    `atom_a`, `atom_b`, `bond_type`, `bond_mol` (tensors on the device),
    `molecules` (the analyzed molecules' topology ids), per type its labels
    and its molecule kind. A kind subclasses it with its `sign` and the
    `entries` of its results tree."""

    sign = 1.0

    def __init__(self, pairs, view):
        names, resnames, molecule = view.names, view.resnames, view.molecule
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        mols = np.asarray(molecule)[pairs[:, 0]]
        order = np.argsort(mols, kind="stable")
        pairs, mols = pairs[order], mols[order]
        ids, first = np.unique(np.asarray(molecule), return_index=True)
        end = np.append(first[1:], len(molecule))
        span = {int(m): (int(lo), int(hi)) for m, lo, hi in
                zip(ids, first, end)}
        analyzed, starts = np.unique(mols, return_index=True)
        stops = np.append(starts[1:], len(mols))
        self.molecules = analyzed.astype(np.int64)        # topology ids
        # molecule kinds by their atom names, residue names and bonds
        signature_of, kinds, mol_kind, rel = {}, [], [], []
        for m, s0, s1 in zip(analyzed, starts, stops):
            lo, hi = span[int(m)]
            inner = pairs[s0:s1] - lo
            sig = (tuple(names[lo:hi]), tuple(resnames[lo:hi]),
                   tuple(map(tuple, inner.tolist())))
            if sig not in signature_of:
                signature_of[sig] = len(kinds)
                kinds.append(sig)
            mol_kind.append(signature_of[sig])
            rel.append(inner)
        self.kinds = []          # (name, [type ids])
        type_of = {}
        self.types = []          # (kind, rel_a, rel_b, label a, label b)
        for k, (kn, kr, kb) in enumerate(kinds):
            ids_k = []
            for ra, rb in sorted(set(kb)):
                type_of[(k, ra, rb)] = len(self.types)
                ids_k.append(len(self.types))
                self.types.append((k, ra, rb,
                                   f"{kr[ra]} {kn[ra]} ({ra})",
                                   f"{kr[rb]} {kn[rb]} ({rb})"))
            self.kinds.append((_kind_name(kr), ids_k))
        bond_type = np.concatenate([
            [type_of[(k, int(a), int(b))] for a, b in inner]
            for k, inner in zip(mol_kind, rel)]).astype(np.int64)
        bond_mol = np.repeat(np.arange(len(analyzed)),
                             stops - starts).astype(np.int64)
        self.n_types = len(self.types)
        device = view.device
        self.atom_a = torch.as_tensor(pairs[:, 0], device=device)
        self.atom_b = torch.as_tensor(pairs[:, 1], device=device)
        self.bond_type = torch.as_tensor(bond_type, device=device)
        self.bond_mol = torch.as_tensor(bond_mol, device=device)
        self.box = view.box
        self.precision = view.precision

    def vectors(self, ints: torch.Tensor) -> torch.Tensor:
        """(F, A, 3) int32 grid integers → (F, N, 3) float64 bond vectors
        in nm, each the minimum image."""
        d = (ints.index_select(1, self.atom_b).to(torch.int64)
             - ints.index_select(1, self.atom_a).to(torch.int64)).double()
        d = d - self.box * torch.round(d / self.box)
        return d / self.precision

    def entries(self, name: str, ids: list):
        """(key path, type ids) of each value of molecule kind `name` (of
        types `ids`) below its average."""
        raise NotImplementedError

    def values(self, sums: np.ndarray, counts: np.ndarray, classes):
        """{key path: value} of the results tree, keyed as the YAML output
        nests it, from (C, T) int64 sums and counts."""
        out = {}

        def put(path, type_ids):
            for c, cls in enumerate(classes):
                n = counts[c, type_ids].sum()
                out[path + (cls,)] = (self.sign * float(
                    sums[c, type_ids].sum() / SCALE / n) if n > 0
                    else float("nan"))

        put(("average order",), np.arange(self.n_types))
        for name, ids in self.kinds:
            put((name, "average order"), np.asarray(ids))
            for path, type_ids in self.entries(name, ids):
                put(path, np.asarray(type_ids))
        return out
