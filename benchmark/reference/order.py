"""Plain order parameters from grid integers, in float64.

The semantics are gorder's: for every analyzed bond and frame, the bond
vector under the minimum image, cos²θ with the membrane normal (a fixed
axis, or the molecule's dynamic normal), the sample S = 1.5·cos²θ − 0.5
rounded half away from zero to 1e-6 (the reference's fixed point), and
the sums of those samples and their counts per bond type, overall and per
leaflet (upper = class 0). A value is sign · Σ / count / 1e6, pooled over
the types of a bond, an atom, a molecule type or the system; sign −1 for
all-atom order (S_CH), +1 for coarse-grained order (P2).

It starts from the integers the benchmark made, never from a file the
program read, and takes nothing from the program. `dtype` float64 is the
reference; a lower one (bfloat16) makes it the control, every step of the
chain after the integers in that precision.
"""

from __future__ import annotations

import numpy as np
import torch

from .normals import dynamic_normals
from .select import select
from .spherical import spherical_classes

SCALE = 1.0e6
CLASSES = ("total", "upper", "lower")


def quantize(s: torch.Tensor) -> torch.Tensor:
    """Samples → int64 fixed point, f64(s)·1e6 rounded half away from 0."""
    x = s.to(torch.float64) * SCALE
    return (torch.sign(x) * torch.floor(torch.abs(x) + 0.5)).to(torch.int64)


def _kind_name(resnames) -> str:
    return "-".join(dict.fromkeys(resnames))


class BondTypes:
    """The analyzed bonds of a topology: per bond instance its two atoms,
    its type and its molecule (an index over the analyzed molecules);
    per type its labels and its molecule kind."""

    def __init__(self, names, resnames, molecule, bonds, analysis: dict):
        kind = analysis["!"]
        if kind == "AAOrder":
            heavy = set(select(analysis["heavy_atoms"], names, resnames))
            hyd = set(select(analysis["hydrogens"], names, resnames))
            pairs = [(a, b) if a in heavy else (b, a) for a, b in bonds
                     if (a in heavy and b in hyd) or (b in heavy and a in hyd)]
            self.sign = -1.0
        elif kind == "CGOrder":
            beads = set(select(analysis.get("beads", analysis.get("atoms")),
                               names, resnames))
            pairs = [(a, b) for a, b in bonds if a in beads and b in beads]
            self.sign = 1.0
        else:
            raise NotImplementedError(
                f"the reference does not compute '{kind}'")
        self.mode = kind
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
        self.atom_a = pairs[:, 0]
        self.atom_b = pairs[:, 1]
        self.bond_type = np.concatenate([
            [type_of[(k, int(a), int(b))] for a, b in inner]
            for k, inner in zip(mol_kind, rel)]).astype(np.int64)
        self.bond_mol = np.repeat(np.arange(len(analyzed)),
                                  stops - starts).astype(np.int64)
        self.n_types = len(self.types)

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

        all_ids = np.arange(self.n_types)
        put(("average order",), all_ids)
        for name, ids in self.kinds:
            put((name, "average order"), np.asarray(ids))
            if self.mode == "CGOrder":
                for t in ids:
                    _, _, _, la, lb = self.types[t]
                    put((name, "order parameters", f"{la} - {lb}"),
                        np.asarray([t]))
            else:
                by_heavy = {}
                for t in ids:
                    by_heavy.setdefault(self.types[t][1], []).append(t)
                for ra in sorted(by_heavy):
                    ts = by_heavy[ra]
                    atom = (name, "order parameters", self.types[ts[0]][3])
                    put(atom, np.asarray(ts))
                    for t in ts:
                        put(atom + ("bonds", self.types[t][4]),
                            np.asarray([t]))
        return out


class OrderReference:
    """The expected results of one analysis, fed its frames' integers
    chunk by chunk (`add`), then read (`values`). `gorder` is the
    analysis as the traffic file states it: gorder's configuration keys,
    a tagged value written {"!": tag, field: value, ...}."""

    def __init__(self, names, resnames, molecule, bonds, box, precision,
                 gorder: dict, device, dtype=torch.float64):
        extra = set(gorder) - {"type", "membrane_normal", "leaflets"}
        if extra:
            raise NotImplementedError(
                f"the reference does not cover {sorted(extra)}")
        self.types = BondTypes(names, resnames, molecule, bonds,
                               gorder["type"])
        self.device = device
        self.dtype = dtype
        self.precision = float(precision)
        self.box_int = torch.tensor(np.asarray(box, np.float64) * precision,
                                    dtype=torch.float64, device=device)
        self.atom_a = torch.as_tensor(self.types.atom_a, device=device)
        self.atom_b = torch.as_tensor(self.types.atom_b, device=device)
        self.bond_type = torch.as_tensor(self.types.bond_type, device=device)
        self.bond_mol = torch.as_tensor(self.types.bond_mol, device=device)
        n_mols = len(self.types.molecules)

        def heads_of(query):
            chosen = select(query, names, resnames)
            by_mol = {int(molecule[i]): i for i in chosen}
            idx = [by_mol.get(int(m), -1) for m in self.types.molecules]
            if min(idx) < 0:
                raise ValueError(f"a molecule has no atom in '{query}'")
            return torch.as_tensor(np.asarray(idx, np.int64), device=device)

        normal = gorder.get("membrane_normal", "z")
        self.static = None
        self.normal_heads = None
        if isinstance(normal, str):
            axis = torch.zeros(3, dtype=torch.float64, device=device)
            axis["xyz".index(normal.lower())] = 1.0
            self.static = axis
        elif normal.get("!") == "Dynamic" and set(normal) <= {
                "!", "heads", "radius"}:
            self.normal_heads = heads_of(normal["heads"])
            cloud = select(normal["heads"], names, resnames)
            self.normal_cloud = torch.as_tensor(cloud, device=device)
            self.radius2_int = int(round(normal.get("radius", 2.0)
                                         * precision)) ** 2
        else:
            raise NotImplementedError(
                f"the reference does not compute the normal {normal}")
        leaflets = gorder.get("leaflets")
        self.leaflet_heads = None
        if leaflets is not None:
            if leaflets.get("!") != "SphericalClustering" or set(
                    leaflets) - {"!", "heads"}:
                raise NotImplementedError(
                    f"the reference does not classify {leaflets}")
            self.leaflet_heads = heads_of(leaflets["heads"])
        self.classes = CLASSES if leaflets is not None else CLASSES[:1]
        shape = (len(self.classes), self.types.n_types)
        self.sums = torch.zeros(shape, dtype=torch.int64, device=device)
        self.counts = torch.zeros(shape, dtype=torch.int64, device=device)
        self.n_molecules = n_mols
        self.frames = 0
        self.cloud_pairs = 0

    def _cos2(self, d, normal):
        """cos²θ of (F, N, 3) vectors with the (3,) or (F, N, 3) normal;
        d² and n² floored at 1e-18 as gorder's chain floors them, so that
        a bond of zero length (two atoms on one grid point) gives 0."""
        proj = (d * normal).sum(-1)
        n2 = torch.clamp((normal * normal).sum(-1), min=1e-18)
        return proj * proj / (torch.clamp((d * d).sum(-1), min=1e-18) * n2)

    def add(self, ints: torch.Tensor) -> None:
        """Fold in the (F, A, 3) int32 grid integers of F frames."""
        f = ints.shape[0]
        d = (ints.index_select(1, self.atom_b).to(torch.int64)
             - ints.index_select(1, self.atom_a).to(torch.int64)).double()
        d = d - self.box_int * torch.round(d / self.box_int)
        d = (d / self.precision).to(self.dtype)
        if self.static is not None:
            normal = self.static.to(self.dtype)
        else:
            heads = ints.index_select(1, self.normal_heads)
            cloud = ints.index_select(1, self.normal_cloud)
            normals, pairs = dynamic_normals(heads, cloud, self.box_int,
                                             self.radius2_int, self.dtype)
            self.cloud_pairs += pairs
            normal = normals.index_select(1, self.bond_mol)
        s = 1.5 * self._cos2(d, normal) - 0.5
        q = quantize(s)                                      # (F, N) int64
        masks = [None]
        if self.leaflet_heads is not None:
            cls = spherical_classes(ints.index_select(1, self.leaflet_heads),
                                    self.box_int, self.precision)
            per_bond = cls.index_select(1, self.bond_mol)
            masks += [per_bond == 0, per_bond == 1]
        ones = torch.ones_like(q)
        for c, mask in enumerate(masks):
            qc, nc = (q, ones) if mask is None else (q * mask, ones * mask)
            self.sums[c].index_add_(0, self.bond_type, qc.sum(0))
            self.counts[c].index_add_(0, self.bond_type, nc.sum(0))
        self.frames += f

    def values(self) -> dict:
        return self.types.values(self.sums.cpu().numpy(),
                                 self.counts.cpu().numpy(), self.classes)
