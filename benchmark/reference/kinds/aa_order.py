"""All-atom order (`!AAOrder`, S_CH): every bond between a `heavy_atoms`
atom and a `hydrogens` atom, its vector from the heavy atom to the
hydrogen; the value −S. The results tree nests each molecule kind's
values by heavy atom, then by its bonds."""

from __future__ import annotations

from benchmark.reference.bonds import PairBonds


class AAOrder(PairBonds):
    sign = -1.0

    def __init__(self, spec: dict, view):
        heavy = set(view.select(spec["heavy_atoms"]))
        hyd = set(view.select(spec["hydrogens"]))
        super().__init__([(a, b) if a in heavy else (b, a)
                          for a, b in view.bonds
                          if (a in heavy and b in hyd)
                          or (b in heavy and a in hyd)], view)

    def entries(self, name, ids):
        by_heavy = {}
        for t in ids:
            by_heavy.setdefault(self.types[t][1], []).append(t)
        for ra in sorted(by_heavy):
            ts = by_heavy[ra]
            atom = (name, "order parameters", self.types[ts[0]][3])
            yield atom, ts
            for t in ts:
                yield atom + ("bonds", self.types[t][4]), [t]


build = AAOrder
