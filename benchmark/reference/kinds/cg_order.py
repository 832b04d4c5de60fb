"""Coarse-grained order (`!CGOrder`, P2): every bond between two `beads`
(or `atoms`) atoms; the value +S. The results tree gives each molecule
kind's values by bond."""

from __future__ import annotations

from benchmark.reference.bonds import PairBonds


class CGOrder(PairBonds):
    sign = 1.0

    def __init__(self, spec: dict, view):
        beads = set(view.select(spec.get("beads", spec.get("atoms"))))
        super().__init__([(a, b) for a, b in view.bonds
                          if a in beads and b in beads], view)

    def entries(self, name, ids):
        for t in ids:
            _, _, _, la, lb = self.types[t]
            yield (name, "order parameters", f"{la} - {lb}"), [t]


build = CGOrder
