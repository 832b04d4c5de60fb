"""Spherical-clustering leaflets (`!SphericalClustering`), for vesicles:
each frame's `heads` atoms split by their distance from the heads' centre
(`benchmark/reference/spherical.py`, a 1-D Gaussian mixture), every
frame on its own."""

from __future__ import annotations

import torch

from benchmark.reference.spherical import spherical_classes


class SphericalClustering:
    def __init__(self, spec: dict, view):
        if set(spec) - {"!", "heads"}:
            raise NotImplementedError(
                f"the reference does not classify {spec}")
        self.heads = view.heads_of(spec["heads"])
        self.box = view.box
        self.precision = view.precision

    def classes(self, ints: torch.Tensor) -> torch.Tensor:
        """(F, A, 3) grid integers → (F, M) int64, 0 upper, 1 lower."""
        return spherical_classes(ints.index_select(1, self.heads), self.box,
                                 self.precision)


build = SphericalClustering
