"""Dynamic membrane normals (`!Dynamic`): each analyzed molecule's normal
in each frame from the cloud of `heads` atoms within `radius` nm of its
own head (`benchmark/reference/normals.py`, exact integer clouds)."""

from __future__ import annotations

import torch

from benchmark.reference.normals import dynamic_normals


class DynamicNormals:
    """`heads`: each analyzed molecule's head atom; `cloud_pairs`: the
    (head, cloud atom) pairs within the radius over the frames so far, the
    work `benchmark/rooflines/normal_cloud.py` counts."""

    def __init__(self, spec: dict, view):
        if set(spec) - {"!", "heads", "radius"}:
            raise NotImplementedError(
                f"the reference does not compute the normal {spec}")
        self.heads = view.heads_of(spec["heads"])
        self.cloud = torch.as_tensor(view.select(spec["heads"]),
                                     device=view.device)
        self.radius2 = int(round(spec.get("radius", 2.0)
                                 * view.precision)) ** 2
        self.box = view.box
        self.dtype = view.dtype
        self.cloud_pairs = 0

    def normals(self, ints: torch.Tensor) -> torch.Tensor:
        """(F, A, 3) grid integers → (F, M, 3) unit normals in the dtype."""
        normals, pairs = dynamic_normals(ints.index_select(1, self.heads),
                                         ints.index_select(1, self.cloud),
                                         self.box, self.radius2, self.dtype)
        self.cloud_pairs += pairs
        return normals


build = DynamicNormals
