"""Data parallelism over trajectory frames within one process (port of
`gorder_tpu/parallel/mesh.py`).

Every step of the pipeline is a per-frame map followed by a per-frame
reduction, so a batch split along its frame axis needs no communication:
each device runs the step on its own contiguous slice of frames, and the
exact int64 per-frame sums come back to the host, where their order does
not matter. A `FrameMesh` is the ordered list of devices of that split
(the JAX package's 1-D 'frames' mesh); slice i of a batch lies on
`devices[i]`. Constant tensors (index arrays, a static normal) have one
replica on each device: `replicate` places them, and `Replicas` keeps a
constant that is created before the devices that read it are known.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class FrameMesh:
    """The devices a batch's frames are split over, in frame order."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def frame_mesh(devices: Optional[Sequence] = None) -> FrameMesh:
    """A mesh over the given devices, or over every visible CUDA device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return FrameMesh(tuple(torch.device(d) for d in devices))


def to_device(a, device) -> torch.Tensor:
    """A copy of `a` (an array or a tensor) on `device` that no longer
    reads `a`: the decoder reuses its host buffers."""
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    return t.to(device, copy=True)


def shard_batch(mesh: FrameMesh, *tensors):
    """Split each array or tensor along dim 0 into `mesh.size` equal
    contiguous frame slices, slice i copied to `mesh.devices[i]` → one
    list of slices per input (the list alone for one input)."""
    out = []
    for a in tensors:
        rows = a.shape[0] // mesh.size
        if rows * mesh.size != a.shape[0]:
            raise ValueError(f"{a.shape[0]} frames do not split evenly over "
                             f"{mesh.size} devices")
        out.append([to_device(a[i * rows:(i + 1) * rows], device)
                    for i, device in enumerate(mesh.devices)])
    return tuple(out) if len(out) > 1 else out[0]


def replicate(mesh: FrameMesh, *tensors):
    """A copy of each array or tensor on every device of the mesh → one
    list of copies per input (the list alone for one input)."""
    out = [[to_device(a, device) for device in mesh.devices]
           for a in tensors]
    return tuple(out) if len(out) > 1 else out[0]


def gather(parts) -> torch.Tensor:
    """The slices of `shard_batch` (or the per-shard results of a step)
    joined in frame order on the first slice's device."""
    if len(parts) == 1:
        return parts[0]
    device = parts[0].device
    return torch.cat([p.to(device) for p in parts])


class Replicas:
    """A constant tensor with one replica per device that reads it: `on`
    gives the tensor itself on the device it was made on, and elsewhere a
    copy made at its first use there and kept for the run."""

    def __init__(self, tensor: torch.Tensor):
        self._on = {tensor.device: tensor}
        self._first = tensor

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = self._first.to(device)
        return t

    def __len__(self) -> int:
        return len(self._first)
