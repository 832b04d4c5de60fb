"""The run-scoped frame mesh (port of `gorder_tpu/parallel/context.py`).

When several devices are visible, a run splits every batch over them by
frames (`parallel/mesh.py`): `GORDER_TPU_MESH=0` disables that, `=N`
caps the device count, and the count is clipped down to a divisor of the
batch size, so that every device gets as many frames. The mesh is a
module global set for one run: `activate` and `deactivate` bracket it in
`engine/drivers.py`, and the pipeline is driven by one host thread.

`visible_devices` is what the mesh may span: every CUDA device for a
plain `cuda`, the device alone for `cuda:k` or the CPU. Tests replace it
to build a mesh of one device repeated, as the JAX package's tests ask
XLA for 8 host devices.
"""

from __future__ import annotations

import os

import torch

from .mesh import FrameMesh, frame_mesh

_ACTIVE = None


def visible_devices(device) -> list:
    """The devices a run on `device` may split its batches over."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def activate(batch_size: int, device) -> FrameMesh | None:
    """Build and activate the frame mesh of a run on `device` with batches
    of `batch_size` frames (None: a single device)."""
    global _ACTIVE
    _ACTIVE = None
    env = os.environ.get("GORDER_TPU_MESH", "")
    if env == "0":
        return None
    devices = visible_devices(device)
    n = len(devices)
    if env.isdigit() and int(env) > 0:
        n = min(n, int(env))
    while n > 1 and batch_size % n:
        n -= 1
    if n <= 1:
        return None
    _ACTIVE = frame_mesh(devices[:n])
    return _ACTIVE


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_mesh() -> FrameMesh | None:
    return _ACTIVE
