"""Wire planning for the main path (port of the pure bond-order and UA
cases of `gorder_tpu/engine/channels.py:62`): b7 when the trajectory fits
the bond-vector wire, else int16 XTC integers, else f32 positions. UA runs
(`bond_slots=None`) consume positions and never take b7
(gorder_tpu/engine/channels.py:77-79).

Every wire gives the same bond vectors up to the f32 wire's pair
difference (XTC input never takes it), so the choice changes speed, not
results. The link-rate probe and the s6/d8/i12 wires of the JAX package
are not ported.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from .._ref.engine.wire import _probe_b7
from .._ref.io.native import b7_stride

log = logging.getLogger("gorder")


@dataclass
class WirePlan:
    wire: str            # 'b7' | 'i16' | 'f32'
    esc_cap: int         # b7 escape capacity per frame (0 otherwise)
    n_bonds: int
    wire_bytes: int      # bytes per frame on the wire


def plan_wire(*, traj, frame_indices, space, bond_slots=None,
              n_threads: int, batch_size: int) -> WirePlan:
    n_bonds = len(bond_slots[0]) if bond_slots is not None else 0
    esc_cap = None
    if bond_slots is not None:
        esc_cap = _probe_b7(traj, frame_indices, space, bond_slots[0],
                            bond_slots[1], n_threads, batch_size)
    if esc_cap is not None:
        plan = WirePlan("b7", esc_cap, n_bonds,
                        b7_stride(n_bonds) + esc_cap * 4)
        log.info("wire format: b7 — %d bond vectors (of %d selected atoms), "
                 "%.1f KB/frame", n_bonds, space.n_sel,
                 plan.wire_bytes / 1024)
        return plan
    n = len(frame_indices)
    probe = frame_indices[np.unique([0, n // 2, n - 1])]
    if traj.read_frames_quantized(probe, space,
                                  n_threads=n_threads) is not None:
        plan = WirePlan("i16", 0, n_bonds, space.n_out * 6)
    else:
        plan = WirePlan("f32", 0, n_bonds, space.n_out * 12)
    log.info("wire format: %s — %d atoms, %.1f KB/frame", plan.wire,
             space.n_sel, plan.wire_bytes / 1024)
    return plan
