"""Wire planning: which wire a run rides and which decoder side channels
feed its leaflet classification and dynamic membrane normals (port of
`gorder_tpu/engine/channels.py`).

The wire is `engine/wire.py pick_wire_format`'s. On the card it weighs
the host-to-device rate, measured once a run on the run's first device,
against the host's decode rate and, for a run in no channel class below
(no decoder side channel) on compressed XTC, the rate of the xtc wire's
host read, which ships the records for the card to decode (the rate
pick); on the CPU, with no rate,
it takes b7 when the run's bond slots are eligible and the trajectory
fits the bond-vector wire, else the smaller of s6 and d8, else i12,
int16, f32 — or the wire `GORDER_TPU_WIRE` forces. s6 and
d8 carry int32 XTC integers, so a trajectory whose integers overflow
int16 (a box over 32.767 nm at precision 1000) still rides exact
integers. Bond slots are eligible when nothing but the order step needs
absolute positions, or when a decoder side channel gives the other
coordinate consumers what they read:

- no leaflets, a static or no normal                     -> b7
- every-frame global leaflets: heads + the decoder's
  membrane center (COG) along the normal                 -> b7g
- manual tables or frequency-gated classification: a host
  (B, M) class plane, with sparse reads of the
  assignment frames' coordinates                         -> b7m
- every-frame individual leaflets and/or dynamic normals:
  the exact integer positions of the atoms they read
  (heads and methyls; the normal-heads cloud), as one
  aux atom union                                         -> b7x
- a geometry selection alone (no leaflets, normals or
  map), on XTC input: the decoder's per-bond inside-shape
  bitplane (native/xdr.cpp xtc_geo_mask)                 -> b7geo

Other runs (local leaflets, manual normals, dynamic normals with global
or local leaflets, ordermaps, geometry with leaflets, normals or a map, UA
runs) ride a coordinate wire: s6, d8, i12, int16 or f32. An ordermap bins
each sample by its bond midpoint, which needs absolute positions, so a
map run never rides a b7 kind (gorder_tpu/engine/channels.py:77, 93-96,
105-109, 120); with every-frame global leaflets it rides the `*g` kinds.
A geometry run outside the geometry channel class computes its inside
mask on the device from positions (:172-183). A run in that class
consumes the decoder's bitplane on every wire: b7geo, or the `*G`
coordinate kinds when b7 is not picked, so its output is the same
whichever wire a batch rides. Manual normals are host tables shipped
beside the wire (`engine/batches.py`). Every-frame global
leaflets with PBC on XTC input classify against the decoder's COG on every
wire (the `*g` coordinate kinds), so the printed output is the same
whichever wire a batch rides.

As in the JAX package, `GORDER_TPU_B7_LEAFLETS=0` turns off every
leaflet and normals channel class (the decoder's COG, the class plane and
the aux atoms): such runs ride a coordinate wire and classify against a
membrane center taken on the device. `GORDER_TPU_GEO_CHANNEL=0` turns off
the geometry channel class: the step computes the inside mask on the
device from positions (gorder_tpu/engine/channels.py:72, :182).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..io.native import b7_stride, geo_stride, i12_stride
from ..utils.timers import timers
from . import wire as wires
from .wire import s6_bytes

log = logging.getLogger("gorder")


@dataclass
class WirePlan:
    wire: str            # 'b7' | 's6' | 'd8' | 'i12' | 'i16' | 'f32' | 'xtc'
    esc_cap: int         # b7 and s6 escape capacity per frame
    n_bonds: int
    wire_bytes: int      # bytes per frame on the wire
    corr_cap: int = 0    # d8 correction capacity per frame
    # decoder-COG channel class: (classify(coords, cog, box), (membrane
    # slots, axis)) for coordinate wires, and on b7 (b7g) the channel
    # classifier(heads, cog, box) with its head slots
    chan_coords: Optional[tuple] = None
    channel_classify: Optional[Callable] = None
    ch_membrane: Optional[np.ndarray] = None
    ch_heads: Optional[np.ndarray] = None
    ch_axis: int = 2
    # host class plane (b7m)
    plane_active: bool = False
    plane_sparse: bool = False
    assign_cap: int = 0
    # aux atom side channel (b7x): the slots, and the classifier and the
    # dynamic normals over them (None where the run has no such consumer)
    aux_wire_slots: Optional[np.ndarray] = None
    aux_classify: Optional[Callable] = None
    aux_normals: Optional[Callable] = None
    # geometry channel class: the decoder's (B, ⌈N/8⌉) bitplane rides
    # every batch (b7geo, or the *G kinds)
    geo_channel: bool = False
    # xtc wire: the bytes of a ring row (the run's largest record)
    xtc_stride: int = 0


def _aux_channel(leaflets, normals, n_out: int):
    """(aux slots, classifier or None, dynamic normals or None over them)
    when every coordinate consumer of the run needs only a small atom set
    at every frame — the individual classifier (heads and methyls) and the
    dynamic normals (the normal-heads cloud) — else None. The slots are the
    union of their atoms, and each consumer is rebuilt over them
    (gorder_tpu/engine/channels.py:119-170)."""
    consumers = []
    if leaflets is not None:
        if (leaflets.fused_classify() is None
                or getattr(leaflets.classify, "aux_atoms", None) is None):
            return None
        consumers.append(leaflets.classify)
    if normals is not None:
        if normals.fused() is None:
            return None
        consumers.append(normals.compute)
    if not consumers:
        return None
    atoms = np.unique(np.concatenate([c.aux_atoms for c in consumers]))
    lut = np.full(n_out, -1, np.int64)
    lut[atoms] = np.arange(len(atoms))

    def pos_of(idx):
        out = lut[np.asarray(idx, np.int64)]
        if (out < 0).any():  # pragma: no cover - internal invariant
            raise AssertionError("internal error: an aux consumer index "
                                 "lies outside the aux atom set")
        return out

    aux_classify = aux_normals = None
    if leaflets is not None:
        aux_classify = leaflets.classify.rebuild(pos_of)
        if leaflets.flip:
            inner = aux_classify

            def aux_classify(coords, box):
                return 1 - inner(coords, box)
    if normals is not None:
        aux_normals = normals.compute.rebuild(pos_of)
    return atoms.astype(np.int32), aux_classify, aux_normals


def plan_wire(*, traj, frame_indices, space, bond_slots=None, leaflets=None,
              normals=None, map_spec=None, geometry: bool = False,
              n_molecules: int = 0, handle_pbc: bool = True, n_threads: int,
              batch_size: int, device, group_of=None,
              n_groups: int = 0) -> WirePlan:
    """Decide the run's channel class and wire, and size the per-frame
    payload. `bond_slots` (atom_a, atom_b) are the order step's bonds in
    the decoded atom space; UA runs pass None and never ride b7, and nor
    do ordermap runs (`map_spec`). `leaflets` and `normals` are the run's
    LeafletRuntime and NormalsRuntime, or None; `geometry` whether the run
    has a geometry selection; `group_of` and `n_groups` the s6 wire's
    residue groups (`engine/wire.py wire_groups`); `device` the run's
    (first) device, whose link rate the pick measures."""
    n_out = space.n_out
    chan_coords = leaf_channels = aux = None
    plane_mode = False
    b7_env = os.environ.get("GORDER_TPU_B7_LEAFLETS", "1") != "0"
    xtc = traj._all_xtc(frame_indices)
    if leaflets is not None and handle_pbc and xtc and b7_env:
        chan_coords = leaflets.channel_coords_info()
    n_bonds = len(bond_slots[0]) if bond_slots is not None else 0
    geo_channel = (geometry and bond_slots is not None and leaflets is None
                   and normals is None and map_spec is None and xtc
                   and os.environ.get("GORDER_TPU_GEO_CHANNEL", "1") != "0")
    if map_spec is not None or (geometry and not geo_channel):
        bond_slots = None
    if bond_slots is not None and b7_env:
        if leaflets is not None and normals is None:
            if chan_coords is not None:
                leaf_channels = leaflets.fused_channel()
            plane_mode = leaf_channels is None and leaflets.plane_eligible()
        if (leaflets is not None or normals is not None) \
                and leaf_channels is None and not plane_mode:
            aux = _aux_channel(leaflets, normals, n_out)
    b7_ok = bond_slots is not None and (
        (leaflets is None and normals is None) or leaf_channels is not None
        or plane_mode or aux is not None)

    # the xtc wire reads no decoder side channel: a run in a channel class
    # keeps the host wires
    xtc_ok = (xtc and chan_coords is None and not geo_channel
              and leaf_channels is None and not plane_mode and aux is None)

    with timers.phase("pick.link"):
        link_mbps = wires.measure_link_mbps(device)
    wire, cap = wires.pick_wire_format(
        traj, frame_indices, space, n_threads, group_of, n_groups,
        batch_size, bond_slots=bond_slots if b7_ok else None,
        link_mbps=link_mbps, xtc=xtc_ok, device=device)
    geo_bytes = geo_stride(n_bonds) if geo_channel else 0
    if wire == "b7":
        plan = WirePlan("b7", cap, n_bonds, geo_bytes,
                        chan_coords=chan_coords, geo_channel=geo_channel)
        extra = " + decoder geometry mask bitplane" if geo_channel else ""
        if leaf_channels is not None:
            plan.channel_classify, (plan.ch_membrane, plan.ch_heads,
                                    plan.ch_axis) = leaf_channels
            plan.wire_bytes += len(plan.ch_heads) * 12 + 4
            extra = f" + {len(plan.ch_heads)}-head leaflet channel"
        elif plane_mode:
            plan.plane_active = True
            plan.plane_sparse = leaflets.manual_table is None
            if plan.plane_sparse:
                freq = leaflets.frequency
                plan.assign_cap = 1 if freq.kind == "once" \
                    else batch_size // max(freq.n, 1) + 2
            plan.wire_bytes += n_molecules * 4 \
                + plan.assign_cap * n_out * 6 // max(batch_size, 1)
            extra = " + host leaflet-class plane"
        elif aux is not None:
            plan.aux_wire_slots, plan.aux_classify, plan.aux_normals = aux
            plan.wire_bytes += len(plan.aux_wire_slots) * 12
            extra = f" + {len(plan.aux_wire_slots)}-atom aux channel"
        plan.wire_bytes += b7_stride(n_bonds) + cap * 4
        log.info("wire format: b7 — %d bond vectors (of %d selected atoms)"
                 "%s, %.1f KB/frame", n_bonds, space.n_sel, extra,
                 plan.wire_bytes / 1024)
        return plan
    if wire == "xtc":
        plan = WirePlan("xtc", 0, n_bonds, cap + 4, xtc_stride=cap)
        log.info("wire format: xtc — %d atoms, the compressed records "
                 "decoded on the card, %.1f KB/frame", space.n_sel,
                 plan.wire_bytes / 1024)
        return plan
    size = {"s6": s6_bytes(n_out, n_groups, cap), "d8": n_out * 3 + cap * 6,
            "i12": i12_stride(n_out), "i16": n_out * 6,
            "f32": n_out * 12}[wire]
    plan = WirePlan(wire, cap if wire == "s6" else 0, n_bonds,
                    size + geo_bytes, corr_cap=cap if wire == "d8" else 0,
                    chan_coords=chan_coords, geo_channel=geo_channel)
    if chan_coords is not None:
        plan.wire_bytes += 4
    extra = (" + decoder membrane-COG channel" if chan_coords is not None
             else " + decoder geometry mask bitplane" if geo_channel
             else "")
    log.info("wire format: %s — %d atoms%s, %.1f KB/frame", plan.wire,
             space.n_sel, extra, plan.wire_bytes / 1024)
    return plan
