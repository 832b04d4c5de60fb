"""Wire planning: which wire a run rides and which decoder side channels
feed its leaflet classification and dynamic membrane normals (port of
`gorder_tpu/engine/channels.py`).

The wire is `engine/wire.py pick_wire_format`'s, with the link rate
measured once a run on the run's first device; the xtc wire is weighed
only for a run in no channel class below (no decoder side channel). Bond
slots, and with them b7, are eligible when nothing but the order step
needs absolute positions, or when a decoder side channel gives the other
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

from ..utils.timers import timers
from . import wire as wires

log = logging.getLogger("gorder")


@dataclass
class WirePlan:
    wire: str            # a wire of `engine/wire.py WIRES`
    cap: int             # its capacity: b7 and s6 escapes, d8 corrections
    #                      a frame, or the xtc wire's row stride; else 0
    # what the wire reads and sizes itself by, side channels included
    source: Optional[wires.Source] = None
    # decoder-COG channel class: (classify(coords, cog, box), (membrane
    # slots, axis)) for coordinate wires, and on b7 (b7g) the channel
    # classifier(heads, cog, box) with its head slots
    chan_coords: Optional[tuple] = None
    channel_classify: Optional[Callable] = None
    ch_heads: Optional[np.ndarray] = None
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
    # the kind (`engine/fused.py BY_KIND`) of a batch that rides the wire:
    # b7's channel kind, or the wire with `side`, the decoder side channel
    # a coordinate wire carries: "g" the membrane COG, "G" the bitplane
    kind: str = ""
    side: str = ""


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
              normals=None, map_spec=None, geometry=None,
              handle_pbc: bool = True, n_threads: int, batch_size: int,
              device, group_of=None, n_groups: int = 0) -> WirePlan:
    """Decide the run's channel class and wire, and size the per-frame
    payload. `bond_slots` (atom_a, atom_b) are the order step's bonds in
    the decoded atom space; UA runs pass None and never ride b7, and nor
    do ordermap runs (`map_spec`). `leaflets` and `normals` are the run's
    LeafletRuntime and NormalsRuntime, or None; `geometry` the run's
    geometry selection as (spec, mode, payload) (`engine/prepare.py
    _prepare_geometry`), or None; `group_of` and `n_groups` the s6 wire's
    residue groups (`engine/wire.py wire_groups`); `device` the run's
    (first) device, whose link rate the pick measures."""
    chan_coords = leaf_channels = aux = None
    plane_mode = False
    b7_env = os.environ.get("GORDER_TPU_B7_LEAFLETS", "1") != "0"
    xtc = traj._all_xtc(frame_indices)
    if leaflets is not None and handle_pbc and xtc and b7_env:
        chan_coords = leaflets.channel_coords_info()
    geo_channel = (geometry is not None and bond_slots is not None
                   and leaflets is None and normals is None
                   and map_spec is None and xtc
                   and os.environ.get("GORDER_TPU_GEO_CHANNEL", "1") != "0")
    if map_spec is not None or (geometry is not None and not geo_channel):
        bond_slots = None
    if bond_slots is not None and b7_env:
        if leaflets is not None and normals is None:
            if chan_coords is not None:
                leaf_channels = leaflets.fused_channel()
            plane_mode = leaf_channels is None and leaflets.plane_eligible()
        if (leaflets is not None or normals is not None) \
                and leaf_channels is None and not plane_mode:
            aux = _aux_channel(leaflets, normals, space.n_out)
    b7_ok = bond_slots is not None and (
        (leaflets is None and normals is None) or leaf_channels is not None
        or plane_mode or aux is not None)
    bond_slots = bond_slots if b7_ok else None

    # the xtc wire reads no decoder side channel: a run in a channel class
    # keeps the host wires
    xtc_ok = (xtc and chan_coords is None and not geo_channel
              and leaf_channels is None and not plane_mode and aux is None)

    with timers.phase("pick.link"):
        link_mbps = wires.measure_link_mbps(device)
    wire, cap = wires.pick_wire_format(
        traj, frame_indices, space, n_threads, group_of, n_groups,
        batch_size, bond_slots=bond_slots, link_mbps=link_mbps, xtc=xtc_ok,
        device=device)
    plan = WirePlan(wire, cap, chan_coords=chan_coords,
                    geo_channel=geo_channel, side=(
                        "g" if chan_coords is not None
                        else "G" if geo_channel else ""))
    plan.kind = wire + plan.side if wire != "b7" else (
        "b7geo" if geo_channel else "b7")
    side = {}
    if geo_channel:
        # the decoder's geometry arguments: the reference 0 a point, 1 the
        # box center, 2 a selection's center
        spec, mode, payload = geometry
        side["geo"] = (spec, {"point": 0, "center": 1, "selection": 2}[mode],
                       payload if mode == "point" else None,
                       payload if mode == "selection" else None, handle_pbc)
    extra = (" + decoder membrane-COG channel" if chan_coords is not None
             else " + decoder geometry mask bitplane" if geo_channel
             else "")
    if wire == "b7":
        if leaf_channels is not None:
            plan.channel_classify, (membrane, plan.ch_heads, axis) = \
                leaf_channels
            side.update(aux_slots=plan.ch_heads, cog_slots=membrane,
                        cog_axis=axis)
            plan.kind = "b7g"
            extra = f" + {len(plan.ch_heads)}-head leaflet channel"
        elif plane_mode:
            plan.plane_active, plan.kind = True, "b7m"
            plan.plane_sparse = leaflets.manual_table is None
            if plan.plane_sparse:
                freq = leaflets.frequency
                plan.assign_cap = 1 if freq.kind == "once" \
                    else batch_size // max(freq.n, 1) + 2
            extra = " + host leaflet-class plane"
        elif aux is not None:
            plan.aux_wire_slots, plan.aux_classify, plan.aux_normals = aux
            side["aux_slots"], plan.kind = plan.aux_wire_slots, "b7x"
            extra = f" + {len(plan.aux_wire_slots)}-atom aux channel"
    plan.source = wires.Source(traj, space, n_threads, batch_size, group_of,
                               n_groups, bond_slots, **side)
    what = (f"{plan.source.n_bonds} bond vectors (of {space.n_sel} selected "
            f"atoms)" if wire == "b7" else f"{space.n_sel} atoms"
            + (", the compressed records decoded on the card"
               if wire == "xtc" else ""))
    log.info("wire format: %s — %s%s, %.1f KB/frame", wire, what, extra,
             wires.WIRES[wire].frame_bytes(plan.source, cap) / 1024)
    return plan
