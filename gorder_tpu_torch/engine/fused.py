"""Per-batch programs, one per wire kind (port of
`gorder_tpu/engine/fused.py` `_build_fused_steps`): decode the shipped
payload on the device, classify leaflets and compute dynamic membrane
normals where the batch carries what they read, and run the order step.
PyTorch runs eagerly, so these are plain functions; the JAX package
traces each into one XLA program.

Each takes (step, wire tensors, inv_scale, box_diag, normal, frame_mask,
consumers, classes, geom_ref) and returns a `Used`: the step's int64
output, the (B, M) classes and the normal it used, and the dynamic
normals' guard. `classes` are host classes shipped with the batch (manual
tables, frequency-gated methods); without them a leaflet run classifies
here with the run's `Consumers`. `normal` is the static (3,) normal or a
manual (B, M, 3) table; a dynamic-normal run replaces it here with the
(B, M, 3) normals computed from the batch. `geom_ref` is a geometry run's
reference for the batch ((B, 3), or a selection's atom indices), from
which the step computes the inside mask on the coordinate kinds that carry
no decoder bitplane (gorder_tpu/core/order.py:480-515).

Kinds: `b7` (no leaflets), `b7g` (heads + decoder COG), `b7x` (aux atoms),
`b7m` (host class plane), `b7geo` (the decoder's geometry bitplane), and
the coordinate wires `s6`, `d8`, `i12`, `i16` and `f32`, each also with a
trailing decoder COG (`s6g` ... `f32g`) or a trailing geometry bitplane
(`s6G` ... `f32G`), and `xtc` (the compressed records, with no side
channel). A coordinate wire is reconstructed on the device by its entry
(`engine/wire.py WIRES`: s6, d8 and xtc into int32 XTC integers, i12 into
int16) and its integers go to the step as they are
(gorder_tpu/engine/fused.py: 236-280).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.timers import timers
from .wire import WIRES


@dataclass
class Consumers:
    """The coordinate consumers a run's wire kinds call besides the step:
    leaflet classifiers, flip applied, and the dynamic membrane normals;
    None where the run has no such kind. `map_state` is an ordermap run's
    (C, 2, T·n0·n1 + 1) int64 state, which the coordinate wires' step adds
    every batch's samples to (map runs never ride b7)."""

    coords: Optional[Callable] = None          # (coords f32, box)
    channel_coords: Optional[Callable] = None  # (coords f32, cog, box)
    channel: Optional[Callable] = None         # b7g: (heads f32, cog, box)
    aux: Optional[Callable] = None             # b7x: (aux f32, box)
    normals: Optional[Callable] = None         # (coords f32, box)
    aux_normals: Optional[Callable] = None     # b7x: (aux f32, box)
    map_state: Optional[torch.Tensor] = None
    n_atoms: int = 0                           # the wire's atoms (i12)


class Used(NamedTuple):
    """What a batch's program gives back."""

    out: torch.Tensor                # the step's int64 output
    classes: Optional[torch.Tensor]  # the (B, M) int32 classes it used
    normal: torch.Tensor             # the (3,) or (B, M, 3) normal it used
    guard: Optional[torch.Tensor]    # dynamic normals: min cloud count


def _normals(fn, cf, box, normal, mask):
    """The dynamic normals of the batch and their guard — the least cloud
    count over the valid frames, a device scalar checked when the batch
    drains (the ≥3-points check; gorder_tpu/engine/fused.py:101-106) —
    or the given normal and None without dynamic normals."""
    if fn is None:
        return normal, None
    with timers.phase("normals"):
        normal, counts = fn(cf, box)
    guard = torch.where(mask[:, None], counts,
                        torch.full_like(counts, 1e9)).amin()
    return normal, guard


def _classify(fn, *args) -> torch.Tensor:
    """A leaflet classifier's (B, M) classes, timed as `classify`."""
    with timers.phase("classify"):
        return fn(*args)


def _b7(step, w, scale, box, normal, mask, classes, guard=None, geo=None):
    return Used(step.b7(*w[:4], scale, box, normal, mask, classes=classes,
                        geo=geo), classes, normal, guard)


def run_b7(step, w, scale, box, normal, mask, cs, classes=None,
           geom_ref=None):
    """b7 wire: the packed codes, escapes and per-slot base go straight
    into the kernel, which unpacks them, adds the base and dequantizes
    (the TPU kernel's resid input). A b7m batch comes here too, with its
    host class plane as `classes`."""
    return _b7(step, w, scale, box, normal, mask, classes)


def run_b7geo(step, w, scale, box, normal, mask, cs, classes=None,
              geom_ref=None):
    """b7 + the decoder's (B, ⌈N/8⌉) geometry bitplane: the kernel takes
    the packed wire and the bitplane (the TPU kernel's `diff_input` and
    `with_geom` variants)."""
    return _b7(step, w, scale, box, normal, mask, classes, geo=w[4])


def run_b7g(step, w, scale, box, normal, mask, cs, classes=None,
            geom_ref=None):
    """b7 + heads and the decoder's membrane COG: the heads dequantize as
    the coordinate wires do, f32(int)·s, a bit-identical gather."""
    heads = w[4].to(scale.dtype) * scale[:, None, None]
    classes = _classify(cs.channel, heads, w[5], box)
    return _b7(step, w, scale, box, normal, mask, classes)


def run_b7x(step, w, scale, box, normal, mask, cs, classes=None,
            geom_ref=None):
    """b7 + the exact integer positions of the atoms the other consumers
    read (individual leaflets: heads and methyls; dynamic normals: the
    normal-heads cloud)."""
    aux = w[4].to(scale.dtype) * scale[:, None, None]
    if cs.aux is not None:
        classes = _classify(cs.aux, aux, box)
    normal, guard = _normals(cs.aux_normals, aux, box, normal, mask)
    return _b7(step, w, scale, box, normal, mask, classes, guard)


def _positions(step, coords, inv_scale, box, normal, mask, cs, classes,
               cog=None, geo=None, geom_ref=None):
    """Coordinate wires: integer positions stay integer for the step (the
    single-rounding bond difference, or the pair difference of an ordermap
    run, whose samples the step adds to the run's map state); the
    classifier and the dynamic normals read f32(q)·s. A geometry run's
    step takes the decoder's bitplane `geo` (the `*G` kinds), or computes
    the mask from the positions and `geom_ref`."""
    classify = classes is None and (cs.coords is not None or cog is not None)
    cf = coords
    if (classify or cs.normals is not None) and inv_scale is not None:
        cf = coords.to(inv_scale.dtype) * inv_scale[:, None, None]
    if classify:
        classes = (_classify(cs.channel_coords, cf, cog, box)
                   if cog is not None else _classify(cs.coords, cf, box))
    normal, guard = _normals(cs.normals, cf, box, normal, mask)
    geometry = (dict(geo=geo) if geo is not None
                else dict(geom_ref=geom_ref) if geom_ref is not None else {})
    return Used(step.positions(coords, box, normal, mask,
                               inv_scale=inv_scale, classes=classes,
                               map_state=cs.map_state, **geometry),
                classes, normal, guard)


def decode_positions(kind: str, w, n_atoms: int) -> torch.Tensor:
    """The (B, A, 3) positions a coordinate-wire batch of `kind` carries,
    reconstructed on its device: int32 (s6, d8, xtc) or int16 (i12, i16)
    XTC integers, or f32 positions. `n_atoms` (A) is read by i12 and xtc
    only."""
    return (WIRES.get(kind[:3]) or WIRES[kind[:2]]).positions(w, n_atoms)


def _coordinate_kind(wire, side: str):
    """The program of coordinate wire `wire`'s kind with `side`: ""
    (positions alone), "g" (a trailing decoder COG) or "G" (a trailing
    geometry bitplane)."""

    def run(step, w, scale, box, normal, mask, cs, classes=None,
            geom_ref=None):
        return _positions(step, wire.positions(w, cs.n_atoms), scale, box,
                          normal, mask, cs, classes,
                          cog=w[-1] if side == "g" else None,
                          geo=w[-1] if side == "G" else None,
                          geom_ref=geom_ref)
    return run


BY_KIND = {"b7": run_b7, "b7g": run_b7g, "b7x": run_b7x, "b7m": run_b7,
           "b7geo": run_b7geo}
BY_KIND.update({w.name + side: _coordinate_kind(w, side)
                for w in WIRES.values() if w.name != "b7"
                for side in (("", "g", "G") if w.sided else ("",))})
