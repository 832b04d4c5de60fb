"""Per-batch programs, one per wire kind (port of
`gorder_tpu/engine/fused.py` `_build_fused_steps` for the b7, int16 and
f32 wires): decode the shipped payload on the device, classify leaflets
where the batch carries what the classifier reads, and run the order
step. PyTorch runs eagerly, so these are plain functions; the JAX package
traces each into one XLA program.

Each takes (step, wire tensors, inv_scale, box_diag, normal, frame_mask,
classifiers, classes) and returns (the step's int64 output, the (B, M)
classes it used or None). `classes` are host classes shipped with the
batch (manual tables, frequency-gated methods); without them a leaflet
run classifies here with the run's `Classifiers`.

Kinds: `b7` (no leaflets), `b7g` (heads + decoder COG), `b7x` (aux atoms),
`b7m` (host class plane), and the coordinate wires `i16`/`f32`, with a
trailing decoder COG as `i16g`/`f32g`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .wire import b7_residuals


@dataclass
class Classifiers:
    """The leaflet classifiers a run's wire kinds call, flip applied;
    None where the run has no such kind."""

    coords: Optional[Callable] = None          # (coords f32, box)
    channel_coords: Optional[Callable] = None  # (coords f32, cog, box)
    channel: Optional[Callable] = None         # b7g: (heads f32, cog, box)
    aux: Optional[Callable] = None             # b7x: (aux f32, box)


def _resid(step, w, scale, box, normal, mask, classes):
    pk, gp, vl, base = w[:4]
    r = b7_residuals(pk, gp, vl, base.shape[0])
    return step.resid(r, base, scale, box, normal, mask, classes=classes), \
        classes


def run_b7(step, w, scale, box, normal, mask, cl, classes=None):
    """b7 wire: the escape-applied int16 residuals go straight into the
    kernel, which adds the per-slot base and dequantizes (resid input).
    A b7m batch comes here too, with its host class plane as `classes`."""
    return _resid(step, w, scale, box, normal, mask, classes)


def run_b7g(step, w, scale, box, normal, mask, cl, classes=None):
    """b7 + heads and the decoder's membrane COG: the heads dequantize as
    the coordinate wires do, f32(int)·s, a bit-identical gather."""
    heads = w[4].to(scale.dtype) * scale[:, None, None]
    classes = cl.channel(heads, w[5], box)
    return _resid(step, w, scale, box, normal, mask, classes)


def run_b7x(step, w, scale, box, normal, mask, cl, classes=None):
    """b7 + the exact integer positions of the atoms the classifier reads
    (individual leaflets: heads and methyls)."""
    aux = w[4].to(scale.dtype) * scale[:, None, None]
    classes = cl.aux(aux, box)
    return _resid(step, w, scale, box, normal, mask, classes)


def _positions(step, coords, inv_scale, box, normal, mask, cl, classes,
               cog=None):
    """Coordinate wires: integer positions stay integer for the step (the
    single-rounding bond difference); the classifier reads f32(q)·s."""
    if classes is None and (cl.coords is not None or cog is not None):
        cf = (coords.to(inv_scale.dtype) * inv_scale[:, None, None]
              if inv_scale is not None else coords)
        classes = (cl.channel_coords(cf, cog, box) if cog is not None
                   else cl.coords(cf, box))
    return step.positions(coords, box, normal, mask, inv_scale=inv_scale,
                          classes=classes), classes


def run_i16(step, w, scale, box, normal, mask, cl, classes=None):
    """int16 XTC integers."""
    return _positions(step, w[0], scale, box, normal, mask, cl, classes)


def run_f32(step, w, scale, box, normal, mask, cl, classes=None):
    """f32 positions (non-XTC input): pair differences."""
    return _positions(step, w[0], None, box, normal, mask, cl, classes)


def run_i16g(step, w, scale, box, normal, mask, cl, classes=None):
    """int16 + the decoder's membrane COG."""
    return _positions(step, w[0], scale, box, normal, mask, cl, classes,
                      cog=w[1])


def run_f32g(step, w, scale, box, normal, mask, cl, classes=None):
    """f32 + the decoder's membrane COG."""
    return _positions(step, w[0], None, box, normal, mask, cl, classes,
                      cog=w[1])


BY_KIND = {"b7": run_b7, "b7g": run_b7g, "b7x": run_b7x, "b7m": run_b7,
           "i16": run_i16, "f32": run_f32, "i16g": run_i16g,
           "f32g": run_f32g}
