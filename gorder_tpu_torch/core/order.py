"""The P2/order-parameter step (port of `gorder_tpu/core/order.py` for a
static or per-molecule membrane normal, overall and per leaflet, with or
without ordermaps and geometry selection).

Per bond instance and frame: bond vector → minimum image → projection on
the normal (the static one, or the bond's molecule's dynamic or manual
normal) → S = 1.5·cos²θ − 0.5 → the reference's fixed-point sample
`round_half_away(f64(S)·1e6)` (src/analysis/order.rs:21-26) → exact int64
sums and counts per frame and bond type, and with leaflet classes also
per class: total, upper (class 0) and lower (class 1) of the bond's
molecule (gorder_tpu/core/order.py:231-235). A class that is neither 0
nor 1 counts in total only. With an ordermap, each sample also goes to
the map tile of its bond midpoint (`core/ordermap.py`). With a geometry
selection, a sample whose bond midpoint lies outside the shape counts in
no class, no type sum and no map tile (`core/geometry.py`).

The JAX package reproduces that rounding in pure f32 with a two-product
and sums it as 7-bit limbs on the MXU, because TPU kernels have no f64.
PyTorch and the card have f64 and int64: `f64(S)·1e6` is exact (an f32
mantissa times 1e6 needs at most 38 bits), `floor(|x| + 0.5)` of it is
exact too, and integer sums are exact in any order, so the result is
deterministic even when a kernel adds with atomics.

The functions here are the plain PyTorch version of the step; the
hand-written kernel (`ops/p2.py`, `csrc/p2.cu`) computes the same
integers.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import inside_mask
from .ordermap import map_cells, update_maps
from .pbc import circular_mean_cog, min_image, naive_cog

_SCALE = 1.0e6
_LIMB = 128      # the JAX kernel's limb radix (gorder_tpu/core/order.py)


def quantize(sch: torch.Tensor) -> torch.Tensor:
    """f32 samples → int64 fixed point, rounding f64(sch)·1e6 half away from
    zero like the reference. Never `torch.round`: it rounds half to
    even."""
    x = sch.to(torch.float64) * _SCALE
    return (torch.sign(x) * torch.floor(torch.abs(x) + 0.5)).to(torch.int64)


def resid_vectors(r: torch.Tensor, base: torch.Tensor,
                  inv_scale: torch.Tensor) -> torch.Tensor:
    """b7 wire: (B, 3N) int16 residuals + (3N,) int32 per-slot base, slot =
    bond·3 + c, and the (B,) dequantization scale → (B, N, 3) f32 bond
    vectors d = f32(base + r)·s (gorder_tpu/ops/pallas_p2.py:191-197)."""
    q = base.to(torch.int32)[None, :] + r.to(torch.int32)
    d = q.to(torch.float32) * inv_scale[:, None]
    return d.reshape(r.shape[0], -1, 3)


def position_vectors(coords: torch.Tensor, atom_a: torch.Tensor,
                     atom_b: torch.Tensor,
                     inv_scale: torch.Tensor | None = None, *,
                     pair: bool = False):
    """(B, A, 3) positions → (B, N, 3) f32 bond vectors.

    Integer positions (with `inv_scale`) take the single-rounding integer
    difference f32(q_b − q_a)·s (gorder_tpu/core/order.py:144-167), bit for
    bit the b7 wire's vectors; f32 positions take the pair difference
    p_b − p_a (:173-178). With `pair`, integer positions take the pair
    difference of the dequantized positions too, f32(q_b)·s − f32(q_a)·s
    (the `pair_quantized` formulation of ordermap runs, :144-162, whose
    midpoints must be the reference's f32-position arithmetic bit for
    bit), and the result is (d, p_a): the vectors and the (B, N, 3) f32
    first atoms."""
    if pair and inv_scale is not None:
        coords = coords.to(torch.float32) * inv_scale[:, None, None]
        inv_scale = None
    pa = coords.index_select(1, atom_a)
    pb = coords.index_select(1, atom_b)
    if inv_scale is None:
        d = pb - pa
    else:
        d = (pb.to(torch.int32) - pa.to(torch.int32)).to(torch.float32) \
            * inv_scale[:, None, None]
    return (d, pa) if pair else d


def p2_sums(d: torch.Tensor, box_diag: torch.Tensor, normal: torch.Tensor,
            frame_mask: torch.Tensor, bond_type: torch.Tensor, n_types: int,
            *, handle_pbc: bool, classes: torch.Tensor | None = None,
            bond_mol: torch.Tensor | None = None, pa=None, map_spec=None,
            map_state=None, geo: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 3) f32 bond vectors → (B, 2, T) int64 per-frame, per-type
    [sum of quantized samples, sample count]; masked frames give zeros.
    With (B, M) int32 leaflet `classes` and the (N,) molecule of each bond
    `bond_mol` → (B, 3, 2, T): total, upper and lower.

    `normal` is the static (3,) normal, or (B, M, 3) per-molecule normals
    (dynamic or manual), each bond reading its molecule's through
    `bond_mol`: n = normal[b, bond_mol[i]], proj = (dx·nx + dy·ny) + dz·nz,
    n2 = max(nx·nx + ny·ny + nz·nz, 1e-18) and cos² = proj² / (max(d²,
    1e-18)·n2), one product in the denominator (gorder_tpu/core/order.py:
    185-192, ops/pallas_p2.py:128-134). With n = (0, 0, 1) both branches
    give the same bits.

    With an ordermap (`map_spec` and its (C, 2, S) int64 `map_state`, C the
    classes of the output), each sample is also added to the state, in
    place, at the tile of its bond midpoint pa + d·0.5 (d after the
    minimum image; `pa` the (B, N, 3) f32 first atoms), with the same
    sample and masks as the type sums (gorder_tpu/core/order.py:201-204,
    :239-242).

    With a geometry selection, `geo` is the (B, N) bool inside-shape mask
    of the samples (`geometry_plane`, or the decoder's bitplane unpacked):
    a sample outside counts nowhere, as the TPU kernel's `with_geom` plane
    multiplies every accumulator's mask (gorder_tpu/ops/pallas_p2.py:
    217-219).

    Every f32 operation is a separate, correctly rounded PyTorch op, in the
    order of the JAX Pallas kernel (gorder_tpu/ops/pallas_p2.py:120-141),
    with d² written as dx·dx + dy·dy + dz·dz (:127)."""
    if handle_pbc:
        d = min_image(d, box_diag[:, None, :])
    dx, dy, dz = d.unbind(-1)
    d2 = dx * dx + dy * dy + dz * dz
    if normal.dim() == 1:
        proj = dx * normal[0] + dy * normal[1] + dz * normal[2]
        cos2 = (proj * proj) / torch.clamp(d2, min=1e-18)
    else:
        nx, ny, nz = normal.index_select(1, bond_mol).unbind(-1)  # (B, N)
        proj = dx * nx + dy * ny + dz * nz
        n2 = torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-18)
        cos2 = (proj * proj) / (torch.clamp(d2, min=1e-18) * n2)
    q = quantize(1.5 * cos2 - 0.5)
    masks = class_masks(q, frame_mask, classes, bond_mol, geo)
    if map_state is not None:
        cells, _ = map_cells(pa + d * 0.5, map_spec, bond_type, n_types)
        update_maps(map_state, q, cells, masks)
    return class_sums(q, masks, bond_type, n_types)


def class_masks(q: torch.Tensor, frame_mask: torch.Tensor,
                classes: torch.Tensor | None = None,
                bond_mol: torch.Tensor | None = None,
                geo: torch.Tensor | None = None) -> list:
    """The (B, N) int64 masks of the samples `q` that each class counts:
    [valid frames], or with `classes` (B, M) and each sample's molecule
    `bond_mol` (N,) [total, upper (class 0), lower (class 1)]; with the
    (B, N) bool geometry mask `geo`, only the samples inside the shape."""
    valid = frame_mask.to(torch.int64)[:, None].expand_as(q)
    if geo is not None:
        valid = valid * geo
    if classes is None:
        return [valid]
    cls = classes.index_select(1, bond_mol)                  # (B, N)
    return [valid, valid * (cls == 0), valid * (cls == 1)]


def class_sums(q: torch.Tensor, masks: list, bond_type: torch.Tensor,
               n_types: int) -> torch.Tensor:
    """(B, N) int64 samples and their `class_masks` → per-type [sum,
    count]: (B, 2, T) for one class, (B, 3, 2, T) for total, upper and
    lower."""
    def reduce(m):
        shape = (q.shape[0], n_types)
        sums = torch.zeros(shape, dtype=torch.int64, device=q.device)
        counts = torch.zeros(shape, dtype=torch.int64, device=q.device)
        sums.index_add_(1, bond_type, q * m)
        counts.index_add_(1, bond_type, m)
        return torch.stack([sums, counts], dim=1)

    if len(masks) == 1:
        return reduce(masks[0])
    return torch.stack([reduce(m) for m in masks], dim=1)


def order_step(coords, box_diag, normal, frame_mask, atom_a, atom_b,
               bond_type, n_types: int, inv_scale=None, base=None, *,
               handle_pbc: bool, classes=None, bond_mol=None,
               pair: bool = False, map_spec=None, map_state=None,
               geo=None) -> torch.Tensor:
    """The plain step for its three inputs → (B, 2, T) int64, or
    (B, 3, 2, T) with leaflet `classes` and `bond_mol`; `normal` (3,), or
    (B, M, 3) with `bond_mol` (`p2_sums`):

    - b7 residuals: `coords` (B, 3N) int16 with `base` and `inv_scale`;
    - integer positions: `coords` (B, A, 3) int16 or int32 with
      `inv_scale`, the pair difference with `pair` (`position_vectors`);
    - f32 positions: `coords` (B, A, 3) f32.

    With `map_spec` and `map_state`, positions input only (integer ones
    with `pair`), the samples are also added to the map state, in
    place. `geo` is the (B, N) bool geometry mask (`p2_sums`)."""
    if map_state is not None and (base is not None or (
            inv_scale is not None and not pair)):
        raise ValueError("an ordermap takes positions, integer ones with "
                         "the pair difference")
    pa = None
    if base is not None:
        d = resid_vectors(coords, base, inv_scale)
    elif pair or map_state is not None:
        d, pa = position_vectors(coords, atom_a, atom_b, inv_scale,
                                 pair=True)
    else:
        d = position_vectors(coords, atom_a, atom_b, inv_scale)
    return p2_sums(d, box_diag, normal, frame_mask, bond_type, n_types,
                   handle_pbc=handle_pbc, classes=classes,
                   bond_mol=bond_mol, pa=pa, map_spec=map_spec,
                   map_state=map_state, geo=geo)


def geometry_reference(coords: torch.Tensor, box_diag: torch.Tensor,
                       geom_ref: torch.Tensor,
                       handle_pbc: bool) -> torch.Tensor:
    """The geometry's (B, 3) reference point per frame (port of
    `_geometry_reference`, gorder_tpu/core/order.py:108-123): `geom_ref`
    as it is when it is already (B, 3) (a fixed point tiled, or the box
    center), else the (K,) int32 atom indices of a selection, whose center
    is recomputed every frame from the f32 positions `coords` (B, A, 3):
    the refined circular mean under PBC, the plain mean without. The
    centers' sums reduce in another order than XLA's and take torch's
    cos/sin, so a selection's center agrees with the JAX package's to
    float noise, not bit for bit."""
    if geom_ref.dim() == 2:
        return geom_ref
    pts = coords.index_select(1, geom_ref)             # (B, K, 3)
    mask = torch.ones(pts.shape[:-1], dtype=coords.dtype,
                      device=coords.device)
    if handle_pbc:
        return circular_mean_cog(pts, mask, box_diag)
    return naive_cog(pts, mask)


def geometry_plane(coords, atom_a, atom_b, inv_scale, box_diag, geom_ref,
                   geom_spec, *, handle_pbc: bool,
                   pair: bool = False) -> torch.Tensor:
    """(B, N) bool: whether each bond's midpoint lies inside the geometry,
    from positions, computed on the device as the JAX package computes it
    where no decoder bitplane rides the wire (gorder_tpu/core/order.py:
    163-178, :201-214, :488-509). The midpoint is p_a + d·0.5 with d
    after the minimum image, and d is the step's own bond vector: the
    single rounding f32(q_b − q_a)·s for integer positions, the pair
    difference of an ordermap run's dequantized positions (`pair`), or
    p_b − p_a for f32 positions; p_a = f32(q_a)·s or the f32 position.
    The reference is `geometry_reference` of the f32 positions."""
    coords_f = (coords if inv_scale is None
                else coords.to(torch.float32) * inv_scale[:, None, None])
    if pair:
        d, pa = position_vectors(coords, atom_a, atom_b, inv_scale,
                                 pair=True)
    else:
        d = position_vectors(coords, atom_a, atom_b, inv_scale)
        pa = coords_f.index_select(1, atom_a)
    if handle_pbc:
        d = min_image(d, box_diag[:, None, :])
    ref = geometry_reference(coords_f, box_diag, geom_ref, handle_pbc)
    return inside_mask(pa + d * 0.5, ref, box_diag, geom_spec, handle_pbc)


class OrderStep:
    """The per-batch step of one analysis: its index arrays live on
    `device`, and each call routes through the hand-written kernel's
    wrapper (`ops/p2.py`), which runs the plain version for CPU tensors.
    With `with_leaflets`, every call takes the batch's (B, M) classes and
    returns (B, 3, 2, T). With `normal_mode` "per_molecule", every call
    takes the batch's (B, M, 3) normals; "static", the (3,) normal. The
    bonds' molecules `bond_mol` are kept for either. With a `map_spec`
    (an ordermap run), integer positions take the pair difference, and a
    call given the run's `map_state` adds its samples to it. With a
    `geom_spec` (a geometry selection), every call takes the batch's
    (B, ⌈N/8⌉) uint8 inside-shape bitplane `geo` (`engine/wire.py`
    layout), or, for positions, the batch's `geom_ref` from which the
    step computes it (`geometry_plane`)."""

    def __init__(self, atom_a, atom_b, bond_type, bond_mol, n_types: int, *,
                 handle_pbc: bool, with_leaflets: bool, device,
                 normal_mode: str = "static", map_spec=None,
                 geom_spec=None):
        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)

        if normal_mode not in ("static", "per_molecule"):
            raise ValueError(f"unknown normal_mode {normal_mode!r}")
        self.atom_a = idx(atom_a)
        self.atom_b = idx(atom_b)
        self.bond_type = idx(bond_type)
        self.normal_mode = normal_mode
        self.bond_mol = (idx(bond_mol) if with_leaflets
                         or normal_mode == "per_molecule" else None)
        self.n_types = int(n_types)
        self.handle_pbc = bool(handle_pbc)
        self.with_leaflets = bool(with_leaflets)
        self.map_spec = map_spec
        self.geom_spec = geom_spec

    def _molecules(self, normal, classes, geo):
        if (classes is not None) != self.with_leaflets:
            raise ValueError("leaflet classes must be given exactly when "
                             "the step was made with_leaflets")
        if (normal.dim() == 3) != (self.normal_mode == "per_molecule"):
            raise ValueError("(B, M, 3) normals must be given exactly when "
                             "the step was made per_molecule")
        if (geo is not None) != (self.geom_spec is not None):
            raise ValueError("a geometry bitplane must be given exactly "
                             "when the step was made with a geom_spec")
        return dict(classes=classes, bond_mol=self.bond_mol, geo=geo)

    def b7(self, pk, gp, vl, base, inv_scale, box_diag, normal,
           frame_mask, classes=None, geo=None):
        """b7 wire input, packed as the decoder ships it (the main path of
        runs without maps); `geo` the decoder's bitplane of a geometry run
        (b7geo)."""
        from ..ops.p2 import p2_b7

        if self.map_spec is not None:
            raise ValueError("an ordermap run never rides the b7 wire: its "
                             "samples need the bond positions")
        return p2_b7(pk, gp, vl, base, inv_scale, box_diag, normal,
                     frame_mask, self.bond_type, self.n_types,
                     handle_pbc=self.handle_pbc,
                     **self._molecules(normal, classes, geo))

    def positions(self, coords, box_diag, normal, frame_mask,
                  inv_scale=None, classes=None, map_state=None, geo=None,
                  geom_ref=None):
        """Integer positions (with `inv_scale`) or f32 positions. A
        geometry run gives the decoder's bitplane `geo` (the `*G` kinds) or
        the batch's `geom_ref`, from which the bitplane is computed
        here."""
        from ..engine.wire import pack_geo_bits
        from ..ops.p2 import p2_positions

        if map_state is not None and self.map_spec is None:
            raise ValueError("a map state needs a step made with a map_spec")
        pair = self.map_spec is not None
        if self.geom_spec is not None and geo is None:
            if geom_ref is None:
                raise ValueError("a geometry run needs the batch's bitplane "
                                 "or its geom_ref")
            geo = pack_geo_bits(geometry_plane(
                coords, self.atom_a, self.atom_b, inv_scale, box_diag,
                geom_ref, self.geom_spec, handle_pbc=self.handle_pbc,
                pair=pair))
        return p2_positions(coords, self.atom_a, self.atom_b, inv_scale,
                            box_diag, normal, frame_mask, self.bond_type,
                            self.n_types, handle_pbc=self.handle_pbc,
                            pair=pair, map_spec=self.map_spec,
                            map_state=map_state,
                            **self._molecules(normal, classes, geo))


def make_order_step(atom_a, atom_b, bond_type, bond_mol, n_types: int,
                    n_molecules: int, *, handle_pbc: bool = True,
                    device="cuda", with_leaflets: bool = False,
                    normal_mode: str = "static", map_spec=None,
                    geom_spec=None) -> OrderStep:
    """The reference's step factory (gorder_tpu/core/order.py:313): a
    static normal or per-molecule (dynamic or manual) normals, with or
    without leaflets, an ordermap (`map_spec`) and a geometry selection
    (`geom_spec`). `n_molecules` serves only those."""
    return OrderStep(atom_a, atom_b, bond_type, bond_mol, n_types,
                     handle_pbc=handle_pbc, with_leaflets=with_leaflets,
                     device=device, normal_mode=normal_mode,
                     map_spec=map_spec, geom_spec=geom_spec)


def from_reference_rows(rows) -> np.ndarray:
    """The JAX step's (B, 4, T) f32 limb rows [l2, l1, l0, count] → this
    port's (B, 2, T) int64 [sum, count] — the arithmetic of
    gorder_tpu/core/order.py recombine_limbs, so tests compare like with
    like."""
    rows = np.asarray(rows, np.float64)
    sums = (rows[..., 0, :] * (_LIMB * _LIMB) + rows[..., 1, :] * _LIMB
            + rows[..., 2, :]).astype(np.int64)
    counts = rows[..., 3, :].astype(np.int64)
    return np.stack([sums, counts], axis=-2)


class OrderAccumulator:
    """Host-side exact accumulation of the per-frame step outputs, with the
    reference's interface (gorder_tpu/core/order.py:566-610) but taking
    (B, 2, T) int64 [sum, count] per class directly. `add_step` takes a
    step's output as it comes: (B, 2, T) for the classes ("total",) and
    (B, 3, 2, T) for ("total", "upper", "lower")."""

    def __init__(self, n_types: int, classes=("total",), keep_timewise=False):
        self.n_types = n_types
        self.classes = classes
        self.keep_timewise = keep_timewise
        self.sums = {c: np.zeros(n_types, np.int64) for c in classes}
        self.counts = {c: np.zeros(n_types, np.int64) for c in classes}
        self.timewise_sums = ({c: [] for c in classes} if keep_timewise
                              else None)
        self.timewise_counts = ({c: [] for c in classes} if keep_timewise
                                else None)
        self.n_frames = 0

    def add_batch(self, result: dict, n_valid: int) -> None:
        for c in self.classes:
            res = np.asarray(result[c][:n_valid], np.int64)     # (b, 2, T)
            frame_sums, frame_counts = res[:, 0], res[:, 1]
            self.sums[c] += frame_sums.sum(axis=0)
            self.counts[c] += frame_counts.sum(axis=0)
            if self.keep_timewise:
                self.timewise_sums[c].append(frame_sums)
                self.timewise_counts[c].append(frame_counts)
        self.n_frames += n_valid

    def add_step(self, out: np.ndarray, n_valid: int) -> None:
        out = np.asarray(out)
        if out.ndim == 3:
            out = out[:, None]
        self.add_batch({c: out[:, k] for k, c in enumerate(self.classes)},
                       n_valid)

    def timewise(self, cls: str):
        """(frames, T) int64 per-frame sums and counts."""
        if not self.keep_timewise:
            raise ValueError("timewise data was not collected")
        return (
            np.concatenate(self.timewise_sums[cls], axis=0),
            np.concatenate(self.timewise_counts[cls], axis=0),
        )

    def order_values(self, cls: str, min_samples: int = 1) -> np.ndarray:
        """Average order per bond type; NaN below min_samples
        (order.rs `calc_order`)."""
        sums = self.sums[cls]
        counts = self.counts[cls]
        with np.errstate(invalid="ignore", divide="ignore"):
            values = sums / _SCALE / counts
        return np.where(counts >= max(min_samples, 1), values, np.nan)
