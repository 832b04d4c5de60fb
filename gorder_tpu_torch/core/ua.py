"""United-atom virtual hydrogens and their order parameters (port of
`gorder_tpu/core/ua.py` for a static membrane normal or per-molecule
(dynamic or manual) normals, overall and per leaflet, with or without
ordermaps and geometry selection).

Per target carbon and frame: its helper atoms → the buildH prediction of
its 1–3 hydrogens (src/analysis/uaorder.rs:944-1106) → per hydrogen the
C–H vector → minimum image → projection on the normal (the static one, or
the carbon's molecule's) → S = 1.5·cos²θ − 0.5 → the reference's
fixed-point sample (`core/order.py quantize`) → exact int64 sums and
counts per frame and bond type (and per leaflet class, as
`core/order.py class_sums` sums them); with an ordermap, each sample also
goes to the tile of its bond position, hydrogen + (C–H vector)/2
(`core/ordermap.py`); with a geometry selection, a sample whose bond
position lies outside the shape counts nowhere (`core/geometry.py`).

Every f32 step is one correctly rounded PyTorch op, grouped as the JAX
package's planar (structure-of-arrays) formulation groups it: a planar
triple is a tuple (x, y, z) of same-shaped tensors. Two places follow what
XLA compiles rather than what the JAX source says:

- `jnp.arccos(x)` compiles to `atan2(sqrt((1 − x)·(x + 1)), x)`, so the
  CH1-unsaturated predictor takes γ in that form;
- XLA folds `cos`/`sin` of the constant rotation angles at compile time,
  and its `sin(TETRAHEDRAL_ANGLE)` is one ulp off `np.sin`/`torch.sin`, so
  the six values are pinned below as the f32 numbers XLA folds them to.

The hand-written kernel (`ops/ua.py`, `csrc/ua.cu`) computes the same
integers as `ua_step` on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import inside_mask
from .order import class_masks, class_sums, geometry_reference, quantize
from .ordermap import map_cells, update_maps

TETRAHEDRAL_ANGLE = np.float32(1.910633)
TETRAHEDRAL_ANGLE_HALF = np.float32(0.9553165)
BOND_LENGTH = float(np.float32(0.109))
CH3_ANGLE = np.float32(2.0943952)

# cos and sin of TETRAHEDRAL_ANGLE, TETRAHEDRAL_ANGLE_HALF and CH3_ANGLE as
# XLA folds them (f32; the negative angles give cos(−a) = cos(a) and
# sin(−a) = −sin(a) there too). XLA's sin(TETRAHEDRAL_ANGLE) is one ulp
# below np.sin's; the other five agree with numpy and torch.
COS_TET = float.fromhex("-0x1.5555440000000p-2")
SIN_TET = float.fromhex("0x1.e2b7e00000000p-1")
COS_TET_HALF = float.fromhex("0x1.279a780000000p-1")
SIN_TET_HALF = float.fromhex("0x1.a20bd40000000p-1")
COS_CH3 = float.fromhex("-0x1.0000020000000p-1")
SIN_CH3 = float.fromhex("0x1.bb67ae0000000p-1")
#: the six pinned constants in the kernel's order
TRIG = (COS_TET, SIN_TET, COS_TET_HALF, SIN_TET_HALF, COS_CH3, SIN_CH3)

#: f32(π), as `jnp.pi - x` rounds it for an f32 x
PI_F32 = float(np.float32(np.pi))

#: categories in concatenation order, with their hydrogens and helper keys
CATEGORIES = ("ch3", "ch2", "ch1u", "ch1s")
N_HYDROGENS = {"ch3": 3, "ch2": 2, "ch1u": 1, "ch1s": 1}
HELPERS = {"ch3": ("h1", "h2"), "ch2": ("h1", "h2"), "ch1u": ("h1", "h2"),
           "ch1s": ("h1", "h2", "h3")}


def _psub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _pdot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _pcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _sqrt(x):
    """Correctly rounded f32 square root. torch's f32 `sqrt` on the CPU is
    not (it is one ulp off on about 0.7 % of inputs); the square root of
    an f32 taken in f64 and rounded to f32 is, on the CPU and on the card,
    where it equals the kernel's `sqrtf`."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _pnormalize(v, eps=1e-30):
    n = _sqrt(torch.clamp(_pdot(v, v), min=eps))
    return (v[0] / n, v[1] / n, v[2] / n)


def _pmin_image(d, box):
    return tuple(di - bi * torch.round(di / bi) for di, bi in zip(d, box))


def _pwrap(x, box):
    return tuple(xi - bi * torch.floor(xi / bi) for xi, bi in zip(x, box))


def _prodrigues_cs(v, axis, cos, sin):
    """v·cos + (axis×v)·sin + (axis·(axis·v))·(1−cos), grouped as
    `(v·c + k×v·s) + (axis·kdv)·(1 − c)`. `cos` and `sin` are tensors or
    Python floats that are exact f32 values; for a float, 1 − cos is exact
    in f64 and rounds to the f32 difference where torch casts it."""
    kc = _pcross(axis, v)
    kdv = _pdot(axis, v)
    one_m = 1.0 - cos
    return tuple(v[i] * cos + kc[i] * sin + (axis[i] * kdv) * one_m
                 for i in range(3))


def _padd_bond(t, hv):
    """t + normalize(hv)·BOND_LENGTH."""
    u = _pnormalize(hv)
    return (t[0] + u[0] * BOND_LENGTH,
            t[1] + u[1] * BOND_LENGTH,
            t[2] + u[2] * BOND_LENGTH)


def _helper_vectors(t, helpers, box, handle_pbc):
    ths = [_psub(h, t) for h in helpers]
    if handle_pbc:
        ths = [_pmin_image(th, box) for th in ths]
    return ths


def predict_ch3_planar(t, h1, h2, box, handle_pbc):
    th1, th2 = _helper_vectors(t, (h1, h2), box, handle_pbc)
    axis1 = _pnormalize(_pcross(th2, th1))
    hv1 = _prodrigues_cs(th1, axis1, COS_TET, SIN_TET)
    axis2 = _pnormalize(th1)
    hv2 = _prodrigues_cs(hv1, axis2, COS_CH3, SIN_CH3)
    hv3 = _prodrigues_cs(hv1, axis2, COS_CH3, -SIN_CH3)
    return [_padd_bond(t, hv1), _padd_bond(t, hv2), _padd_bond(t, hv3)]


def predict_ch2_planar(t, h1, h2, box, handle_pbc):
    th1, th2 = _helper_vectors(t, (h1, h2), box, handle_pbc)
    u1 = _pnormalize(th1)
    u2 = _pnormalize(th2)
    plane_normal = _pcross(u2, u1)
    rot_axis = _pnormalize(_psub(u1, u2))
    rot_vec = _pcross(plane_normal, rot_axis)
    hv1 = _prodrigues_cs(rot_vec, rot_axis, COS_TET_HALF, SIN_TET_HALF)
    hv2 = _prodrigues_cs(rot_vec, rot_axis, COS_TET_HALF, -SIN_TET_HALF)
    return [_padd_bond(t, hv1), _padd_bond(t, hv2)]


def acos_xla(x):
    """`jnp.arccos` as XLA compiles it: atan2(sqrt((1 − x)·(x + 1)), x)."""
    return torch.atan2(_sqrt((1.0 - x) * (x + 1.0)), x)


def predict_ch1_unsaturated_planar(t, h1, h2, box, handle_pbc):
    th1, th2 = _helper_vectors(t, (h1, h2), box, handle_pbc)
    dot = _pdot(th1, th2)
    norms = _sqrt(_pdot(th1, th1) * _pdot(th2, th2))
    gamma = acos_xla(torch.clamp(dot / torch.clamp(norms, min=1e-30),
                                 -1.0, 1.0))
    axis = _pnormalize(_pcross(th1, th2))
    angle = PI_F32 - gamma * 0.5
    hv = _prodrigues_cs(th2, axis, torch.cos(angle), torch.sin(angle))
    return [_padd_bond(t, hv)]


def predict_ch1_saturated_planar(t, h1, h2, h3, box, handle_pbc):
    th1, th2, th3 = _helper_vectors(t, (h1, h2, h3), box, handle_pbc)
    n1 = _pnormalize(th1)
    n2 = _pnormalize(th2)
    n3 = _pnormalize(th3)
    hv = tuple(-(n1[i] + n2[i] + n3[i]) for i in range(3))
    return [_padd_bond(t, hv)]


_PREDICT = {"ch3": predict_ch3_planar, "ch2": predict_ch2_planar,
            "ch1u": predict_ch1_unsaturated_planar,
            "ch1s": predict_ch1_saturated_planar}


def ua_step(coords, box_diag, normal, frame_mask, indices, bond_type,
            n_types: int, inv_scale=None, *, handle_pbc: bool,
            layout, classes=None, bond_mol=None, map_spec=None,
            map_state=None, geom_spec=None, reference=None) -> torch.Tensor:
    """The plain UA step (gorder_tpu/core/ua.py `_ua_step_impl`) → (B, 2, T)
    int64 per-frame, per-type [sum of quantized
    samples, sample count]; masked frames give zeros. With (B, M) leaflet
    `classes` and each sample's molecule `bond_mol` → (B, 3, 2, T): total,
    upper and lower.

    `normal` is the static (3,) normal, or (B, M, 3) per-molecule normals
    gathered by each carbon's molecule `indices[category]["mol"]`:
    proj = (vx·nx + vy·ny) + vz·nz, n2 = max(n·n, 1e-18) and
    S = 1.5·proj² / (max(v·v, 1e-18)·n2) − 0.5 (gorder_tpu/core/ua.py:
    282-301, ops/pallas_ua.py:136-141), grouped otherwise than the P2
    step's cos². With n = (0, 0, 1) both branches give the same bits.

    With an ordermap (`map_spec` and its (C, 2, S) int64 `map_state`),
    each sample is also added to the state, in place, at the tile of its
    bond position h + v·0.5: the hydrogen h wrapped into the box and the
    C–H vector v after the minimum image, when PBC is on (:302-306,
    :354-357).

    With a geometry selection (`geom_spec` and its (B, 3) f32 `reference`
    point per frame, `core/order.py geometry_reference` of the f32
    positions), a sample counts only where that bond position lies inside
    the shape (`core/geometry.py inside_mask`; :325-333).

    coords: (B, A, 3) int16 or int32 with `inv_scale` (B,) f32, or f32
    without; indices: {category: {"target", "h1", "h2"[, "h3"]: (n,) int}};
    layout: ((category, n), ...) in concatenation order; bond_type and
    bond_mol: per sample, category by category and hydrogen-major within
    one (sample = category offset + i·K + k)."""
    if inv_scale is not None:
        coords = coords.to(torch.float32) * inv_scale[:, None, None]
    cpl = tuple(coords[..., i] for i in range(3))
    boxp = tuple(box_diag[:, i:i + 1] for i in range(3))    # (B, 1) columns

    def gather(ix):
        return tuple(p.index_select(1, ix) for p in cpl)

    with_pos = map_state is not None or geom_spec is not None
    parts = []
    mids = []
    for category, _n in layout:
        ix = indices[category]
        t = gather(ix["target"])
        helpers = [gather(ix[k]) for k in HELPERS[category]]
        hydrogens = _PREDICT[category](t, *helpers, boxp, handle_pbc)
        if normal.dim() == 3:
            nrm = tuple(normal[..., i].index_select(1, ix["mol"])
                        for i in range(3))                   # (B, n) planes
            n2 = torch.clamp(_pdot(nrm, nrm), min=1e-18)
        per_atom = []
        per_atom_mid = []
        for hpos in hydrogens:
            if handle_pbc:
                hpos = _pwrap(hpos, boxp)
            vec = _psub(hpos, t)
            if handle_pbc:
                vec = _pmin_image(vec, boxp)
            d2 = torch.clamp(_pdot(vec, vec), min=1e-18)
            if normal.dim() == 3:
                proj = _pdot(vec, nrm)
                per_atom.append((1.5 * (proj * proj)) / (d2 * n2) - 0.5)
            else:
                proj = (vec[0] * normal[0] + vec[1] * normal[1]) \
                    + vec[2] * normal[2]
                per_atom.append((1.5 * (proj * proj)) / d2 - 0.5)
            if with_pos:
                per_atom_mid.append(torch.stack(
                    [hpos[i] + vec[i] * 0.5 for i in range(3)], dim=-1))
        # hydrogen-major per atom: (B, n, K) → (B, n·K)
        parts.append(torch.stack(per_atom, dim=-1).flatten(1))
        if with_pos:
            mids.append(torch.stack(per_atom_mid, dim=2).flatten(1, 2))
    q = quantize(torch.cat(parts, dim=1))                   # (B, Nv)
    bond_pos = torch.cat(mids, dim=1) if with_pos else None
    geo = (inside_mask(bond_pos, reference, box_diag, geom_spec, handle_pbc)
           if geom_spec is not None else None)
    masks = class_masks(q, frame_mask, classes, bond_mol, geo)
    if map_state is not None:
        cells, _ = map_cells(bond_pos, map_spec, bond_type, n_types)
        update_maps(map_state, q, cells, masks)
    return class_sums(q, masks, bond_type, n_types)


class UAStep:
    """The per-batch UA step of one analysis: its index arrays live on
    `device`, and each call routes through the kernel's wrapper
    (`ops/ua.py`), which runs the plain version for CPU tensors. With
    `with_leaflets`, every call takes the batch's (B, M) classes and
    returns (B, 3, 2, T); the plain version reads each sample's molecule
    (`bond_mol`), the kernel each carbon's (`mol`, the same molecules).
    With `normal_mode` "per_molecule", every call takes the batch's
    (B, M, 3) normals, which both read by each carbon's `mol`. With a
    `map_spec` (an ordermap run), a call given the run's `map_state` adds
    its samples to it. With a `geom_spec`, every call takes the batch's
    `geom_ref` (a (B, 3) point or box center, or a selection's (K,) atom
    indices), whose per-frame reference the kernel tests each bond
    position against."""

    def __init__(self, categories, bond_type, bond_mol, n_types: int, *,
                 handle_pbc: bool, with_leaflets: bool, device,
                 normal_mode: str = "static", map_spec=None,
                 geom_spec=None):
        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)

        if normal_mode not in ("static", "per_molecule"):
            raise ValueError(f"unknown normal_mode {normal_mode!r}")
        per_mol = with_leaflets or normal_mode == "per_molecule"
        keys = ("target",) + (("mol",) if per_mol else ())
        self.layout = tuple((cat, len(categories[cat]["target"]))
                            for cat in CATEGORIES if cat in categories)
        self.indices = {
            cat: {k: idx(categories[cat][k]) for k in keys + HELPERS[cat]}
            for cat, _ in self.layout}
        self.bond_type = idx(bond_type)
        self.bond_mol = idx(bond_mol) if with_leaflets else None
        self.n_types = int(n_types)
        self.handle_pbc = bool(handle_pbc)
        self.with_leaflets = bool(with_leaflets)
        self.normal_mode = normal_mode
        self.map_spec = map_spec
        self.geom_spec = geom_spec

    def positions(self, coords, box_diag, normal, frame_mask,
                  inv_scale=None, classes=None, map_state=None,
                  geom_ref=None):
        """Integer positions (with `inv_scale`) or f32 positions."""
        from ..ops.ua import ua_positions

        if (classes is not None) != self.with_leaflets:
            raise ValueError("leaflet classes must be given exactly when "
                             "the step was made with_leaflets")
        if (normal.dim() == 3) != (self.normal_mode == "per_molecule"):
            raise ValueError("(B, M, 3) normals must be given exactly when "
                             "the step was made per_molecule")
        if map_state is not None and self.map_spec is None:
            raise ValueError("a map state needs a step made with a map_spec")
        if (geom_ref is not None) != (self.geom_spec is not None):
            raise ValueError("geom_ref must be given exactly when the step "
                             "was made with a geom_spec")
        reference = None
        if geom_ref is not None:
            coords_f = (coords if inv_scale is None else
                        coords.to(torch.float32) * inv_scale[:, None, None])
            reference = geometry_reference(coords_f, box_diag, geom_ref,
                                           self.handle_pbc).contiguous()
        return ua_positions(coords, inv_scale, box_diag, normal, frame_mask,
                            self.indices, self.bond_type, self.n_types,
                            handle_pbc=self.handle_pbc, layout=self.layout,
                            classes=classes, bond_mol=self.bond_mol,
                            map_spec=self.map_spec, map_state=map_state,
                            geom_spec=self.geom_spec, reference=reference)


def make_ua_step(categories, bond_type, bond_mol, n_types: int, *,
                 handle_pbc: bool = True, device="cuda",
                 with_leaflets: bool = False, normal_mode: str = "static",
                 map_spec=None, geom_spec=None) -> UAStep:
    """The reference's step factory (gorder_tpu/core/ua.py:368): a static
    normal or per-molecule (dynamic or manual) normals, with or without
    leaflets, an ordermap (`map_spec`) and a geometry selection
    (`geom_spec`). With leaflets or per-molecule normals, every category
    needs its per-carbon molecule index `mol`."""
    return UAStep(categories, bond_type, bond_mol, n_types,
                  handle_pbc=handle_pbc, with_leaflets=with_leaflets,
                  device=device, normal_mode=normal_mode, map_spec=map_spec,
                  geom_spec=geom_spec)
