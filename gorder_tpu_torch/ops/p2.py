"""The P2 kernel's wrappers and their plain PyTorch versions (port of
`gorder_tpu/ops/pallas_p2.py`).

`p2_b7` (b7 wire) and `p2_positions` (integer or f32 positions) return
the
(B, 2, T) int64 per-frame, per-type [sum, count] of the quantized samples;
with leaflet `classes` (B, M) int32 and each bond's molecule `bond_mol`
(N,) int32 (the `with_leaflets` variant), (B, 3, 2, T): total, upper and
lower. `normal` is the static (3,) f32 normal, or (B, M, 3) f32
per-molecule normals read through `bond_mol` (the `per_bond_normal`
variant), with or without classes. Integer positions are the XTC
integers of the i16 and i12 wires (int16) or of the s6 and d8 wires
(int32, for trajectories whose integers overflow int16); the TPU kernel
takes either. `p2_positions` with `pair` takes the pair difference of
dequantized integer positions (the `pair_quantized`
variant of ordermap runs), and with an ordermap (`map_spec` and its
(C, 2, T·n0·n1 + 1) int64 `map_state`) adds every sample to the map too,
in place (`core/ordermap.py`). With a geometry selection (the
`with_geom` variant), `geo` is the (B, ⌈N/8⌉) uint8 inside-shape bitplane
(`engine/wire.py geo_bits`): a bond whose bit is 0 adds nothing to the
sums, the counts or the map. The b7geo wire gives it to `p2_b7`, which
is how the TPU kernel's `diff_input` variant (bond vectors with a geometry
plane) is ported. `p2_b7` takes the b7 wire packed, as the decoder ships
it; the kernel unpacks it in registers, and only the plain version runs
`engine/wire.py b7_residuals`. For tensors on the CPU they run the plain
version (`gorder_tpu_torch/core/order.py`); for CUDA tensors they launch
the hand-written kernel (`csrc/p2.cu`) on the current stream, or raise.
There is no fallback from the kernel to the plain version. The kernel
writes its whole output (or zeroes it on the stream first), so the
wrappers allocate it with `torch.empty`.
"""

from __future__ import annotations

import torch

from ..core.order import order_step
from ..io.native import b7_stride
from .build import (call, check_tensor, device_of, frame_args, geo_args,
                    map_args, molecule_args)

#: the b7 wire's largest escape capacity (engine/wire.py `_Capped.caps`)
MAX_ESCAPES = 8192

#: launches of the P2 kernel since the last reset: the plain variant, for
#: any input but int32; the with_leaflets variant (classes with the static
#: normal), by input; the per_bond_normal variant ((B, M, 3) normals, with
#: or without classes: a launch with both counts here only), by input; the
#: pair_quantized variant without a map, by integer input; and the map
#: output, by input (pair int16, pair int32, f32), with or without classes
#: and normals. A launch counts in one count only: a map launch in its map
#: count, a pair launch in the pair count. A launch with a geometry
#: bitplane counts in the with_geom count of its input only, whatever else
#: it takes. The int32 input (s6, d8) has its own count of each. The
#: plain version counts in none.
p2_launches = 0
p2_i32_launches = 0
p2_leaflets_launches = 0            # b7 wire
p2_i16_leaflets_launches = 0
p2_f32_leaflets_launches = 0
p2_normals_launches = 0             # b7 wire
p2_i32_leaflets_launches = 0
p2_i16_normals_launches = 0
p2_i32_normals_launches = 0
p2_f32_normals_launches = 0
p2_i16_pair_launches = 0
p2_i32_pair_launches = 0
p2_i16_map_launches = 0
p2_i32_map_launches = 0
p2_f32_map_launches = 0
p2_geom_launches = 0                # b7 wire (b7geo)
p2_i16_geom_launches = 0
p2_i32_geom_launches = 0
p2_i16_pair_geom_launches = 0       # with or without a map
p2_i32_pair_geom_launches = 0
p2_f32_geom_launches = 0

_PLAIN_COUNT = {"p2_positions_i32": "p2_i32_launches"}
_LEAFLETS_COUNT = {"p2_b7": "p2_leaflets_launches",
                   "p2_positions_i16": "p2_i16_leaflets_launches",
                   "p2_positions_i32": "p2_i32_leaflets_launches",
                   "p2_positions_f32": "p2_f32_leaflets_launches"}
_NORMALS_COUNT = {"p2_b7": "p2_normals_launches",
                  "p2_positions_i16": "p2_i16_normals_launches",
                  "p2_positions_i32": "p2_i32_normals_launches",
                  "p2_positions_f32": "p2_f32_normals_launches"}
_GEOM_COUNT = {"p2_b7": "p2_geom_launches",
               "p2_positions_i16": "p2_i16_geom_launches",
               "p2_positions_i32": "p2_i32_geom_launches",
               "p2_positions_i16_pair": "p2_i16_pair_geom_launches",
               "p2_positions_i32_pair": "p2_i32_pair_geom_launches",
               "p2_positions_f32": "p2_f32_geom_launches"}


def _geo_mask(geo, n_bonds: int):
    """The plain version's (B, N) bool mask of a bitplane, or None."""
    from ..engine.wire import geo_bits

    return None if geo is None else geo_bits(geo, n_bonds)


def p2_b7_plain(pk, gp, vl, base, inv_scale, box_diag, normal, frame_mask,
                bond_type, n_types: int, *, handle_pbc: bool, classes=None,
                bond_mol=None, geo=None):
    from ..engine.wire import b7_residuals

    r = b7_residuals(pk, gp, vl, base.shape[0])
    return order_step(r, box_diag, normal, frame_mask, None, None,
                      bond_type, n_types, inv_scale, base,
                      handle_pbc=handle_pbc, classes=classes,
                      bond_mol=bond_mol,
                      geo=_geo_mask(geo, bond_type.shape[0]))


def p2_positions_plain(coords, atom_a, atom_b, inv_scale, box_diag, normal,
                       frame_mask, bond_type, n_types: int, *,
                       handle_pbc: bool, classes=None, bond_mol=None,
                       pair: bool = False, map_spec=None, map_state=None,
                       geo=None):
    return order_step(coords, box_diag, normal, frame_mask, atom_a, atom_b,
                      bond_type, n_types, inv_scale, handle_pbc=handle_pbc,
                      classes=classes, bond_mol=bond_mol, pair=pair,
                      map_spec=map_spec, map_state=map_state,
                      geo=_geo_mask(geo, bond_type.shape[0]))


def _launch(fn_name, n_frames, n_bonds, n_types, device, args_before_out,
            ints_after_out, molecules, geo, grid=None, count=None):
    """One launch into a new output, which the kernel writes whole (or
    zeroes before it adds with atomics); `molecules` is the (per-molecule
    normals?, classes, bond_mol, n_molecules) of `build.molecule_args`,
    `geo` the checked bitplane or None, `grid` the `build.MapGrid` of the
    entry points that take one, and `count` the launch count to add to
    when it is not the variant's."""
    global p2_launches
    mol_normals, classes, bond_mol, n_molecules = molecules
    shape = ((n_frames, 3, 2, n_types) if classes is not None
             else (n_frames, 2, n_types))
    # a launch without bonds returns before it writes anything
    alloc = torch.empty if n_bonds else torch.zeros
    out = alloc(shape, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        call(fn_name, *args_before_out,
             classes.data_ptr() if classes is not None else None,
             bond_mol.data_ptr() if bond_mol is not None else None,
             geo.data_ptr() if geo is not None else None,
             out.data_ptr(), *(() if grid is None else (grid,)),
             *ints_after_out, int(mol_normals), n_molecules, stream)
    if geo is not None:
        globals()[_GEOM_COUNT[fn_name]] += 1
    elif count is not None:
        globals()[count] += 1
    elif mol_normals:
        globals()[_NORMALS_COUNT[fn_name]] += 1
    elif classes is not None:
        globals()[_LEAFLETS_COUNT[fn_name]] += 1
    elif fn_name in _PLAIN_COUNT:
        globals()[_PLAIN_COUNT[fn_name]] += 1
    else:
        p2_launches += 1
    return out


def p2_b7(pk, gp, vl, base, inv_scale, box_diag, normal, frame_mask,
          bond_type, n_types: int, *, handle_pbc: bool, classes=None,
          bond_mol=None, geo=None):
    """b7 wire, packed: pk (B, b7_stride(N)) uint8 7-bit codes, gp (B, cap)
    u16 escape gaps carried in int16, vl (B, cap) int16 escape values
    (cap <= 8192), base (3N,) int32, inv_scale (B,) f32, box_diag (B, 3)
    f32, normal (3,) f32 or (B, M, 3) f32 with bond_mol, frame_mask (B,)
    bool/uint8, bond_type (N,) int32 → (B, 2, T) int64; with classes
    (B, M) int32 and bond_mol (N,) int32 → (B, 3, 2, T); geo (B, ⌈N/8⌉)
    uint8 or None."""
    device = device_of(pk)
    if device.type == "cpu":
        return p2_b7_plain(pk, gp, vl, base, inv_scale, box_diag, normal,
                           frame_mask, bond_type, n_types,
                           handle_pbc=handle_pbc, classes=classes,
                           bond_mol=bond_mol, geo=geo)
    n_frames = pk.shape[0]
    n_bonds = bond_type.shape[0]
    stride = b7_stride(n_bonds)
    cap = gp.shape[-1]
    check_tensor("pk", pk, torch.uint8, (n_frames, stride), device)
    check_tensor("gp", gp, torch.int16, (n_frames, cap), device)
    check_tensor("vl", vl, torch.int16, (n_frames, cap), device)
    if cap > MAX_ESCAPES:
        raise ValueError(f"the b7 wire holds at most {MAX_ESCAPES} escapes "
                         f"a frame, not {cap}")
    check_tensor("base", base, torch.int32, (3 * n_bonds,), device)
    check_tensor("inv_scale", inv_scale, torch.float32, (n_frames,),
                 device)
    frame_mask = frame_args(box_diag, frame_mask, bond_type, n_frames,
                            n_bonds, device)
    return _launch(
        "p2_b7", n_frames, n_bonds, n_types, device,
        (pk.data_ptr(), gp.data_ptr(), vl.data_ptr(), base.data_ptr(),
         inv_scale.data_ptr(), box_diag.data_ptr(), normal.data_ptr(),
         frame_mask.data_ptr(), bond_type.data_ptr()),
        (n_frames, stride, cap, n_bonds, n_types, int(handle_pbc)),
        molecule_args(normal, classes, bond_mol, n_frames, n_bonds, device),
        geo_args(geo, n_frames, n_bonds, device))


def p2_positions(coords, atom_a, atom_b, inv_scale, box_diag, normal,
                 frame_mask, bond_type, n_types: int, *, handle_pbc: bool,
                 classes=None, bond_mol=None, pair: bool = False,
                 map_spec=None, map_state=None, geo=None):
    """Integer positions: coords (B, A, 3) int16 or int32 with inv_scale
    (B,) f32, the pair difference f32(q_b)·s − f32(q_a)·s with `pair`
    (`pair_quantized`), else the single rounding f32(q_b − q_a)·s; f32
    positions: coords (B, A, 3) f32 with inv_scale None. atom_a/atom_b
    (N,) int32; the rest as for p2_b7 → (B, 2, T) or (B, 3, 2, T) int64.
    With `map_spec` and its
    (C, 2, T·n0·n1 + 1) int64 `map_state` (C = 3 with classes, else 1;
    integer positions with `pair` only), every sample is also added to the
    map, in place. geo (B, ⌈N/8⌉) uint8 or None, as for p2_b7."""
    device = device_of(coords)
    if device.type == "cpu":
        return p2_positions_plain(coords, atom_a, atom_b, inv_scale,
                                  box_diag, normal, frame_mask, bond_type,
                                  n_types, handle_pbc=handle_pbc,
                                  classes=classes, bond_mol=bond_mol,
                                  pair=pair, map_spec=map_spec,
                                  map_state=map_state, geo=geo)
    n_frames, n_atoms = coords.shape[:2]
    n_bonds = atom_a.shape[0]
    dtype = (torch.float32 if inv_scale is None
             else torch.int32 if coords.dtype == torch.int32 else torch.int16)
    check_tensor("coords", coords, dtype, (n_frames, n_atoms, 3), device)
    check_tensor("atom_a", atom_a, torch.int32, (n_bonds,), device)
    check_tensor("atom_b", atom_b, torch.int32, (n_bonds,), device)
    frame_mask = frame_args(box_diag, frame_mask, bond_type, n_frames,
                            n_bonds, device)
    molecules = molecule_args(normal, classes, bond_mol, n_frames, n_bonds,
                              device)
    geo = geo_args(geo, n_frames, n_bonds, device)
    if map_state is not None and inv_scale is not None and not pair:
        raise ValueError("an ordermap on integer positions takes the pair "
                         "difference (pair=True)")
    grid = map_args(map_spec, map_state, 3 if classes is not None else 1,
                    n_types, device)
    common = (box_diag.data_ptr(), normal.data_ptr(), frame_mask.data_ptr(),
              bond_type.data_ptr())
    ints = (n_frames, n_atoms, n_bonds, n_types, int(handle_pbc))
    if inv_scale is None:
        return _launch("p2_positions_f32", n_frames, n_bonds, n_types,
                       device, (coords.data_ptr(), atom_a.data_ptr(),
                        atom_b.data_ptr(), *common), ints, molecules, geo,
                       grid, "p2_f32_map_launches" if map_state is not None
                       else None)
    check_tensor("inv_scale", inv_scale, torch.float32, (n_frames,), device)
    args = (coords.data_ptr(), atom_a.data_ptr(), atom_b.data_ptr(),
            inv_scale.data_ptr(), *common)
    bits = "i32" if dtype == torch.int32 else "i16"
    if not pair:
        return _launch(f"p2_positions_{bits}", n_frames, n_bonds, n_types,
                       device, args, ints, molecules, geo)
    return _launch(f"p2_positions_{bits}_pair", n_frames, n_bonds, n_types,
                   device, args, ints, molecules, geo, grid,
                   f"p2_{bits}_map_launches" if map_state is not None
                   else f"p2_{bits}_pair_launches")
