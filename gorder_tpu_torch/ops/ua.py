"""The united-atom kernel's wrapper and its plain PyTorch version (port of
`gorder_tpu/ops/pallas_ua.py`).

`ua_positions` returns the (B, 2, T) int64 per-frame, per-type [sum, count]
of the quantized virtual C–H samples; with leaflet `classes` (the
`with_leaflets` variant), (B, 3, 2, T): total, upper and lower. `normal`
is the static (3,) f32 normal, or (B, M, 3) f32 per-molecule normals read
by each carbon's molecule (the `per_bond_normal` variant), with or
without classes. With an ordermap (`map_spec` and its (C, 2, T·n0·n1 + 1)
int64 `map_state`) every sample is also added to the map, in place
(`core/ordermap.py`). With a geometry selection (`geom_spec` and the
(B, 3) f32 `reference` point of each frame), a sample counts only where
its bond position lies inside the shape: the TPU kernel has no geometry
variant (pallas_ua.py:60-61) and the JAX package runs it in XLA, but the
bond position exists only inside this kernel, so the test is made there
(`csrc/common.cuh GeoShape`). For tensors on the CPU it runs the
plain version (`gorder_tpu_torch/core/ua.py ua_step`); for CUDA tensors it
makes one launch of the hand-written kernel (`csrc/ua.cu`) per category
present, on the current stream — as the TPU wrapper makes one
`pallas_call` per category — or raises: the first launch writes the whole
output (so it is allocated with `torch.empty`), each later one adds into
it. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from ..core.ua import N_HYDROGENS, TRIG, ua_step
from .build import (Trig, call, check_tensor, device_of, frame_args,
                    leaflet_args, map_args, normal_args, shape_args)

#: launches of the UA kernel (one per category and batch) since the last
#: reset: the plain variant; the with_leaflets variant (classes with the
#: static normal); the per_bond_normal variant ((B, M, 3) normals, with or
#: without classes); the map output (with or without classes and
#: normals); and the geometry test (with or without any of those), on
#: int16 or f32 positions; and every launch on int32 positions (the s6
#: and d8 wires), whatever its variant. A launch counts in one count
#: only: an int32 launch in the int32 count, a geometry launch in the
#: geometry count, a map launch in the map count, one with normals in the
#: normals count. The plain version counts in none.
ua_launches = 0
ua_i32_launches = 0
ua_leaflets_launches = 0
ua_normals_launches = 0
ua_map_launches = 0
ua_geom_launches = 0

_CATEGORY_ID = {"ch3": 0, "ch2": 1, "ch1u": 2, "ch1s": 3}


def ua_positions_plain(coords, inv_scale, box_diag, normal, frame_mask,
                       indices, bond_type, n_types: int, *,
                       handle_pbc: bool, layout, classes=None,
                       bond_mol=None, map_spec=None, map_state=None,
                       geom_spec=None, reference=None):
    return ua_step(coords, box_diag, normal, frame_mask, indices, bond_type,
                   n_types, inv_scale, handle_pbc=handle_pbc, layout=layout,
                   classes=classes, bond_mol=bond_mol, map_spec=map_spec,
                   map_state=map_state, geom_spec=geom_spec,
                   reference=reference)


def ua_positions(coords, inv_scale, box_diag, normal, frame_mask, indices,
                 bond_type, n_types: int, *, handle_pbc: bool, layout,
                 classes=None, bond_mol=None, map_spec=None, map_state=None,
                 geom_spec=None, reference=None):
    """Integer input: coords (B, A, 3) int16 or int32 XTC integers with
    inv_scale (B,) f32; f32 input: coords (B, A, 3) f32 with inv_scale
    None. indices: {category:
    {"target", "h1", "h2"[, "h3"][, "mol"]: (n,) int32}}; layout:
    ((category, n), ...) in concatenation order; bond_type (n_samples,)
    int32, category by category and hydrogen-major; box_diag (B, 3) f32,
    normal (3,) f32 or (B, M, 3) f32, frame_mask (B,) bool/uint8 →
    (B, 2, T) int64. With classes (B, M) int32 and the per-sample
    molecules bond_mol (n_samples,) int32 → (B, 3, 2, T); the plain
    version reads bond_mol, the kernel each category's per-carbon "mol"
    (the same molecules). Per-molecule normals are read by "mol" in
    both. With `map_spec` and its (C, 2, T·n0·n1 + 1) int64 `map_state`
    (C = 3 with classes, else 1), every sample is also added to the map,
    in place. With `geom_spec` and its (B, 3) f32 `reference`, only the
    samples inside the shape count."""
    global ua_launches, ua_leaflets_launches, ua_normals_launches
    global ua_map_launches, ua_geom_launches, ua_i32_launches
    device = device_of(coords)
    if device.type == "cpu":
        return ua_positions_plain(coords, inv_scale, box_diag, normal,
                                  frame_mask, indices, bond_type, n_types,
                                  handle_pbc=handle_pbc, layout=layout,
                                  classes=classes, bond_mol=bond_mol,
                                  map_spec=map_spec, map_state=map_state,
                                  geom_spec=geom_spec, reference=reference)
    n_frames, n_atoms = coords.shape[:2]
    n_samples = sum(n * N_HYDROGENS[cat] for cat, n in layout)
    dtype = (torch.float32 if inv_scale is None
             else torch.int32 if coords.dtype == torch.int32 else torch.int16)
    check_tensor("coords", coords, dtype, (n_frames, n_atoms, 3), device)
    if inv_scale is not None:
        check_tensor("inv_scale", inv_scale, torch.float32, (n_frames,),
                     device)
    frame_mask = frame_args(box_diag, frame_mask, bond_type, n_frames,
                            n_samples, device)
    n_normals = normal_args(normal, n_frames, device)
    classes, _, n_molecules = leaflet_args(classes, bond_mol, n_frames,
                                           n_samples, device)
    if n_normals and classes is not None and n_normals != n_molecules:
        raise ValueError(f"normals of {n_normals} molecules and classes of "
                         f"{n_molecules}")
    n_molecules = n_normals or n_molecules
    grid = map_args(map_spec, map_state, 3 if classes is not None else 1,
                    n_types, device)
    shape = shape_args(geom_spec, reference, n_frames, device)
    by_mol = classes is not None or n_normals > 0
    for cat, n in layout:
        for key, ix in indices[cat].items():
            check_tensor(f"{cat} {key}", ix, torch.int32, (n,), device)
        if cat == "ch1s" and "h3" not in indices[cat]:
            raise ValueError("ch1s needs its third helper, h3")
        if by_mol and "mol" not in indices[cat]:
            raise ValueError(f"{cat} needs its per-carbon molecule index, "
                             f"mol, for leaflet classes or per-molecule "
                             f"normals")

    # the first category's launch writes every entry
    alloc = torch.empty if any(n > 0 for _, n in layout) else torch.zeros
    out = alloc((n_frames, 3, 2, n_types) if classes is not None
                else (n_frames, 2, n_types), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    common = (box_diag.data_ptr(), normal.data_ptr(), Trig(*TRIG),
              frame_mask.data_ptr(),
              classes.data_ptr() if classes is not None else None,
              out.data_ptr(), grid, shape,
              reference.data_ptr() if reference is not None else None,
              n_frames, n_atoms)
    offset = 0
    launched = False
    for cat, n in layout:
        ix = indices[cat]
        k = N_HYDROGENS[cat]
        if n > 0:
            atoms = (ix["target"].data_ptr(), ix["h1"].data_ptr(),
                     ix["h2"].data_ptr(),
                     ix["h3"].data_ptr() if cat == "ch1s" else None,
                     ix["mol"].data_ptr() if by_mol else None,
                     bond_type[offset:].data_ptr())
            ints = (n, n_types, int(handle_pbc), int(n_normals > 0),
                    n_molecules, int(launched), stream)
            launched = True
            with torch.cuda.device(device):
                if inv_scale is not None:
                    call("ua_positions_i32" if dtype == torch.int32
                         else "ua_positions_i16", _CATEGORY_ID[cat],
                         coords.data_ptr(), inv_scale.data_ptr(), *atoms,
                         *common, *ints)
                else:
                    call("ua_positions_f32", _CATEGORY_ID[cat],
                         coords.data_ptr(), *atoms, *common, *ints)
            if dtype == torch.int32:
                ua_i32_launches += 1
            elif reference is not None:
                ua_geom_launches += 1
            elif map_state is not None:
                ua_map_launches += 1
            elif n_normals:
                ua_normals_launches += 1
            elif classes is not None:
                ua_leaflets_launches += 1
            else:
                ua_launches += 1
        offset += n * k
    return out
