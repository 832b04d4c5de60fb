"""The hand-written P2 and UA kernels (gorder_tpu_torch/csrc/p2.cu, ua.cu),
with and without leaflet classes, per-molecule normals and ordermaps (the
map state, and P2's pair_quantized integer input), on int16, int32 (the
s6 and d8 wires) and f32 positions, against their plain PyTorch
versions, on the card; P2 also on the packed b7 wire with the
escape patterns the decoder can ship, and both kernels on the layouts of
their warp-aggregated type sums: type-major runs of a few lengths, and
mixed types. These tests need a CUDA device and skip without one; on the
card run

    python -m pytest -m cuda tests/test_torch_kernels.py

Integer sums are exact in any order and the kernel writes every f32 step
with a correctly rounded intrinsic, so the int64 outputs must be equal.
"""

import numpy as np
import pytest
import torch

from gorder_tpu_torch.ops import p2

from .test_torch_b7 import encode_b7

pytestmark = pytest.mark.cuda

#: bond type layouts: random types, or type-major runs of this many bonds
#: (the compiled topologies' layout, runs of n_molecules; a warp holds 32)
LAYOUTS = ["random", 1, 5, 31, 32, 33, 256]
#: UA target layouts (chip_smoke.ua_problem): mixed types, or type-major
UA_LAYOUTS = ["mixed", "type_major"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _problem(seed, n_frames, n_bonds, n_atoms, n_types, dev,
             layout="random"):
    """Positions that jitter by up to 40 XTC integers around a fixed
    structure, so that the b7 wire of their bond differences (against the
    first frame's) is mostly 7-bit codes with a few escapes."""
    rng = np.random.default_rng(seed)
    box = rng.uniform(3.0, 6.0, (n_frames, 3)).astype(np.float32)
    q = (rng.integers(-3000, 9000, (1, n_atoms, 3))
         + rng.integers(-40, 41, (n_frames, n_atoms, 3))).astype(np.int16)
    atom_a = rng.integers(0, n_atoms, n_bonds).astype(np.int32)
    atom_b = rng.integers(0, n_atoms, n_bonds).astype(np.int32)
    inv = np.full(n_frames, 1e-3, np.float32)
    d = (q[:, atom_b].astype(np.int32) - q[:, atom_a].astype(np.int32))
    flat = d.reshape(n_frames, 3 * n_bonds)
    base = flat[0].astype(np.int32)
    mask = np.ones(n_frames, bool)
    mask[-1] = False
    bond_type = (rng.integers(0, n_types, n_bonds) if layout == "random"
                 else (np.arange(n_bonds) // layout) % n_types)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    pk, gp, vl = encode_b7(flat - base[None])
    common = dict(
        box=t(box), normal=t(np.array([0.0, 0.0, 1.0], np.float32)),
        mask=t(mask), bond_type=t(bond_type.astype(np.int32)),
        n_types=n_types)
    return dict(
        common,
        b7=(t(pk), t(gp.view(np.int16)), t(vl), t(base), t(inv)),
        i16=(t(q), t(atom_a), t(atom_b), t(inv)),
        f32=(t(q.astype(np.float32) * inv[:, None, None]), t(atom_a),
             t(atom_b), None))


def _call(fn, kind, pb):
    c = (pb["box"], pb["normal"], pb["mask"], pb["bond_type"],
         pb["n_types"])
    return fn(*pb[kind], *c, handle_pbc=True)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["b7", "i16", "f32"])
@pytest.mark.parametrize("shape", [
    (8, 300, 200, 7),          # ragged single tile
    (64, 5000, 3000, 80),      # several blocks a frame, AA-like type count
    (300, 2000, 1000, 30),     # a block a frame: the table stored
    (4, 700, 400, 4000),       # T too large for shared memory: global path
])
def test_kernel_matches_plain(cuda, kind, shape, layout):
    pb = _problem(sum(shape), *shape, cuda, layout)
    kernel_fn = p2.p2_b7 if kind == "b7" else p2.p2_positions
    plain_fn = p2.p2_b7_plain if kind == "b7" \
        else p2.p2_positions_plain
    before = p2.p2_launches
    got = _call(kernel_fn, kind, pb)
    torch.cuda.synchronize()
    assert p2.p2_launches == before + 1
    want = _call(plain_fn, kind, pb)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)
    assert not got[-1].any()            # the masked frame stays zero


def _leaflets(seed, n_frames, n_bonds, n_mols, dev):
    """Classes in {0, 1, 2} (2 is neither leaflet: total only) and a
    molecule for each bond."""
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, 3, (n_frames, n_mols)).astype(np.int32)
    bond_mol = rng.integers(0, n_mols, n_bonds).astype(np.int32)
    return (torch.as_tensor(classes, device=dev),
            torch.as_tensor(bond_mol, device=dev))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["b7", "i16", "f32"])
@pytest.mark.parametrize("shape", [
    (8, 300, 200, 7, 5),       # ragged single tile
    (64, 5000, 3000, 80, 40),  # several blocks a frame, AA-like type count
    (300, 2000, 1000, 30, 20),  # a block a frame: the table stored
    (4, 700, 400, 1024, 9),    # (3, 2, T) fills the 48 KiB exactly
    (4, 700, 400, 1025, 9),    # one type more: global atomics
    (4, 700, 400, 1500, 9),
])
def test_leaflet_kernel_matches_plain(cuda, kind, shape, layout):
    n_frames, n_bonds, n_atoms, n_types, n_mols = shape
    pb = _problem(sum(shape), n_frames, n_bonds, n_atoms, n_types, cuda,
                  layout)
    classes, bond_mol = _leaflets(sum(shape), n_frames, n_bonds, n_mols,
                                  cuda)
    kernel_fn = p2.p2_b7 if kind == "b7" else p2.p2_positions
    plain_fn = p2.p2_b7_plain if kind == "b7" \
        else p2.p2_positions_plain
    c = (pb["box"], pb["normal"], pb["mask"], pb["bond_type"],
         pb["n_types"])
    counts = ("p2_launches", "p2_leaflets_launches",
              "p2_i16_leaflets_launches", "p2_f32_leaflets_launches")
    before = {name: getattr(p2, name) for name in counts}
    got = kernel_fn(*pb[kind], *c, handle_pbc=True, classes=classes,
                    bond_mol=bond_mol)
    torch.cuda.synchronize()
    grown = {"b7": "p2_leaflets_launches",
             "i16": "p2_i16_leaflets_launches",
             "f32": "p2_f32_leaflets_launches"}[kind]
    assert {name: getattr(p2, name) - before[name] for name in counts} == {
        name: int(name == grown) for name in counts}
    want = plain_fn(*pb[kind], *c, handle_pbc=True, classes=classes,
                    bond_mol=bond_mol)
    assert got.dtype == torch.int64 and got.shape == (n_frames, 3, 2,
                                                      n_types)
    assert torch.equal(got, want)
    # total is the plain variant's output; class 2 is in neither leaflet
    assert torch.equal(got[:, 0], _call(kernel_fn, kind, pb))
    assert (got[:, 1, 1] + got[:, 2, 1] < got[:, 0, 1]).any()
    assert not got[-1].any()


def test_kernel_rejects_wrong_dtype(cuda):
    pb = _problem(1, 4, 50, 30, 3, cuda)
    pk, gp, vl, base, inv = pb["b7"]
    with pytest.raises(TypeError):
        p2.p2_b7(pk.to(torch.int16), gp, vl, base, inv, pb["box"],
                 pb["normal"], pb["mask"], pb["bond_type"], pb["n_types"],
                 handle_pbc=True)


def _escape_wire(seed, gaps, n_bonds, dev):
    """A b7 wire of random bytes (every code position of the 7-byte
    groups) with the escape gaps `gaps` (B, cap) as given, random escape
    values and a random base."""
    rng = np.random.default_rng(seed)
    gaps = np.asarray(gaps, np.uint16)
    n_frames, cap = gaps.shape
    pk = rng.integers(0, 256, (n_frames, (3 * n_bonds + 7) // 8 * 7),
                      np.uint8)
    vl = rng.integers(-32768, 32767, (n_frames, cap), np.int16)
    base = rng.integers(-200, 200, 3 * n_bonds).astype(np.int32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return t(pk), t(gaps.view(np.int16)), t(vl), t(base)


#: escape gap patterns (B, cap) and the bonds they are laid over: those of
#: tests/test_torch_wire.py test_b7_residuals_random_payload (gaps above
#: 2^15, a padding gap mid-row, positions past the end) on 3N = 40,002
#: values; zero gaps in mid-stream; escapes at value 0 and at value nv − 1;
#: positions past nv, one of them right at nv
ESCAPES = {
    "random_payload": ([[40_000, 7, 1], [1, 65_535, 0], [0, 0, 0],
                        [39_999, 3, 5], [20_000, 20_000, 10]], 13_334),
    "zero_gaps_mid_stream": ([[5, 0, 0, 3, 0, 2, 0, 100],
                              [0, 0, 1, 0, 1, 0, 0, 7],
                              [64, 0, 64, 0, 0, 0, 64, 0]], 301),
    "first_and_last_value": ([[1, 902, 0], [1, 0, 902], [903, 0, 0]], 301),
    "past_the_end": ([[901, 1, 1, 1, 1], [904, 1, 0, 0, 0],
                      [300, 603, 1, 60_000, 2]], 301),
}


@pytest.mark.parametrize("layout", ["random", 32])
@pytest.mark.parametrize("case", list(ESCAPES))
def test_b7_escapes_match_plain(cuda, case, layout):
    """The kernel's own unpack of the packed wire against `b7_residuals`
    (the plain version) in int64: every escape applied where its gap puts
    it, a gap of 0 overriding nothing, a position >= nv dropped."""
    gaps, n_bonds = ESCAPES[case]
    pk, gp, vl, base = _escape_wire(len(case), gaps, n_bonds, cuda)
    n_frames = pk.shape[0]
    rng = np.random.default_rng(3)
    bond_type = torch.as_tensor(
        (rng.integers(0, 7, n_bonds) if layout == "random"
         else (np.arange(n_bonds) // layout) % 7).astype(np.int32),
        device=cuda)
    frame = (torch.full((n_frames,), 1e-3, device=cuda),
             torch.full((n_frames, 3), 5.0, device=cuda),
             torch.tensor([0.0, 0.0, 1.0], device=cuda),
             torch.ones(n_frames, dtype=torch.bool, device=cuda), bond_type,
             7)
    before = p2.p2_launches
    got = p2.p2_b7(pk, gp, vl, base, *frame, handle_pbc=True)
    torch.cuda.synchronize()
    assert p2.p2_launches == before + 1
    assert torch.equal(got, p2.p2_b7_plain(pk, gp, vl, base, *frame,
                                           handle_pbc=True))
    assert int(got[:, 1].sum()) == n_frames * n_bonds


def _ua_case(seed, n_frames, n_mols, n_types, dev, layout="mixed"):
    import chip_smoke
    from gorder_tpu_torch.core.ua import make_ua_step

    pb = chip_smoke.ua_problem(seed, n_frames, n_mols, n_types,
                               type_major=layout == "type_major")
    step = make_ua_step(pb["categories"], pb["bond_type"], pb["bond_mol"],
                        n_types, handle_pbc=True, device=dev)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    frame = (t(pb["box"]), t(np.array([0.0, 0.0, 1.0], np.float32)),
             t(pb["mask"]), step.indices, step.bond_type, n_types)
    inputs = {"i16": (t(pb["q16"]), t(pb["inv16"])),
              "f32": (t(pb["coords"]), None)}
    return step, frame, inputs


@pytest.mark.parametrize("layout", UA_LAYOUTS)
@pytest.mark.parametrize("kind", ["i16", "f32"])
@pytest.mark.parametrize("handle_pbc", [True, False])
@pytest.mark.parametrize("shape", [
    (6, 37, 7),                # ragged single tile per category
    (64, 900, 68),             # several blocks a frame, the UA type count
    (300, 100, 68),            # a block a frame: stored, then added
    (4, 60, 4000),             # T too large for shared memory: global path
])
def test_ua_kernel_matches_plain(cuda, kind, handle_pbc, shape, layout):
    from gorder_tpu_torch.ops import ua

    step, frame, inputs = _ua_case(sum(shape), *shape, cuda, layout)
    coords, scale = inputs[kind]
    before = ua.ua_launches
    got = ua.ua_positions(coords, scale, *frame, handle_pbc=handle_pbc,
                          layout=step.layout)
    torch.cuda.synchronize()
    assert ua.ua_launches == before + 4          # one per category
    want = ua.ua_positions_plain(coords, scale, *frame,
                                 handle_pbc=handle_pbc, layout=step.layout)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)
    assert not got[-2:].any()           # the masked frames stay zero
    assert got[:-2, 1].sum() == 11 * shape[1] * (shape[0] - 2)


@pytest.mark.parametrize("layout", UA_LAYOUTS)
@pytest.mark.parametrize("kind", ["i16", "f32"])
@pytest.mark.parametrize("shape", [
    (6, 37, 7),                # ragged single tile per category
    (64, 900, 68),             # several blocks a frame, the UA type count
    (300, 100, 68),            # a block a frame: stored, then added
    (4, 60, 1024),             # (3, 2, T) fills the 48 KiB exactly
    (4, 60, 1025),             # one type more: global atomics
])
def test_ua_leaflet_kernel_matches_plain(cuda, kind, shape, layout):
    from gorder_tpu_torch.core.ua import make_ua_step
    from gorder_tpu_torch.ops import ua

    import chip_smoke

    n_frames, n_mols, n_types = shape
    pb = chip_smoke.ua_problem(sum(shape), n_frames, n_mols, n_types,
                               type_major=layout == "type_major")
    step = make_ua_step(pb["categories"], pb["bond_type"], pb["bond_mol"],
                        n_types, handle_pbc=True, device=cuda,
                        with_leaflets=True)
    coords = {"i16": torch.as_tensor(pb["q16"], device=cuda),
              "f32": torch.as_tensor(pb["coords"], device=cuda)}[kind]
    scale = (torch.as_tensor(pb["inv16"], device=cuda) if kind == "i16"
             else None)
    box = torch.as_tensor(pb["box"], device=cuda)
    normal = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    mask = torch.as_tensor(pb["mask"], device=cuda)
    classes = torch.as_tensor(pb["classes"], device=cuda)
    before = ua.ua_leaflets_launches, ua.ua_launches
    got = step.positions(coords, box, normal, mask, inv_scale=scale,
                         classes=classes)
    torch.cuda.synchronize()
    assert (ua.ua_leaflets_launches, ua.ua_launches) == (before[0] + 4,
                                                         before[1])
    want = ua.ua_positions_plain(coords, scale, box, normal, mask,
                                 step.indices, step.bond_type, n_types,
                                 handle_pbc=True, layout=step.layout,
                                 classes=classes, bond_mol=step.bond_mol)
    assert got.shape == (n_frames, 3, 2, n_types)
    assert torch.equal(got, want)
    # classes are 0 or 1 here: upper + lower == total
    assert torch.equal(got[:, 1] + got[:, 2], got[:, 0])
    assert not got[-2:].any()


def test_ua_kernel_rejects_wrong_dtype(cuda):
    """int16 and int32 integers are taken (the i16, i12, s6 and d8 wires),
    int64 is not."""
    from gorder_tpu_torch.ops import ua

    step, frame, inputs = _ua_case(2, 4, 10, 7, cuda)
    coords, scale = inputs["i16"]
    with pytest.raises(TypeError):
        ua.ua_positions(coords.to(torch.int64), scale, *frame,
                        handle_pbc=True, layout=step.layout)


def _normals(seed, n_frames, n_mols, dev):
    """Per-molecule normals that are not unit: the kernel divides by
    |n|², as the JAX kernels do; one molecule's normal is zero."""
    rng = np.random.default_rng(seed)
    normals = rng.normal(0, 1, (n_frames, n_mols, 3)).astype(np.float32)
    normals *= rng.uniform(0.5, 2.0, (n_frames, n_mols, 1)).astype(
        np.float32)
    normals[:, 0] = 0.0
    return torch.as_tensor(normals, device=dev)


P2_COUNTS = ("p2_launches", "p2_leaflets_launches", "p2_i16_leaflets_launches",
             "p2_f32_leaflets_launches", "p2_normals_launches",
             "p2_i16_normals_launches", "p2_f32_normals_launches")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("leaflets", [False, True])
@pytest.mark.parametrize("kind", ["b7", "i16", "f32"])
@pytest.mark.parametrize("shape", [
    (8, 300, 200, 7, 5),       # ragged single tile
    (64, 5000, 3000, 80, 40),  # several blocks a frame, AA-like type count
    (4, 700, 400, 1025, 9),    # (3, 2, T) past the 48 KiB: global atomics
])
def test_normals_kernel_matches_plain(cuda, kind, shape, leaflets, layout):
    """The per_bond_normal variant, with and without classes: a launch
    with both counts as a normals launch of its input."""
    n_frames, n_bonds, n_atoms, n_types, n_mols = shape
    pb = _problem(sum(shape), n_frames, n_bonds, n_atoms, n_types, cuda,
                  layout)
    classes, bond_mol = _leaflets(sum(shape), n_frames, n_bonds, n_mols,
                                  cuda)
    classes = classes if leaflets else None
    normals = _normals(sum(shape), n_frames, n_mols, cuda)
    kernel_fn = p2.p2_b7 if kind == "b7" else p2.p2_positions
    plain_fn = p2.p2_b7_plain if kind == "b7" \
        else p2.p2_positions_plain
    c = (pb["box"], normals, pb["mask"], pb["bond_type"], pb["n_types"])
    before = {name: getattr(p2, name) for name in P2_COUNTS}
    got = kernel_fn(*pb[kind], *c, handle_pbc=True, classes=classes,
                    bond_mol=bond_mol)
    torch.cuda.synchronize()
    grown = {"b7": "p2_normals_launches",
             "i16": "p2_i16_normals_launches",
             "f32": "p2_f32_normals_launches"}[kind]
    assert {name: getattr(p2, name) - before[name] for name in P2_COUNTS} \
        == {name: int(name == grown) for name in P2_COUNTS}
    want = plain_fn(*pb[kind], *c, handle_pbc=True, classes=classes,
                    bond_mol=bond_mol)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)
    assert not got[-1].any()


@pytest.mark.parametrize("kind", ["b7", "i16", "f32"])
def test_normals_kernel_z_plane_equals_static(cuda, kind):
    """(B, M, 3) normals that are all (0, 0, 1) give the static kernel's
    integers bit for bit."""
    pb = _problem(5, 16, 2000, 900, 40, cuda)
    _, bond_mol = _leaflets(5, 16, 2000, 30, cuda)
    plane = pb["normal"].expand(16, 30, 3).contiguous()
    kernel_fn = p2.p2_b7 if kind == "b7" else p2.p2_positions
    got = kernel_fn(*pb[kind], pb["box"], plane, pb["mask"],
                    pb["bond_type"], pb["n_types"], handle_pbc=True,
                    bond_mol=bond_mol)
    assert torch.equal(got, _call(kernel_fn, kind, pb))


def test_normals_kernel_rejects_wrong_shape(cuda):
    pb = _problem(3, 4, 50, 30, 3, cuda)
    _, bond_mol = _leaflets(3, 4, 50, 6, cuda)
    for bad in (torch.zeros(4, 6, 2, device=cuda),
                torch.zeros(3, 6, 3, device=cuda)):
        with pytest.raises(ValueError):
            p2.p2_b7(*pb["b7"], pb["box"], bad, pb["mask"],
                     pb["bond_type"], pb["n_types"], handle_pbc=True,
                     bond_mol=bond_mol)


@pytest.mark.parametrize("layout", UA_LAYOUTS)
@pytest.mark.parametrize("leaflets", [False, True])
@pytest.mark.parametrize("kind", ["i16", "f32"])
@pytest.mark.parametrize("shape", [
    (6, 37, 7),                # ragged single tile per category
    (64, 900, 68),             # several blocks a frame, the UA type count
    (4, 60, 1025),             # (3, 2, T) past the 48 KiB: global atomics
])
def test_ua_normals_kernel_matches_plain(cuda, kind, shape, leaflets,
                                         layout):
    from gorder_tpu_torch.core.ua import make_ua_step
    from gorder_tpu_torch.ops import ua

    import chip_smoke

    n_frames, n_mols, n_types = shape
    pb = chip_smoke.ua_problem(sum(shape), n_frames, n_mols, n_types,
                               type_major=layout == "type_major")
    step = make_ua_step(pb["categories"], pb["bond_type"], pb["bond_mol"],
                        n_types, handle_pbc=True, device=cuda,
                        with_leaflets=leaflets, normal_mode="per_molecule")
    coords = {"i16": torch.as_tensor(pb["q16"], device=cuda),
              "f32": torch.as_tensor(pb["coords"], device=cuda)}[kind]
    scale = (torch.as_tensor(pb["inv16"], device=cuda) if kind == "i16"
             else None)
    box = torch.as_tensor(pb["box"], device=cuda)
    normals = _normals(sum(shape), n_frames, n_mols, cuda)
    mask = torch.as_tensor(pb["mask"], device=cuda)
    classes = (torch.as_tensor(pb["classes"], device=cuda) if leaflets
               else None)
    before = (ua.ua_normals_launches, ua.ua_leaflets_launches,
              ua.ua_launches)
    got = step.positions(coords, box, normals, mask, inv_scale=scale,
                         classes=classes)
    torch.cuda.synchronize()
    assert (ua.ua_normals_launches, ua.ua_leaflets_launches,
            ua.ua_launches) == (before[0] + 4, before[1], before[2])
    want = ua.ua_positions_plain(coords, scale, box, normals, mask,
                                 step.indices, step.bond_type, n_types,
                                 handle_pbc=True, layout=step.layout,
                                 classes=classes, bond_mol=step.bond_mol)
    assert torch.equal(got, want)
    assert not got[-2:].any()


@pytest.mark.parametrize("kind", ["i16", "f32"])
def test_ua_normals_kernel_z_plane_equals_static(cuda, kind):
    from gorder_tpu_torch.core.ua import make_ua_step

    import chip_smoke

    pb = chip_smoke.ua_problem(9, 8, 50, 7)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=cuda)

    coords, scale = {"i16": (t(pb["q16"]), t(pb["inv16"])),
                     "f32": (t(pb["coords"]), None)}[kind]
    z = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    out = {}
    for mode, normal in (("static", z),
                         ("per_molecule", z.expand(8, 50, 3).contiguous())):
        step = make_ua_step(pb["categories"], pb["bond_type"],
                            pb["bond_mol"], 7, device=cuda,
                            normal_mode=mode)
        out[mode] = step.positions(coords, t(pb["box"]), normal,
                                   t(pb["mask"]), inv_scale=scale)
    assert torch.equal(out["per_molecule"], out["static"])


def _map_spec(bin_size=0.1, plane="xy"):
    """A manual 4 x 4 nm grid: `_problem`'s midpoints spread over about
    12 nm, so many of them fall outside it, into the dump."""
    from gorder_tpu_torch.core.ordermap import build_map_spec
    from gorder_tpu_torch.input.config import GridSpan, OrderMapParams

    return build_map_spec(OrderMapParams(
        bin_size=(bin_size, bin_size), plane=plane,
        dim=(GridSpan.manual(0.0, 4.0), GridSpan.manual(-0.5, 3.5))), None)


MAP_COUNTS = P2_COUNTS + ("p2_i16_pair_launches", "p2_i16_map_launches",
                          "p2_f32_map_launches")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("leaflets", [False, True])
@pytest.mark.parametrize("kind", ["i16", "f32"])
@pytest.mark.parametrize("shape", [
    (8, 300, 200, 7, 5),       # ragged single tile
    (64, 5000, 3000, 80, 40),  # several blocks a frame, AA-like type count
    (4, 700, 400, 1025, 9),    # (3, 2, T) past the 48 KiB: global atomics
])
def test_map_kernel_matches_plain(cuda, kind, shape, leaflets, normals,
                                  layout):
    """The map output of the positions inputs (pair_quantized int16, f32),
    with and without classes and per-molecule normals: the type sums and
    a freshly zeroed map state equal the plain version's in int64, and a
    launch counts as a map launch of its input only."""
    from gorder_tpu_torch.core.ordermap import init_map_state

    n_frames, n_bonds, n_atoms, n_types, n_mols = shape
    pb = _problem(sum(shape), n_frames, n_bonds, n_atoms, n_types, cuda,
                  layout)
    classes, bond_mol = _leaflets(sum(shape), n_frames, n_bonds, n_mols,
                                  cuda)
    classes = classes if leaflets else None
    normal = (_normals(sum(shape), n_frames, n_mols, cuda) if normals
              else pb["normal"])
    kw = dict(handle_pbc=True, classes=classes,
              bond_mol=bond_mol if leaflets or normals else None,
              pair=True, map_spec=_map_spec())
    c = (pb["box"], normal, pb["mask"], pb["bond_type"], pb["n_types"])
    states = [init_map_state(3 if leaflets else 1, n_types, kw["map_spec"],
                             cuda) for _ in range(2)]
    before = {name: getattr(p2, name) for name in MAP_COUNTS}
    got = p2.p2_positions(*pb[kind], *c, map_state=states[0], **kw)
    torch.cuda.synchronize()
    grown = f"p2_{kind}_map_launches"
    assert {name: getattr(p2, name) - before[name] for name in MAP_COUNTS} \
        == {name: int(name == grown) for name in MAP_COUNTS}
    want = p2.p2_positions_plain(*pb[kind], *c, map_state=states[1], **kw)
    assert torch.equal(got, want)
    assert torch.equal(states[0], states[1])
    # every counted sample is in the map once per class, the dump included
    sums = got if leaflets else got[:, None]
    assert torch.equal(states[0].sum(-1), sums.sum((0, 3)))
    assert states[0][:, 1, -1].sum() > 0 and states[0][:, 1, :-1].sum() > 0


@pytest.mark.parametrize("kind", ["b7", "i16", "f32"])
def test_map_table_dump_takes_the_samples_outside(cuda, kind):
    """MapTable: the samples whose midpoint lies outside the grid go to
    the dump entry, which the plain version's map_cells gives; the b7
    wire and the single-rounding int16 input take no map."""
    from gorder_tpu_torch.core.order import position_vectors
    from gorder_tpu_torch.core.ordermap import init_map_state, map_cells
    from gorder_tpu_torch.core.pbc import min_image

    pb = _problem(11, 16, 4000, 2000, 30, cuda)
    spec = _map_spec(plane="yz")
    state = init_map_state(1, 30, spec, cuda)
    c = (pb["box"], pb["normal"], pb["mask"], pb["bond_type"], 30)
    if kind == "b7":
        with pytest.raises(TypeError):      # p2_b7 takes no map
            p2.p2_b7(*pb["b7"], *c, handle_pbc=True, map_spec=spec,
                     map_state=state)
        with pytest.raises(ValueError, match="pair"):
            p2.p2_positions(*pb["i16"], *c, handle_pbc=True, map_spec=spec,
                            map_state=state)
        return
    p2.p2_positions(*pb[kind], *c, handle_pbc=True, pair=True,
                    map_spec=spec, map_state=state)
    coords, atom_a, atom_b, inv = pb[kind]
    d, pa = position_vectors(coords, atom_a, atom_b, inv, pair=True)
    d = min_image(d, pb["box"][:, None, :])
    cells, inside = map_cells(pa + d * 0.5, spec, pb["bond_type"], 30)
    valid = pb["mask"][:, None]
    assert int(state[0, 1, -1]) == int((~inside & valid).sum()) > 0
    assert int(state[0, 1, :-1].sum()) == int((inside & valid).sum()) > 0
    with pytest.raises(ValueError):         # a state of the wrong shape
        p2.p2_positions(*pb[kind], *c, handle_pbc=True, pair=True,
                        map_spec=spec, map_state=state[:, :, :-1])


@pytest.mark.parametrize("kind", ["b7", "i16"])
def test_pair_kernel_matches_plain(cuda, kind):
    """pair_quantized without a map: its own count, the plain version's
    integers; `b7` checks the b7 input against the single rounding on
    the same batch (the two formulations differ in some sample)."""
    pb = _problem(13, 32, 5000, 3000, 40, cuda)
    c = (pb["box"], pb["normal"], pb["mask"], pb["bond_type"], 40)
    if kind == "b7":
        single = p2.p2_positions(*pb["i16"], *c, handle_pbc=True)
        assert torch.equal(single, p2.p2_b7(*pb["b7"], *c,
                                            handle_pbc=True))
        pair = p2.p2_positions(*pb["i16"], *c, handle_pbc=True, pair=True)
        assert torch.equal(pair[:, 1], single[:, 1])
        return
    before = {name: getattr(p2, name) for name in MAP_COUNTS}
    got = p2.p2_positions(*pb["i16"], *c, handle_pbc=True, pair=True)
    torch.cuda.synchronize()
    assert {name: getattr(p2, name) - before[name] for name in MAP_COUNTS} \
        == {name: int(name == "p2_i16_pair_launches") for name in MAP_COUNTS}
    assert torch.equal(got, p2.p2_positions_plain(*pb["i16"], *c,
                                                  handle_pbc=True, pair=True))


@pytest.mark.parametrize("layout", UA_LAYOUTS)
@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("leaflets", [False, True])
@pytest.mark.parametrize("kind", ["i16", "f32"])
@pytest.mark.parametrize("shape", [
    (6, 37, 7),                # ragged single tile per category
    (64, 900, 68),             # several blocks a frame, the UA type count
    (4, 60, 1025),             # (3, 2, T) past the 48 KiB: global atomics
])
def test_ua_map_kernel_matches_plain(cuda, kind, shape, leaflets, normals,
                                     layout):
    from gorder_tpu_torch.core.ordermap import init_map_state
    from gorder_tpu_torch.core.ua import make_ua_step
    from gorder_tpu_torch.ops import ua

    import chip_smoke

    n_frames, n_mols, n_types = shape
    pb = chip_smoke.ua_problem(sum(shape), n_frames, n_mols, n_types,
                               type_major=layout == "type_major")
    spec = _map_spec(plane="xz")
    step = make_ua_step(pb["categories"], pb["bond_type"], pb["bond_mol"],
                        n_types, handle_pbc=True, device=cuda,
                        with_leaflets=leaflets,
                        normal_mode="per_molecule" if normals else "static",
                        map_spec=spec)
    coords = {"i16": torch.as_tensor(pb["q16"], device=cuda),
              "f32": torch.as_tensor(pb["coords"], device=cuda)}[kind]
    scale = (torch.as_tensor(pb["inv16"], device=cuda) if kind == "i16"
             else None)
    box = torch.as_tensor(pb["box"], device=cuda)
    normal = (_normals(sum(shape), n_frames, n_mols, cuda) if normals
              else torch.tensor([0.0, 0.0, 1.0], device=cuda))
    mask = torch.as_tensor(pb["mask"], device=cuda)
    classes = (torch.as_tensor(pb["classes"], device=cuda) if leaflets
               else None)
    states = [init_map_state(3 if leaflets else 1, n_types, spec, cuda)
              for _ in range(2)]
    counts = ("ua_launches", "ua_leaflets_launches", "ua_normals_launches",
              "ua_map_launches")
    before = {name: getattr(ua, name) for name in counts}
    got = step.positions(coords, box, normal, mask, inv_scale=scale,
                         classes=classes, map_state=states[0])
    torch.cuda.synchronize()
    assert {name: getattr(ua, name) - before[name] for name in counts} == {
        name: 4 * int(name == "ua_map_launches") for name in counts}
    want = ua.ua_positions_plain(coords, scale, box, normal, mask,
                                 step.indices, step.bond_type, n_types,
                                 handle_pbc=True, layout=step.layout,
                                 classes=classes, bond_mol=step.bond_mol,
                                 map_spec=spec, map_state=states[1])
    assert torch.equal(got, want)
    assert torch.equal(states[0], states[1])
    sums = got if leaflets else got[:, None]
    assert torch.equal(states[0].sum(-1), sums.sum((0, 3)))
    assert states[0][:, 1, -1].sum() > 0 and states[0][:, 1, :-1].sum() > 0


GEOM_COUNTS = MAP_COUNTS + ("p2_geom_launches", "p2_i16_geom_launches",
                            "p2_i16_pair_geom_launches",
                            "p2_f32_geom_launches")


def _bitplane(seed, n_frames, n_bonds, dev):
    """A seeded (B, ⌈N/8⌉) geometry bitplane with about 60 % of the bonds
    inside (about half the lanes of a warp out); the spare bits of the
    last byte set, which no bond reads."""
    from gorder_tpu_torch.engine.wire import pack_geo_bits

    rng = np.random.default_rng(seed)
    inside = torch.as_tensor(rng.random((n_frames, n_bonds)) < 0.6)
    geo = pack_geo_bits(inside)
    if n_bonds % 8:
        geo[:, -1] |= (0xFF << (n_bonds % 8)) & 0xFF
    return geo.to(dev)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("leaflets", [False, True])
@pytest.mark.parametrize("kind", ["b7", "i16", "i16_pair", "f32"])
@pytest.mark.parametrize("shape", [
    (8, 301, 200, 7, 5),       # ragged single tile, a ragged last byte
    (64, 5000, 3000, 80, 40),  # several blocks a frame, AA-like type count
])
def test_geom_kernel_matches_plain(cuda, kind, shape, leaflets, normals,
                                   layout):
    """with_geom: every input, with and without classes and per-molecule
    normals (the pair and f32 inputs with a map): a bond whose bit is 0
    adds nothing; the int64 outputs and the map equal the plain version's
    and a launch counts in the with_geom count of its input only."""
    from gorder_tpu_torch.core.ordermap import init_map_state

    n_frames, n_bonds, n_atoms, n_types, n_mols = shape
    pb = _problem(sum(shape), n_frames, n_bonds, n_atoms, n_types, cuda,
                  layout)
    classes, bond_mol = _leaflets(sum(shape), n_frames, n_bonds, n_mols,
                                  cuda)
    geo = _bitplane(sum(shape), n_frames, n_bonds, cuda)
    normal = (_normals(sum(shape), n_frames, n_mols, cuda) if normals
              else pb["normal"])
    c = (pb["box"], normal, pb["mask"], pb["bond_type"], pb["n_types"])
    kw = dict(handle_pbc=True, classes=classes if leaflets else None,
              bond_mol=bond_mol if leaflets or normals else None, geo=geo)
    if kind == "b7":
        kernel_fn, plain_fn, args = p2.p2_b7, p2.p2_b7_plain, pb["b7"]
    else:
        kernel_fn, plain_fn = p2.p2_positions, p2.p2_positions_plain
        args = pb["i16" if kind.startswith("i16") else "f32"]
    states = [None, None]
    if kind in ("i16_pair", "f32"):
        spec = _map_spec()
        states = [init_map_state(3 if leaflets else 1, n_types, spec, cuda)
                  for _ in range(2)]
        kw.update(pair=True, map_spec=spec)
    before = {name: getattr(p2, name) for name in GEOM_COUNTS}
    got = kernel_fn(*args, *c, map_state=states[0], **kw) \
        if states[0] is not None else kernel_fn(*args, *c, **kw)
    torch.cuda.synchronize()
    grown = {"b7": "p2_geom_launches", "i16": "p2_i16_geom_launches",
             "i16_pair": "p2_i16_pair_geom_launches",
             "f32": "p2_f32_geom_launches"}[kind]
    assert {name: getattr(p2, name) - before[name] for name in GEOM_COUNTS} \
        == {name: int(name == grown) for name in GEOM_COUNTS}
    want = plain_fn(*args, *c, map_state=states[1], **kw) \
        if states[1] is not None else plain_fn(*args, *c, **kw)
    assert torch.equal(got, want)
    if states[0] is not None:
        assert torch.equal(states[0], states[1])
    # the samples outside count nowhere: fewer than without the bitplane
    total = got[:, 0] if leaflets else got
    assert 0 < int(total[:, 1].sum()) < int((n_frames - 1) * n_bonds)
    assert not got[-1].any()


@pytest.mark.parametrize("layout", UA_LAYOUTS)
@pytest.mark.parametrize("pbc", [True, False])
@pytest.mark.parametrize("kind", ["i16", "f32"])
@pytest.mark.parametrize("shape", ["cuboid", "cylinder", "sphere"])
def test_ua_geom_kernel_matches_plain(cuda, kind, shape, pbc, layout):
    """The UA kernel's inside test against the plain version, for each
    shape (the sphere inverted), with a selection's per-frame center as the
    reference; with classes, per-molecule normals and a map too. Every
    launch counts in the geometry count."""
    from gorder_tpu_torch.core.geometry import GeometrySpec
    from gorder_tpu_torch.core.ordermap import init_map_state
    from gorder_tpu_torch.core.ua import make_ua_step
    from gorder_tpu_torch.ops import ua

    import chip_smoke

    spec = {"cuboid": GeometrySpec("cuboid", xdim=(-1.5, 1.0),
                                   zdim=(-2.0, 0.5)),
            "cylinder": GeometrySpec("cylinder", radius=1.7,
                                     span=(-1.0, 2.0), orientation=1),
            "sphere": GeometrySpec("sphere", radius=2.2, invert=True)}[shape]
    pb = chip_smoke.ua_problem(7, 32, 400, 68,
                               type_major=layout == "type_major")
    counts = ("ua_launches", "ua_leaflets_launches", "ua_normals_launches",
              "ua_map_launches", "ua_geom_launches")
    selection = torch.arange(0, 400 * 10, 37, dtype=torch.int32,
                             device=cuda)
    for extra in ("alone", "classes, normals and map"):
        full = extra != "alone"
        step = make_ua_step(pb["categories"], pb["bond_type"],
                            pb["bond_mol"], 68, handle_pbc=pbc, device=cuda,
                            with_leaflets=full,
                            normal_mode="per_molecule" if full else "static",
                            map_spec=_map_spec(plane="xz") if full else None,
                            geom_spec=spec)
        coords = {"i16": torch.as_tensor(pb["q16"], device=cuda),
                  "f32": torch.as_tensor(pb["coords"], device=cuda)}[kind]
        scale = (torch.as_tensor(pb["inv16"], device=cuda) if kind == "i16"
                 else None)
        box = torch.as_tensor(pb["box"], device=cuda)
        normal = (_normals(3, 32, 400, cuda) if full
                  else torch.tensor([0.0, 0.0, 1.0], device=cuda))
        mask = torch.as_tensor(pb["mask"], device=cuda)
        classes = (torch.as_tensor(pb["classes"], device=cuda) if full
                   else None)
        states = [init_map_state(3, 68, step.map_spec, cuda) if full
                  else None for _ in range(2)]
        before = {name: getattr(ua, name) for name in counts}
        got = step.positions(coords, box, normal, mask, inv_scale=scale,
                             classes=classes, map_state=states[0],
                             geom_ref=selection)
        torch.cuda.synchronize()
        assert {name: getattr(ua, name) - before[name] for name in counts} \
            == {name: 4 * int(name == "ua_geom_launches") for name in counts}
        coords_f = (coords if scale is None
                    else coords.to(torch.float32) * scale[:, None, None])
        from gorder_tpu_torch.core.order import geometry_reference

        reference = geometry_reference(coords_f, box, selection, pbc)
        want = ua.ua_positions_plain(coords, scale, box, normal, mask,
                                     step.indices, step.bond_type, 68,
                                     handle_pbc=pbc, layout=step.layout,
                                     classes=classes, bond_mol=step.bond_mol,
                                     map_spec=step.map_spec,
                                     map_state=states[1], geom_spec=spec,
                                     reference=reference)
        assert torch.equal(got, want), extra
        if full:
            assert torch.equal(states[0], states[1])
        n_in = int((got[:, 0] if full else got)[:, 1].sum())
        assert 0 < n_in < 30 * 400 * 11


#: every P2 launch count an int32 launch may touch
I32_COUNTS = GEOM_COUNTS + ("p2_i32_launches", "p2_i32_leaflets_launches",
                            "p2_i32_normals_launches", "p2_i32_geom_launches",
                            "p2_i32_pair_launches", "p2_i32_map_launches",
                            "p2_i32_pair_geom_launches")
#: int32 variants: (classes, normals, bitplane, pair, map) → the count
I32_VARIANTS = {
    "plain": ((), "p2_i32_launches"),
    "leaflets": (("classes",), "p2_i32_leaflets_launches"),
    "normals": (("normals",), "p2_i32_normals_launches"),
    "leaflets_normals": (("classes", "normals"), "p2_i32_normals_launches"),
    "geom_leaflets_normals": (("classes", "normals", "geo"),
                              "p2_i32_geom_launches"),
    "pair": (("pair",), "p2_i32_pair_launches"),
    "pair_map_leaflets_normals": (("pair", "map", "classes", "normals"),
                                  "p2_i32_map_launches"),
    "pair_map_geom": (("pair", "map", "geo"), "p2_i32_pair_geom_launches"),
}


@pytest.mark.parametrize("layout", ["random", 32])
@pytest.mark.parametrize("variant", list(I32_VARIANTS))
@pytest.mark.parametrize("shape", [
    (8, 301, 200, 7, 5),       # ragged single tile, a ragged last byte
    (64, 5000, 3000, 80, 40),  # several blocks a frame, AA-like type count
])
def test_int32_kernel_matches_plain(cuda, variant, shape, layout):
    """`p2_positions_i32` and `p2_positions_i32_pair`: int32 XTC integers
    moved 35 nm along z, past int16's range, with every option; the
    int64 outputs and the map equal the plain version's, a launch counts
    in its variant's int32 count only, and the single difference gives
    the int16 kernel's sums on the unmoved integers (the differences are
    the same)."""
    from gorder_tpu_torch.core.ordermap import init_map_state

    n_frames, n_bonds, n_atoms, n_types, n_mols = shape
    options, grown = I32_VARIANTS[variant]
    pb = _problem(sum(shape), n_frames, n_bonds, n_atoms, n_types, cuda,
                  layout)
    q16, atom_a, atom_b, inv = pb["i16"]
    q32 = q16.to(torch.int32)
    q32[..., 2] += 35_000
    classes, bond_mol = _leaflets(sum(shape), n_frames, n_bonds, n_mols,
                                  cuda)
    normal = (_normals(sum(shape), n_frames, n_mols, cuda)
              if "normals" in options else pb["normal"])
    kw = dict(handle_pbc=True,
              classes=classes if "classes" in options else None,
              bond_mol=(bond_mol if {"classes", "normals"} & set(options)
                        else None),
              geo=(_bitplane(sum(shape), n_frames, n_bonds, cuda)
                   if "geo" in options else None),
              pair="pair" in options)
    c = (pb["box"], normal, pb["mask"], pb["bond_type"], pb["n_types"])
    states = [None, None]
    if "map" in options:
        kw["map_spec"] = _map_spec()
        states = [init_map_state(3 if "classes" in options else 1, n_types,
                                 kw["map_spec"], cuda) for _ in range(2)]
    before = {name: getattr(p2, name) for name in I32_COUNTS}
    got = p2.p2_positions(q32, atom_a, atom_b, inv, *c,
                          map_state=states[0], **kw)
    torch.cuda.synchronize()
    assert {name: getattr(p2, name) - before[name] for name in I32_COUNTS} \
        == {name: int(name == grown) for name in I32_COUNTS}
    want = p2.p2_positions_plain(q32, atom_a, atom_b, inv, *c,
                                 map_state=states[1], **kw)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    if states[0] is not None:
        assert torch.equal(states[0], states[1])
        sums = got if "classes" in options else got[:, None]
        assert torch.equal(states[0].sum(-1), sums.sum((0, 3)))
    if not kw["pair"]:
        assert torch.equal(got, p2.p2_positions(q16, atom_a, atom_b, inv,
                                                *c, **kw))
    assert not got[-1].any()


@pytest.mark.parametrize("variant", ["static", "leaflets_normals", "map",
                                     "geometry"])
@pytest.mark.parametrize("layout", UA_LAYOUTS)
def test_ua_int32_kernel_matches_plain(cuda, variant, layout):
    """`ua_positions_i32`: the UA problem's integers moved 35 nm along z,
    with each option; every launch counts in the int32 count only."""
    from gorder_tpu_torch.core.geometry import GeometrySpec
    from gorder_tpu_torch.core.order import geometry_reference
    from gorder_tpu_torch.core.ordermap import init_map_state
    from gorder_tpu_torch.core.ua import make_ua_step
    from gorder_tpu_torch.ops import ua

    import chip_smoke

    pb = chip_smoke.ua_problem(11, 32, 400, 68,
                               type_major=layout == "type_major")
    full = variant == "leaflets_normals"
    step = make_ua_step(
        pb["categories"], pb["bond_type"], pb["bond_mol"], 68,
        handle_pbc=True, device=cuda, with_leaflets=full,
        normal_mode="per_molecule" if full else "static",
        map_spec=_map_spec(plane="xy") if variant == "map" else None,
        geom_spec=(GeometrySpec("cylinder", radius=1.7, orientation=2)
                   if variant == "geometry" else None))
    q = torch.as_tensor(pb["q16"], device=cuda).to(torch.int32)
    q[..., 2] += 35_000
    scale = torch.as_tensor(pb["inv16"], device=cuda)
    box = torch.as_tensor(pb["box"], device=cuda)
    normal = (_normals(3, 32, 400, cuda) if full
              else torch.tensor([0.0, 0.0, 1.0], device=cuda))
    mask = torch.as_tensor(pb["mask"], device=cuda)
    classes = (torch.as_tensor(pb["classes"], device=cuda) if full
               else None)
    states = [init_map_state(1, 68, step.map_spec, cuda)
              if variant == "map" else None for _ in range(2)]
    selection = torch.arange(0, 4000, 37, dtype=torch.int32, device=cuda)
    counts = ("ua_launches", "ua_leaflets_launches", "ua_normals_launches",
              "ua_map_launches", "ua_geom_launches", "ua_i32_launches")
    before = {name: getattr(ua, name) for name in counts}
    got = step.positions(q, box, normal, mask, inv_scale=scale,
                         classes=classes, map_state=states[0],
                         geom_ref=selection if variant == "geometry"
                         else None)
    torch.cuda.synchronize()
    assert {name: getattr(ua, name) - before[name] for name in counts} \
        == {name: 4 * int(name == "ua_i32_launches") for name in counts}
    reference = None
    if variant == "geometry":
        reference = geometry_reference(q.to(torch.float32)
                                       * scale[:, None, None], box,
                                       selection, True)
    want = ua.ua_positions_plain(
        q, scale, box, normal, mask, step.indices, step.bond_type, 68,
        handle_pbc=True, layout=step.layout, classes=classes,
        bond_mol=step.bond_mol, map_spec=step.map_spec, map_state=states[1],
        geom_spec=step.geom_spec, reference=reference)
    assert torch.equal(got, want)
    if states[0] is not None:
        assert torch.equal(states[0], states[1])
    assert not got[-2:].any() and int(got[:, 1].sum() if got.dim() == 3
                                       else got[:, 0, 1].sum()) > 0


# ---------------------------------------------- dense neighbour passes
# csrc/neighbors.cu against ops/neighbors.py's plain versions: the cloud
# counts, the in-plane mask and so the classes equal; the covariances and
# the local sums, which the kernels add in f64 and torch in f32 in another
# order, within 1e-5 of the magnitudes they sum (for a covariance entry ab,
# Σ|e_a·e_b| ≤ (cov_aa + cov_bb) / 2); the normals, up to their sign,
# |n·n_plain| ≥ 1 − 1e-5, as tests/test_torch_normals.py holds them
# against gorder_tpu. Ragged head and atom counts, coordinates outside the
# box, and a batch at minimum-image ties, where the kernels divide; a
# second launch equals the first bit for bit.

#: the share of the summed magnitudes two f32 sums of the same terms may
#: differ by (tests/test_torch_neighbors.py SUM_BOUND)
SUM_BOUND = 1e-5


def _cloud_case(seed, dev, B=6, M=40, extra=0):
    """`_membrane_frames` on the card, with `extra` atoms scattered over
    the box appended to the cloud."""
    from .test_torch_normals import _membrane_frames

    coords, box, heads, cloud = _membrane_frames(seed, B=B, M=M)
    rng = np.random.default_rng(seed + 1)
    scattered = rng.uniform(0, box[0], (B, extra, 3)).astype(np.float32)
    coords = np.concatenate([coords, scattered], axis=1)
    cloud = np.concatenate([cloud, len(cloud) + np.arange(extra)])
    return (torch.as_tensor(coords, device=dev),
            torch.as_tensor(box, device=dev),
            torch.as_tensor(heads, device=dev),
            torch.as_tensor(cloud, device=dev))


def _same_cloud(got, want):
    (counts, cov), (want_counts, want_cov) = got, want
    assert counts.dtype == cov.dtype == torch.float32
    assert torch.equal(counts, want_counts)
    scale = (want_cov[..., [0, 0, 0, 3, 3, 5]]
             + want_cov[..., [0, 3, 5, 3, 5, 5]]) / 2
    assert bool(((cov - want_cov).abs() <= SUM_BOUND * scale + 1e-12).all())


@pytest.mark.parametrize("handle_pbc", [True, False])
@pytest.mark.parametrize("tile", [None, 64, 1, 8192])
def test_normal_cloud_kernel_matches_plain(cuda, monkeypatch, handle_pbc,
                                           tile):
    """Tiles of 64 and 1 atoms: the cloud goes through shared memory in
    several tiles, as a cloud over NORMAL_TILE atoms does; a tile of
    8,192 (128 KB) opts the kernel in past the default 48 KB."""
    from gorder_tpu_torch.core import normals as tn
    from gorder_tpu_torch.ops import neighbors

    from .test_torch_normals import _same_up_to_sign

    if tile is not None:
        monkeypatch.setattr(neighbors, "NORMAL_TILE", tile)
    coords, box, heads, cloud = _cloud_case(3, cuda)
    args = (coords, box, heads, cloud, 2.0, handle_pbc)
    before = neighbors.normals_launches
    got = neighbors.normal_cloud(*args)
    torch.cuda.synchronize()
    assert neighbors.normals_launches == before + 1
    _same_cloud(got, neighbors.normal_cloud_plain(*args))
    assert int(got[0].min()) >= 3
    normals, counts = tn.dynamic_normals(*args)
    want, want_counts = tn.dynamic_normals_plain(*args)
    assert torch.equal(counts, want_counts)
    _same_up_to_sign(normals.cpu().numpy(), want.cpu().numpy())


def test_normal_cloud_kernel_tiles_a_large_cloud(cuda):
    """A cloud of NORMAL_TILE + 2,000 atoms: two tiles."""
    from gorder_tpu_torch.ops import neighbors

    coords, box, heads, cloud = _cloud_case(
        5, cuda, B=3, M=20, extra=neighbors.NORMAL_TILE + 2000 - 120)
    assert len(cloud) > neighbors.NORMAL_TILE
    args = (coords, box, heads, cloud, 1.0, True)
    _same_cloud(neighbors.normal_cloud(*args),
                neighbors.normal_cloud_plain(*args))


@pytest.mark.parametrize("tile", [None, 16])
def test_normal_cloud_kernel_empty_cloud(cuda, monkeypatch, tile):
    """A head whose cloud is empty: count 0 and a zero covariance, and
    heads past the last whole block."""
    from gorder_tpu_torch.ops import neighbors

    if tile is not None:
        monkeypatch.setattr(neighbors, "NORMAL_TILE", tile)
    coords, box, heads, cloud = _cloud_case(7, cuda, B=2, M=150)
    args = (coords, box, heads, cloud[1:], 0.05, True)
    got = neighbors.normal_cloud(*args)
    _same_cloud(got, neighbors.normal_cloud_plain(*args))
    assert got[0].shape == (2, 300) and not got[0][:, 0].any()
    assert not got[1][:, 0].any()


@pytest.mark.parametrize("handle_pbc", [True, False])
@pytest.mark.parametrize("tile", [None, 32])
def test_local_sums_kernel_matches_plain(cuda, monkeypatch, handle_pbc,
                                         tile):
    """300 heads (ten blocks of 32, the last ragged) over 1,500 membrane
    atoms: tiles of LOCAL_TILE (the second ragged), or tiles of 32."""
    from gorder_tpu_torch.core import leaflets as tl
    from gorder_tpu_torch.ops import neighbors

    from .test_torch_leaflets import _membrane

    if tile is not None:
        monkeypatch.setattr(neighbors, "LOCAL_TILE", tile)
    centers = None if handle_pbc else np.full(6, 4.0)
    coords, box, membrane, heads, _, _ = _membrane(3, centers=centers,
                                                   M=300)
    coords, box = (torch.as_tensor(a, device=cuda) for a in (coords, box))
    membrane, heads = (torch.as_tensor(a, device=cuda)
                       for a in (membrane, heads))
    args = (coords, box, membrane, heads, 2, 2.0, handle_pbc)
    before = neighbors.local_launches
    got = neighbors.local_sums(*args)
    torch.cuda.synchronize()
    assert neighbors.local_launches == before + 1
    want = neighbors.local_sums_plain(*args)
    assert got.shape == want.shape == (6, 300, 2)
    # Σw·|v| ≤ count · max|v|: |cos θ|, |sin θ| ≤ 1, or |z| and 1
    d = coords[:, None, membrane, :2] - coords[:, heads, None, :2]
    if handle_pbc:
        d = d - box[:, None, None, :2] * torch.round(d / box[:, None, None,
                                                            :2])
    count = ((d * d).sum(-1) <= 4.0).sum(-1).to(torch.float32)
    z = 1.0 if handle_pbc else float(coords[:, membrane, 2].abs().max())
    magnitude = torch.stack([count * z, count], -1)
    assert bool(((got - want).abs() <= SUM_BOUND * magnitude + 1e-12).all())
    if not handle_pbc:
        assert torch.equal(got[..., 1], want[..., 1])
    local = tl.LocalClassifier(membrane.cpu(), heads.cpu(), 2, 2.0,
                               handle_pbc, device=cuda)
    assert torch.equal(local(coords, box), local.plain(coords, box))


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_normal_cloud_kernel_ragged_blocks(cuda, monkeypatch, handle_pbc):
    """150 heads, not a multiple of a block's 32, over 487 cloud atoms,
    not a multiple of the eight warps, in tiles of 64 (the last one
    ragged): equal to plain, and a second launch equals the first bit for
    bit."""
    from gorder_tpu_torch.ops import neighbors

    monkeypatch.setattr(neighbors, "NORMAL_TILE", 64)
    coords, box, heads, cloud = _cloud_case(11, cuda, B=4, M=75, extra=37)
    assert len(heads) == 150 and len(cloud) == 487
    args = (coords, box, heads, cloud, 2.0, handle_pbc)
    got = neighbors.normal_cloud(*args)
    again = neighbors.normal_cloud(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _same_cloud(got, neighbors.normal_cloud_plain(*args))


@pytest.mark.parametrize("handle_pbc", [True, False])
def test_local_sums_kernel_ragged_blocks(cuda, monkeypatch, handle_pbc):
    """150 heads, not a multiple of a block's 32, over 1,050 membrane
    atoms in tiles of 100 (the last one ragged, neither a multiple of the
    eight warps): equal to plain, the classes too, and a second launch
    equals the first bit for bit."""
    from gorder_tpu_torch.core import leaflets as tl
    from gorder_tpu_torch.ops import neighbors

    from .test_torch_leaflets import _membrane

    monkeypatch.setattr(neighbors, "LOCAL_TILE", 100)
    centers = None if handle_pbc else np.full(6, 4.0)
    coords, box, membrane, heads, _, _ = _membrane(5, centers=centers,
                                                   M=150, per=7)
    coords, box = (torch.as_tensor(a, device=cuda) for a in (coords, box))
    membrane, heads = (torch.as_tensor(a, device=cuda)
                       for a in (membrane, heads))
    args = (coords, box, membrane, heads, 2, 2.0, handle_pbc)
    got = neighbors.local_sums(*args)
    assert torch.equal(got, neighbors.local_sums(*args))
    want = neighbors.local_sums_plain(*args)
    d = coords[:, None, membrane, :2] - coords[:, heads, None, :2]
    if handle_pbc:
        d = d - box[:, None, None, :2] * torch.round(d / box[:, None, None,
                                                            :2])
    count = ((d * d).sum(-1) <= 4.0).sum(-1).to(torch.float32)
    z = 1.0 if handle_pbc else float(coords[:, membrane, 2].abs().max())
    magnitude = torch.stack([count * z, count], -1)
    assert bool(((got - want).abs() <= SUM_BOUND * magnitude + 1e-12).all())
    local = tl.LocalClassifier(membrane.cpu(), heads.cpu(), 2, 2.0,
                               handle_pbc, device=cuda)
    assert torch.equal(local(coords, box), local.plain(coords, box))


def test_neighbor_kernels_outside_the_box(cuda, monkeypatch):
    """Atoms and heads moved whole box lengths out of [-L, 2L] in some
    frames and tiles (a tile's pairs then all take the division): the
    same counts, sums and classes as plain."""
    from gorder_tpu_torch.core import leaflets as tl
    from gorder_tpu_torch.ops import neighbors

    from .test_torch_leaflets import _membrane

    monkeypatch.setattr(neighbors, "NORMAL_TILE", 64)
    monkeypatch.setattr(neighbors, "LOCAL_TILE", 64)
    rng = np.random.default_rng(17)
    coords, box, heads, cloud = _cloud_case(13, cuda, B=4, M=75, extra=37)
    shift = torch.as_tensor(rng.integers(-3, 4, coords.shape[:2])
                            * (np.arange(4) % 2)[:, None], device=cuda)
    coords = coords + shift[..., None] * box[:, None, :]
    args = (coords, box, heads, cloud, 2.0, True)
    _same_cloud(neighbors.normal_cloud(*args),
                neighbors.normal_cloud_plain(*args))
    coords, box, membrane, heads, _, _ = _membrane(7, M=150, per=3)
    coords = coords + (rng.integers(-3, 4, coords.shape[:2])[..., None]
                       * (np.arange(6) % 2)[:, None, None]
                       * box[:, None, :]).astype(np.float32)
    coords, box = (torch.as_tensor(a, device=cuda) for a in (coords, box))
    local = tl.LocalClassifier(membrane, heads, 2, 2.0, True, device=cuda)
    assert torch.equal(local(coords, box), local.plain(coords, box))


def test_neighbor_kernels_at_minimum_image_ties(cuda):
    """chip_smoke.py's batch at minimum-image ties (every offset of a
    head's own atoms within a few ulps of ±L/2 in each component, the
    radius at their median distance): counts, masked sums and local
    classes equal plain's, two launches bit-equal."""
    import chip_smoke

    chip_smoke.check_neighbor_ties()


def test_neighbor_kernels_reject_wrong_arguments(cuda):
    from gorder_tpu_torch.ops import neighbors

    coords, box, heads, cloud = _cloud_case(9, cuda, B=2, M=8)
    with pytest.raises(TypeError):
        neighbors.normal_cloud(coords.double(), box, heads, cloud, 2.0, True)
    with pytest.raises(ValueError):
        neighbors.normal_cloud(coords, box, heads.cpu(), cloud, 2.0, True)
    with pytest.raises(TypeError):
        neighbors.local_sums(coords, box, cloud.int(), heads, 2, 2.0, True)
    with pytest.raises(ValueError):
        neighbors.local_sums(coords, box[:, :2].contiguous(), cloud, heads,
                             2, 2.0, True)


# ------------------------------------------------- spectral classifier
# csrc/spectral.cu against ops/spectral.py's plain versions on the card, on
# the first frames of the clustering bilayer (chip_smoke.synthesize_aab:
# 256 P heads) and on tests/test_torch_clustering.py's flat (72 heads, not
# a multiple of 32), vesicle (360) and scrambling (128) systems; on each
# kernel's paths, forced by their limits: the similarity's triangle (up to
# 288 heads; the vesicle takes two passes) and two passes (with the heads
# in several ragged tiles), the k-means' one warp a frame (up to 256 rows)
# and one block, its rows in shared or device memory. The similarity's
# two paths give the same bits; each kernel gives the same bits on a
# second launch; the k-means' labels equal the plain version's after 0, 1
# and 100 steps, and the steps it reports stop at its cap. The degrees: the kernel sums in f64 and
# rounds once, torch sums in f32 in its own order, within 1e-6 of the
# value (8 to 16 f32 ulps: an ulp is 2^-24 to 2^-23 of it); S within 2e-6
# (each entry takes two 1/√degree factors); an entry below f32's normal
# range (2^-126) carries fewer bits. The bases by
# their orthonormality and projectors, ‖·‖₂ ≤ 1e-5 (never column by
# column: the QR's columns past the input's rank and the span's two
# equal-energy directions are set by rounding), on the columns whose
# singular values stand clear of f64 rounding (σ ≥ 1e-6 σ₀). The labels
# equal, also the whole chain's against the plain chain's and the CPU's.

DEGREE_RTOL = 1e-6
S_RTOL = 2e-6
TINY_F32 = 2.0 ** -126
BASIS_TOL = 1e-5


@pytest.fixture(scope="module")
def spectral_systems(tmp_path_factory):
    """{name: ((F, A, 3) f32 coordinates, (F, 3) boxes, head indices)}."""
    import chip_smoke

    from gorder_tpu_torch.io.gro import read_gro
    from gorder_tpu_torch.io.traj import Trajectory

    from . import synthetic
    from .test_torch_clustering import _frames

    d = tmp_path_factory.mktemp("spectral")
    for sub in ("flat", "ves", "scr", "aab"):
        (d / sub).mkdir()
    flat = synthetic.make_flat_bilayer(d / "flat", n_frames=4)
    ves = synthetic.make_vesicle(d / "ves", n_outer=300, n_inner=60,
                                 n_frames=3)
    scr = synthetic.make_scrambling(d / "scr", n_per_leaflet=64, n_frames=8,
                                    flip_at=4, n_flip=4)
    gro, _, xtc = chip_smoke.synthesize_aab(str(d / "aab"), 16)
    system = read_gro(gro)
    traj = Trajectory(xtc)
    coords, boxes, _, _ = traj.read_frames(traj.select_frames(None, None, 1),
                                           system.n_atoms)
    return {"flat": _frames(flat[0], flat[2]),
            "vesicle": _frames(ves[0], ves[2]),
            "scrambling": _frames(scr[0], scr[2]),
            "aab": (np.ascontiguousarray(coords),
                    np.ascontiguousarray(boxes[:, [0, 1, 2], [0, 1, 2]]),
                    np.nonzero(system.atom_names == "P")[0])}


def _gap(a, b, k):
    """‖P_a − P_b‖₂ of the spans of the first k columns, the largest of
    the batch; and the larger ‖QᵀQ − I‖₂ of the two."""
    a, b = a.double()[..., :k], b.double()[..., :k]
    gap = torch.linalg.matrix_norm(a @ a.transpose(1, 2)
                                   - b @ b.transpose(1, 2), ord=2)
    eye = torch.eye(k, dtype=a.dtype, device=a.device)
    ortho = max(float(torch.linalg.matrix_norm(
        q.transpose(1, 2) @ q - eye, ord=2).max()) for q in (a, b))
    return float(gap.max()), ortho


def _spectral_counts():
    from gorder_tpu_torch.ops import spectral

    return [spectral.affinity_launches, spectral.subspace_launches,
            spectral.span_launches, spectral.kmeans_launches]


#: the kernels' paths as the layouts force them: the defaults (the
#: triangle, the subspace's ring, one warp a frame where they fit), one
#: block a frame with its rows in shared memory after two passes (the
#: subspace's matrices read straight from device memory), and in device
#: memory after two passes over ragged tiles of 40 heads (the subspace's
#: working columns too)
SPECTRAL_LAYOUTS = {
    "shared": {},
    "block": {"AFFINITY_TRIANGLE_BYTES": 0, "SUBSPACE_RING_ROWS": 0,
              "KMEANS_WARP_ROWS": 0},
    "device": {"AFFINITY_TRIANGLE_BYTES": 0, "AFFINITY_TILE": 40,
               "SUBSPACE_SHARED_BYTES": 0, "KMEANS_WARP_ROWS": 0,
               "KMEANS_SHARED_ROWS": 2}}


def _force(monkeypatch, layout):
    from gorder_tpu_torch.ops import spectral

    for name, value in SPECTRAL_LAYOUTS[layout].items():
        monkeypatch.setattr(spectral, name, value)


def _heads_of(spectral_systems, name, device):
    coords, boxes, idx = spectral_systems[name]
    coords = torch.as_tensor(coords, device=device)
    return coords[:, idx].contiguous(), torch.as_tensor(boxes, device=device)


def _embedding_inputs(heads, box, pbc):
    """The k-means' inputs of the plain chain: u2 and its products."""
    from gorder_tpu_torch.core import clustering as tc
    from gorder_tpu_torch.ops import spectral

    s_mat, degree = spectral.spectral_affinity_plain(heads, box, pbc,
                                                     tc.PRECISE_SIGMA)
    v0 = torch.sqrt(degree)
    v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    span = tc._top3_subspace(s_mat, v0, spectral.top3_subspace_plain)
    return spectral.top2_span_plain(span, degree, s_mat)


def _filter_inputs(s_mat, degree):
    """The subspace iteration's inputs of the chain: the filtered matrix
    (12 squarings), the start basis."""
    from gorder_tpu_torch.core import clustering as tc

    v0 = torch.sqrt(degree)
    v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    i = torch.arange(s_mat.shape[-1], dtype=torch.float32,
                     device=s_mat.device)
    start = torch.stack([v0, torch.sin(0.7 * i + 0.3).expand_as(v0),
                         torch.cos(1.3 * i + 0.1).expand_as(v0)], -1)
    gp = s_mat / tc._frame_max(s_mat)
    for _ in range(12):
        gp = gp @ gp
        gp = gp / tc._frame_max(gp)
    return gp.contiguous(), start


def _hold_span(span, degree, s_mat):
    """The fused span against its plain version: u2 by projectors; lap(u2)
    within BASIS_TOL of u2 − s_matᵀ u2 of the kernel's own u2, in f64 (the
    two u2 may rotate within their span, and lap with them)."""
    from gorder_tpu_torch.ops import spectral

    u2, lu2 = spectral.top2_span(span, degree, s_mat)
    want_u2 = spectral.top2_span_plain(span, degree)
    assert max(_gap(u2, want_u2, 2)) <= BASIS_TOL
    x = u2.double()
    want_lu2 = x - s_mat.transpose(1, 2).double() @ x
    assert float((lu2.double() - want_lu2).abs().max()) <= BASIS_TOL
    assert torch.equal(spectral.top2_span(span, degree), u2)
    return u2, lu2


@pytest.mark.parametrize("layout", list(SPECTRAL_LAYOUTS))
@pytest.mark.parametrize("name", ["aab", "flat", "vesicle", "scrambling"])
def test_spectral_kernels_match_plain(cuda, spectral_systems, monkeypatch,
                                      name, layout):
    from gorder_tpu_torch.core import clustering as tc
    from gorder_tpu_torch.ops import spectral

    _force(monkeypatch, layout)
    coords, boxes, idx = spectral_systems[name]
    coords = torch.as_tensor(coords, device=cuda)
    box = torch.as_tensor(boxes, device=cuda)
    heads = coords[:, idx].contiguous()
    pbc = name != "vesicle"

    before = _spectral_counts()
    s_mat, degree = spectral.spectral_affinity(heads, box, pbc,
                                               tc.PRECISE_SIGMA)
    torch.cuda.synchronize()
    assert _spectral_counts()[0] == before[0] + 1
    want_s, want_degree = spectral.spectral_affinity_plain(
        heads, box, pbc, tc.PRECISE_SIGMA)
    torch.testing.assert_close(degree, want_degree, rtol=DEGREE_RTOL, atol=0)
    torch.testing.assert_close(s_mat, want_s, rtol=S_RTOL, atol=TINY_F32)

    # the subspace iteration on the chain's own inputs (its QRs see the
    # filter's `gp @ q`, condition numbers near 1e7 on the bilayers), then
    # the fused span on its output
    gp, start = _filter_inputs(want_s, want_degree)
    span = spectral.top3_subspace(gp, want_s, start)
    want_span = spectral.top3_subspace_plain(gp, want_s, start)
    assert max(_gap(span, want_span, 3)) <= BASIS_TOL
    u2, lu2 = _hold_span(want_span, want_degree, want_s)
    labels = spectral.rayleigh_kmeans(u2, lu2, tc.KMEANS_ITERS)
    assert torch.equal(labels, spectral.rayleigh_kmeans_plain(
        u2, lu2, tc.KMEANS_ITERS))

    classify = tc.make_spectral_labels(idx, pbc, device=cuda)
    before = _spectral_counts()
    got = classify(coords, box)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_spectral_counts(), before)] == [1, 1, 1, 1]
    assert torch.equal(got, classify.plain(coords, box))
    cpu = tc.make_spectral_labels(idx, pbc)(coords.cpu(), box.cpu())
    assert torch.equal(got.cpu(), cpu)
    assert bool(((got == 0).any(1) & (got == 1).any(1)).all())


def test_spectral_nystrom_kernels_match_plain(cuda, spectral_systems,
                                              monkeypatch):
    """The landmark path (DENSE_CLUSTER_HEADS below the vesicle's 360
    heads, 120 landmarks): no similarity kernel, the rest as dense."""
    from gorder_tpu_torch.core import clustering as tc

    monkeypatch.setattr(tc, "DENSE_CLUSTER_HEADS", 100)
    monkeypatch.setattr(tc, "NYSTROM_LANDMARKS", 120)
    coords, boxes, idx = spectral_systems["vesicle"]
    coords = torch.as_tensor(coords, device=cuda)
    box = torch.as_tensor(boxes, device=cuda)
    classify = tc.make_spectral_labels(idx, device=cuda)
    before = _spectral_counts()
    got = classify(coords, box)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_spectral_counts(), before)] == [0, 1, 1, 1]
    assert torch.equal(got, classify.plain(coords, box))
    cpu = tc.make_spectral_labels(idx)(coords.cpu(), box.cpu())
    assert torch.equal(got.cpu(), cpu)


def test_spectral_kernels_reject_wrong_arguments(cuda):
    from gorder_tpu_torch.ops import spectral

    heads = torch.rand((2, 16, 3), device=cuda)
    box = torch.full((2, 3), 5.0, device=cuda)
    with pytest.raises(ValueError):
        spectral.spectral_affinity(heads, box.cpu(), True, 1.0)
    s_mat = torch.rand((2, 16, 16), device=cuda)
    with pytest.raises(TypeError):
        spectral.top3_subspace(s_mat.double(), s_mat, heads)
    with pytest.raises(ValueError):
        spectral.top3_subspace(s_mat, s_mat.transpose(1, 2), heads)
    with pytest.raises(ValueError):
        spectral.top2_span(heads, torch.ones((2, 16), device=cuda)[:, ::2])
    with pytest.raises(ValueError):
        spectral.top2_span(heads, torch.ones((2, 16), device=cuda),
                           s_mat.cpu())
    with pytest.raises(ValueError):
        spectral.rayleigh_kmeans(heads[..., :2], heads[..., 1:], 5)


def _spectrum_matrices(n, n_frames, device, seed=21):
    """(B, n, n) f32 symmetric PSD matrices of a known spectrum, its top
    three 1, 0.9, 0.8 and the rest at most 0.5 (so the subspace is well
    defined), as the filtered and the unfiltered matrix (the filter: the
    fourth power, rescaled), and (B, n, 3) f32 start bases."""
    rng = np.random.default_rng(seed + n)
    mats = []
    for _ in range(n_frames):
        q = np.linalg.qr(rng.normal(size=(n, n)))[0]
        lam = np.concatenate([[1.0, 0.9, 0.8][:n],
                              np.linspace(0.5, 0.01, max(n - 3, 0))])
        mats.append((q * lam) @ q.T)
    s_mat = torch.as_tensor(np.stack(mats).astype(np.float32), device=device)
    gp = s_mat @ s_mat
    gp = gp @ gp
    gp = (gp / gp.abs().amax(dim=(-2, -1), keepdim=True)).contiguous()
    start = torch.as_tensor(rng.normal(size=(n_frames, n, 3))
                            .astype(np.float32), device=device)
    return gp, s_mat, start


@pytest.mark.parametrize("path", ["ring", "shared", "device"])
@pytest.mark.parametrize("n", [3, 31, 256, 288, 300, 1024])
def test_top3_subspace_paths(cuda, monkeypatch, n, path):
    """Each `subspace_plan` path at 3 rows to Nyström's 1,024 landmarks (one
    to four columns a thread; the ring's 4-byte copies where n is not a
    multiple of 4): orthonormal, the projector of the plain version's,
    the same bits on a second launch; one launch a call."""
    from gorder_tpu_torch.ops import spectral

    if path == "shared":
        monkeypatch.setattr(spectral, "SUBSPACE_RING_ROWS", 0)
    if path == "device":
        monkeypatch.setattr(spectral, "SUBSPACE_SHARED_BYTES", 0)
    assert spectral.subspace_plan(n).path == path
    gp, s_mat, start = _spectrum_matrices(n, 3, cuda)
    before = spectral.subspace_launches
    q = spectral.top3_subspace(gp, s_mat, start)
    again = spectral.top3_subspace(gp, s_mat, start)
    torch.cuda.synchronize()
    assert spectral.subspace_launches == before + 2
    assert torch.equal(q, again)
    assert max(_gap(q, spectral.top3_subspace_plain(gp, s_mat, start),
                    3)) <= BASIS_TOL


@pytest.mark.parametrize("layout", list(SPECTRAL_LAYOUTS))
def test_top3_subspace_more_frames_than_blocks(cuda, monkeypatch, layout):
    """More frames than persistent blocks: each block takes frame after
    frame, on each path; the frames' bases equal those of one frame at a
    time, bit for bit."""
    from gorder_tpu_torch.ops import spectral

    _force(monkeypatch, layout)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gp, s_mat, start = _spectrum_matrices(64, 1, cuda)
    frames = 3 * n_sms + 5
    rng = np.random.default_rng(3)
    start = torch.as_tensor(rng.normal(size=(frames, 64, 3))
                            .astype(np.float32), device=cuda)
    gp, s_mat = (m.expand(frames, -1, -1).contiguous() for m in (gp, s_mat))
    q = spectral.top3_subspace(gp, s_mat, start)
    one = torch.cat([spectral.top3_subspace(gp[f:f + 1], s_mat[f:f + 1],
                                            start[f:f + 1])
                     for f in (0, n_sms, frames - 1)])
    torch.cuda.synchronize()
    assert torch.equal(q[[0, n_sms, frames - 1]], one)


def test_top3_subspace_unaligned_matrices(cuda):
    """Matrices 4 bytes past a 16-byte boundary (a view at an odd offset):
    the ring copies 4 bytes at a time, with the same bits as aligned
    copies of the same matrices."""
    from gorder_tpu_torch.ops import spectral

    gp, s_mat, start = _spectrum_matrices(64, 3, cuda)
    shifted = []
    for m in (gp, s_mat):
        flat = torch.empty(m.numel() + 1, device=cuda)
        view = flat[1:].view(m.shape)
        view.copy_(m)
        assert view.data_ptr() % 16 == 4 and view.is_contiguous()
        shifted.append(view)
    q = spectral.top3_subspace(*shifted, start)
    torch.cuda.synchronize()
    assert torch.equal(q, spectral.top3_subspace(gp, s_mat, start))


def test_top3_subspace_zero_column(cuda):
    """A start basis with a zero column: its reflection is skipped (τ = 0),
    and the iteration still finds the subspace."""
    from gorder_tpu_torch.ops import spectral

    gp, s_mat, start = _spectrum_matrices(40, 2, cuda)
    start[:, :, 1] = 0.0
    q = spectral.top3_subspace(gp, s_mat, start)
    want = spectral.top3_subspace_plain(gp, s_mat, start)
    assert bool(torch.isfinite(q).all())
    assert max(_gap(q, want, 3)) <= BASIS_TOL


def test_top3_subspace_on_the_filter_ill_conditioned(cuda,
                                                     spectral_systems):
    """The clustering bilayer's filter, whose QR inputs gp @ q reach
    condition numbers near 7.8e7: the kernel's basis is the plain one's;
    the first QR input's condition number is that large."""
    from gorder_tpu_torch.core import clustering as tc
    from gorder_tpu_torch.ops import spectral

    heads, box = _heads_of(spectral_systems, "aab", cuda)
    s_mat, degree = spectral.spectral_affinity_plain(heads, box, True,
                                                     tc.PRECISE_SIGMA)
    gp, start = _filter_inputs(s_mat, degree)
    ill = gp.transpose(1, 2).double() @ spectral.householder_q(
        start.double())
    sv = torch.linalg.svdvals(ill)
    assert float((sv[:, 0] / sv[:, 2]).max()) > 1e6
    q = spectral.top3_subspace(gp, s_mat, start)
    want = spectral.top3_subspace_plain(gp, s_mat, start)
    assert max(_gap(q, want, 3)) <= BASIS_TOL


def test_top2_span_paths(cuda):
    """The fused span at one, two and four columns a thread and past one
    tile of u2 (1,024 rows), with and without its Laplacian products; at
    2,100 and 3,100 rows the block's last pass over the columns holds 52
    and 28 of them, and reloads the tiles all the same."""
    from gorder_tpu_torch.ops import spectral

    rng = np.random.default_rng(22)
    for n in (31, 256, 300, 1100, 2100, 3100):
        _, s_mat, _ = _spectrum_matrices(n, 2, cuda)
        span = torch.as_tensor(np.linalg.qr(rng.normal(size=(2, n, 3)))[0]
                               .astype(np.float32), device=cuda)
        degree = torch.as_tensor(rng.uniform(0.5, 3.0, (2, n))
                                 .astype(np.float32), device=cuda)
        _hold_span(span, degree, s_mat)


@pytest.mark.parametrize("pbc", [True, False])
@pytest.mark.parametrize("name", ["aab", "flat", "scrambling"])
def test_spectral_affinity_paths_give_the_same_bits(cuda, spectral_systems,
                                                    monkeypatch, name, pbc):
    """The triangle and the two passes: the same weights, the degrees
    summed in f64 in the same order, the same products; each path again
    the same on a second launch."""
    from gorder_tpu_torch.core import clustering as tc
    from gorder_tpu_torch.ops import spectral

    heads, box = _heads_of(spectral_systems, name, cuda)
    assert spectral.affinity_plan(heads.shape[1]).path == "triangle"
    runs = []
    for layout in ("shared", "shared", "block", "device"):
        with monkeypatch.context() as m:
            _force(m, layout)
            runs.append(spectral.spectral_affinity(heads, box, pbc,
                                                   tc.PRECISE_SIGMA))
    torch.cuda.synchronize()
    for s_mat, degree in runs[1:]:
        assert torch.equal(s_mat, runs[0][0])
        assert torch.equal(degree, runs[0][1])


@pytest.mark.parametrize("iters", [0, 1, 100])
@pytest.mark.parametrize("layout", list(SPECTRAL_LAYOUTS))
def test_rayleigh_kmeans_steps(cuda, spectral_systems, monkeypatch, layout,
                               iters):
    """Each path on the clustering bilayer and the scrambling system: the
    labels of `iters` steps, the centroid updates each frame ran (none for
    0 steps, one for 1, at most 100 and fewer where the labels stop
    changing), the same bits on a second launch."""
    from gorder_tpu_torch.ops import spectral

    _force(monkeypatch, layout)
    for name in ("aab", "scrambling"):
        heads, box = _heads_of(spectral_systems, name, cuda)
        u2, lu2 = _embedding_inputs(heads, box, True)
        got = []
        for _ in range(2):
            steps = torch.full((u2.shape[0],), -1, dtype=torch.int32,
                               device=cuda)
            got.append((spectral.rayleigh_kmeans(u2, lu2, iters,
                                                 steps=steps), steps))
        torch.cuda.synchronize()
        (labels, steps), again = got
        assert torch.equal(labels, again[0]) and torch.equal(steps, again[1])
        assert torch.equal(labels, spectral.rayleigh_kmeans_plain(
            u2, lu2, iters))
        if iters <= 1:
            assert bool((steps == iters).all())
        else:
            assert 1 <= int(steps.min()) and int(steps.max()) < iters
