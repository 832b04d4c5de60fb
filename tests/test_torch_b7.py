"""The b7 wire as the P2 kernel takes it, packed (gorder_tpu_torch/ops/p2.py
`p2_b7`), on the CPU: a numpy b7 encoder (a test helper, `encode_b7`, which
the card tests in test_torch_kernels.py use too) held against the JAX
package's decoder, and the type-major layout of the compiled topologies
that the kernels' warp-aggregated type sums are designed for."""

import os

import numpy as np
import pytest

import chip_smoke
from gorder_tpu_torch.io.native import b7_stride

from .synthetic import make_flat_bilayer


def encode_b7(r, cap=None):
    """(B, nv) integer residuals → the b7 wire: pk (B, b7_stride(nv/3))
    uint8, value v's 7-bit code at bit 7v of its row, little endian; gp
    (B, cap) uint16 gaps between escapes (the first from −1) and vl
    (B, cap) int16 their values, zero-padded: a code for −64..63, an
    escape for any other value. `cap`: the most escapes of a frame
    (at least 1) unless given."""
    r = np.asarray(r, np.int64)
    b, nv = r.shape
    stride = (nv + 7) // 8 * 7
    esc = (r < -64) | (r > 63)
    codes = (np.where(esc, 0, r) & 127).astype(np.uint64)
    groups = np.zeros((b, stride // 7 * 8), np.uint64)
    groups[:, :nv] = codes
    words = np.bitwise_or.reduce(
        groups.reshape(b, -1, 8) << (np.uint64(7) * np.arange(8, dtype=np.uint64)),
        axis=-1)
    pk = ((words[..., None] >> (np.uint64(8) * np.arange(7, dtype=np.uint64)))
          & np.uint64(255)).astype(np.uint8).reshape(b, stride)
    cap = max(int(esc.sum(1).max()), 1) if cap is None else cap
    gp = np.zeros((b, cap), np.uint16)
    vl = np.zeros((b, cap), np.int16)
    for f in range(b):
        pos = np.flatnonzero(esc[f])
        gaps = np.diff(pos, prepend=-1)
        assert len(pos) <= cap and (gaps <= 65535).all()
        gp[f, :len(pos)] = gaps
        vl[f, :len(pos)] = r[f, pos]
    return pk, gp, vl


def _payload(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "random":
        # mostly codes, some escapes anywhere in the int16 range
        r = rng.integers(-64, 64, (6, 3 * 1000))
        big = rng.random(r.shape) < 0.05
        r[big] = rng.integers(-32768, 32768, int(big.sum()))
        r[:, 0], r[:, -1] = 64, -65          # escapes at 0 and at nv − 1
        return r
    if kind == "all_escape":
        return np.where(rng.random((3, 300)) < 0.5, 1, -1) \
            * rng.integers(64, 32768, (3, 300))
    # N not a multiple of 8: the last 7-byte group is part padding
    return rng.integers(-200, 200, (4, 3 * 333))


@pytest.mark.parametrize("kind", ["random", "all_escape", "ragged"])
def test_encoder_round_trip(kind):
    """The JAX package's decoder gives the encoded residuals back
    exactly; the row is as long as `b7_stride` says."""
    from gorder_tpu.engine.wire import _b7_residuals_impl

    r = _payload(kind)
    pk, gp, vl = encode_b7(r)
    assert pk.shape[1] == b7_stride(r.shape[1] // 3)
    if kind == "all_escape":
        assert (gp != 0).all()
    got = np.asarray(_b7_residuals_impl(pk, gp, vl, r.shape[1]))
    np.testing.assert_array_equal(got, r)


def _kinds_aa(tmp_path):
    from gorder_tpu_torch.engine.prepare import (_prepare_bond_kinds,
                                                 load_structure)

    gro, bnd, _ = chip_smoke.synthesize_structure(
        str(tmp_path), n_lipids=6, total_atoms=6 * 134 + 60)
    analysis = chip_smoke.aa_analysis(gro, bnd,
                                      os.path.join(tmp_path, "none.xtc"))
    return _prepare_bond_kinds(load_structure(analysis), analysis)


def _kinds_cg(tmp_path):
    import gorder_tpu_torch
    from gorder_tpu_torch.engine.prepare import (_prepare_bond_kinds,
                                                 load_structure)

    gro, bnd, xtc = make_flat_bilayer(tmp_path, n_frames=2)
    analysis = gorder_tpu_torch.Analysis(
        structure=gro, bonds=bnd, trajectory=xtc,
        analysis_type=gorder_tpu_torch.AnalysisType.cgorder("resname POPC"),
        silent=True)
    return _prepare_bond_kinds(load_structure(analysis), analysis)


def _runs(values, length):
    """Whether `values` is runs of `length` equal entries, each run's
    entry other than the last run's."""
    runs = np.asarray(values).reshape(-1, length)
    return (runs == runs[:, :1]).all() and (np.diff(runs[:, 0]) != 0).all()


@pytest.mark.parametrize("system", ["aa", "cg"])
def test_compiled_bonds_are_type_major(tmp_path, system):
    """`compile_bonds` lays the bonds out type-major: for each kind, each
    of its bond types in a run of that bond of every molecule, in order;
    so the lanes of a warp of the P2 kernel hold one type."""
    kinds, compiled = (_kinds_aa if system == "aa" else _kinds_cg)(tmp_path)
    start = 0
    for k, kind in enumerate(kinds):
        m = kind.n_molecules
        n = m * len(kind.bond_types)
        types = compiled.bond_type[start:start + n]
        mols = compiled.molecule[start:start + n].reshape(-1, m)
        assert m > 1 and _runs(types, m)
        np.testing.assert_array_equal(
            types[::m], np.arange(compiled.type_offsets[k],
                                  compiled.type_offsets[k + 1]))
        np.testing.assert_array_equal(
            mols, np.broadcast_to(compiled.mol_offsets[k] + np.arange(m),
                                  mols.shape))
        start += n
    assert start == compiled.n_bonds


def test_compiled_ua_targets_are_type_major(tmp_path):
    """The UA compile lays each category's targets out carbon-major: a run
    of that carbon of every molecule, whose k-th hydrogens share one
    sample type; so the lanes of a warp of the UA kernel hold, for each
    k, one type."""
    from gorder_tpu_torch.core.ua import CATEGORIES, N_HYDROGENS
    from gorder_tpu_torch.engine.prepare import (_prepare_ua_kinds,
                                                 load_structure)

    n_mols = 5
    files = chip_smoke.synthesize_ua(str(tmp_path), 2, n_lipids=n_mols,
                                     total_atoms=n_mols * 51 + 90)
    analysis = chip_smoke.ua_analysis("ua", *files)
    _, compiled = _prepare_ua_kinds(load_structure(analysis), analysis)
    offset = 0
    seen = []
    for cat in CATEGORIES:
        if cat not in compiled.categories:
            continue
        ix = compiled.categories[cat]
        k = N_HYDROGENS[cat]
        n = len(ix["target"])
        types = compiled.bond_type[offset:offset + n * k].reshape(n, k)
        for h in range(k):
            assert _runs(types[:, h], n_mols)
        np.testing.assert_array_equal(
            ix["mol"].reshape(-1, n_mols),
            np.broadcast_to(np.arange(n_mols), (n // n_mols, n_mols)))
        seen.append(cat)
        offset += n * k
    assert offset == len(compiled.bond_type) and len(seen) >= 3
