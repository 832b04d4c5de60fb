"""The port's pygorder-compatible Python API (`gorder_tpu_torch.compat`,
`results/pyapi.py`) against `gorder_tpu.compat` on the CPU.

Each analysis is built from the same constructor calls of both
namespaces and run through `gorder_tpu.compat.Analysis(...).run()` and
`gorder_tpu_torch.compat.Analysis(...).run(device="cpu")`. Every view of
both method-style result trees is walked (`snapshot`) and the two walks
must be equal: frame counts, molecules, atoms and bonds, `value()` and
`error()` exactly (NaN matching NaN), `AtomType` fields, map arrays,
convergence curves, collected leaflets and normals, and every `APIError`
message word for word.

`gorder_tpu` runs op by op (`jax.disable_jit()`): the port equals its
arithmetic op by op, bit for bit, while jitted XLA:CPU contracts FMAs and
moves sums by up to one quantum a sample, and puts some ordermap tile
boundary midpoints in the neighbouring tile (ROADMAP Queue 3). Dynamic
membrane normals agree only to float noise (tests/test_torch_normals.py):
that case runs `gorder_tpu` jitted and holds values to one 1e-6 quantum
and the normals to 1e-5 up to sign.
"""

import math
import os

import jax
import numpy as np
import pytest

import chip_smoke
import gorder_tpu
import gorder_tpu.compat as jax_gorder
import gorder_tpu_torch
import gorder_tpu_torch.compat as port_gorder
from gorder_tpu_torch.parallel.shard import save_partial

from .test_torch_pipeline import AA_LIPIDS, UA_LIPIDS
from .test_torch_pipeline import cg_files  # noqa: F401

P_HEADS = "resname POPC and name P"
NOT_THERE = 9999
#: one batch: op by op, `gorder_tpu`'s time grows with the batches
FRAMES = 400


@pytest.fixture(scope="module")
def aa_files(tmp_path_factory):
    """tests/test_torch_pipeline.py's cut of bench.py's AA membrane, over
    `FRAMES` frames."""
    d = str(tmp_path_factory.mktemp("aa"))
    gro, bnd, system = chip_smoke.synthesize_structure(
        d, n_lipids=AA_LIPIDS, total_atoms=AA_LIPIDS * 134 + 60)
    return gro, bnd, chip_smoke.synthesize_trajectory(d, system, FRAMES)


@pytest.fixture(scope="module")
def ua_files(tmp_path_factory):
    """tests/test_torch_pipeline.py's cut of tools/bench_modes.py's UA
    membrane, over `FRAMES` frames."""
    d = str(tmp_path_factory.mktemp("ua"))
    return chip_smoke.synthesize_ua(d, FRAMES, n_lipids=UA_LIPIDS,
                                    total_atoms=UA_LIPIDS * 51 + 90)


def _call(fn, *args):
    """fn(*args), or the error it raises as ("error", class name,
    message)."""
    try:
        return fn(*args)
    except (gorder_tpu.GorderError, gorder_tpu_torch.GorderError) as exc:
        return ("error", type(exc).__name__, str(exc))


def _order(o):
    return None if o is None else (o.value(), o.error())


def _collection(c):
    return {cls: _order(getattr(c, cls)()) for cls in ("total", "upper",
                                                       "lower")}


def _map(m):
    if m is None:
        return None
    x, y, values = m.extract()
    (x0, x1), (y0, y1) = m.span_x(), m.span_y()
    bx, by = m.tile_dim()
    probes = [(x0, y0), (x1, y1), ((x0 + x1) / 2, (y0 + y1) / 2),
              (x0 + 1.3 * bx, y1 - 2.6 * by), (x0 - 5 * bx, y0),
              (x0, y1 + 5 * by)]
    return {"span_x": m.span_x(), "span_y": m.span_y(),
            "tile_dim": m.tile_dim(), "x": x, "y": y, "values": values,
            "get_at": [m.get_at(px, py) for px, py in probes]}


def _maps(c):
    return {cls: _map(getattr(c, cls)()) for cls in ("total", "upper",
                                                     "lower")}


def _atom_type(t):
    return (t.atom_name(), t.relative_index(), t.residue_name())


def _bond(b):
    atoms = _call(b.atoms)
    return {"molecule": b.molecule(),
            "atoms": (atoms if atoms[0] == "error"
                      else tuple(_atom_type(t) for t in atoms)),
            "order": _collection(b.order()),
            "ordermaps": _maps(b.ordermaps())}


def _atom(a):
    """An atom's views; `get_bond` for each of its bonds' partners (a
    hydrogen's relative index; a UA carbon's virtual hydrogens 0-3) and
    one that does not exist."""
    partners = [atoms[1].relative_index() for atoms in
                (_call(b.atoms) for b in a.bonds()) if atoms[0] != "error"]
    partners = (partners or list(range(4))) + [NOT_THERE]
    return {"atom": _atom_type(a.atom()), "molecule": a.molecule(),
            "order": _collection(a.order()),
            "ordermaps": _maps(a.ordermaps()),
            "bonds": [_bond(b) for b in a.bonds()],
            "get_bond": [_call(lambda i: _bond(a.get_bond(i)), i)
                         for i in partners]}


def _molecule(m):
    out = {"molecule": m.molecule(),
           "average_order": _collection(m.average_order()),
           "average_ordermaps": _maps(m.average_ordermaps()),
           "bonds": [_bond(b) for b in m.bonds()]}
    atoms = _call(m.atoms)
    if atoms[0] == "error":
        out["atoms"] = atoms
        out["get_atom"] = _call(m.get_atom, 0)
    else:
        out["atoms"] = [_atom(a) for a in atoms]
        out["get_atom"] = [_call(lambda i: _atom(m.get_atom(i)), i)
                           for i in [a.atom().relative_index()
                                     for a in atoms] + [NOT_THERE]]
    pairs = []
    for b in m.bonds():
        atoms = _call(b.atoms)
        if atoms[0] != "error":
            pairs.append((atoms[1].relative_index(),
                          atoms[0].relative_index()))
    out["get_bond"] = [_call(lambda i, j: _bond(m.get_bond(i, j)), i, j)
                       for i, j in pairs + [(0, NOT_THERE)]]
    conv = m.convergence()
    out["convergence"] = None if conv is None else {
        "frames": conv.frames(), "total": conv.total(),
        "upper": conv.upper(), "lower": conv.lower()}
    return out


def _collected(data, names):
    if data is None:
        return None
    return {"frames": data.frames(),
            **{name: data.get_molecule(name) for name in names}}


def snapshot(results):
    """Every view of a method-style results tree, as plain values."""
    names = [m.molecule() for m in results.molecules()]
    return {
        "n_analyzed_frames": results.n_analyzed_frames(),
        "average_order": _collection(results.average_order()),
        "average_ordermaps": _maps(results.average_ordermaps()),
        "molecules": [_molecule(m) for m in results.molecules()],
        "get_molecule": [_call(lambda n: _molecule(results.get_molecule(n)),
                               n) for n in names + ["DOPE"]],
        "leaflets_data": _collected(results.leaflets_data(),
                                    names + ["DOPE"]),
        "normals_data": _collected(results.normals_data(), names + ["DOPE"]),
    }


def assert_same(got, want, where="results", tol=0.0, normals_tol=None):
    """`got` (the port's walk) equals `want` (gorder_tpu's): floats exactly
    (NaN == NaN) or within `tol`, arrays equal; with `normals_tol`, (F, M, 3)
    float arrays equal up to sign within it, NaN where `want` is."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for key in want:
            assert_same(got[key], want[key], f"{where}.{key}", tol,
                        normals_tol)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), where
        assert len(got) == len(want), f"{where}: {len(got)} != {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]", tol, normals_tol)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        if normals_tol is not None and want.ndim == 3:
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            keep = ~np.isnan(want)
            off = np.minimum(np.abs(got - want), np.abs(got + want))[keep]
            assert off.max(initial=0.0) <= normals_tol, where
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, float):
        assert isinstance(got, float), f"{where}: {got!r} vs {want!r}"
        if math.isnan(want):
            assert math.isnan(got), f"{where}: {got} vs NaN"
        else:
            assert abs(got - want) <= tol, f"{where}: {got!r} vs {want!r}"
    else:
        assert got == want, f"{where}: {got!r} vs {want!r}"


def _atype(g, system):
    if system == "aa":
        return g.analysis_types.AAOrder(chip_smoke.HEAVY, chip_smoke.HYDROGENS)
    if system == "cg":
        return g.analysis_types.CGOrder("resname POPC")
    if system == "ua":
        return g.analysis_types.UAOrder(
            saturated="resname POPC and name r'^CA\\d+$'")
    return g.analysis_types.UAOrder(
        saturated="resname POPC and name r'^CA\\d+$' or (resname POPC and "
                  "name r'^CB\\d+$' and not name CB9 CB10)",
        unsaturated="resname POPC and name CB9 CB10")


#: the options of each case, from a pygorder namespace `g`
OPTIONS = {
    "plain": lambda g: {},
    "errors": lambda g: dict(
        estimate_error=g.estimate_error.EstimateError(n_blocks=4)),
    "leaflets-collect": lambda g: dict(
        leaflets=g.leaflets.GlobalClassification("resname POPC", P_HEADS,
                                                 collect=True)),
    "dynamic-collect": lambda g: dict(
        membrane_normal=g.membrane_normal.DynamicNormal(P_HEADS, 10.0,
                                                        collect=True)),
    "ordermap": lambda g: dict(ordermap=g.ordermap.OrderMap(
        bin_size=[0.5, 0.5], min_samples=3)),
    "ordermap-leaflets-errors": lambda g: dict(
        ordermap=g.ordermap.OrderMap(bin_size=[0.5, 0.5], plane="xy"),
        leaflets=g.leaflets.GlobalClassification("resname POPC", P_HEADS,
                                                 flip=True),
        estimate_error=g.estimate_error.EstimateError(n_blocks=3)),
}

#: the CG flat bilayer's lipids are 4-bead chains headed by PO4
CG_HEADS = {"leaflets-collect": lambda g: dict(
    leaflets=g.leaflets.GlobalClassification("resname POPC", "name PO4",
                                             collect=True))}


def _analysis(g, files, system, option, **kw):
    gro, bnd, xtc = files
    options = (CG_HEADS.get(option, OPTIONS[option]) if system == "cg"
               else OPTIONS[option])(g)
    return g.Analysis(structure=gro, bonds=bnd, trajectory=xtc,
                      analysis_type=_atype(g, system), silent=True,
                      overwrite=True, **options, **kw)


def _jax_run(analysis, op_by_op=True):
    if not op_by_op:
        return analysis.run()
    with jax.disable_jit():
        return analysis.run()


#: "ua" is the saturated palmitoyl chain (CH3 and CH2), "ua-ch1u" the whole
#: UA analysis, whose CH1u samples take atan2, cos and sin: torch's CPU
#: kernels and XLA's differ in their last bits, so a sample may differ by
#: one 1e-6 quantum (ROADMAP "Exactness contract")
CASES = [("aa", "plain"), ("aa", "errors"), ("aa", "leaflets-collect"),
         ("aa", "dynamic-collect"), ("aa", "ordermap-leaflets-errors"),
         ("cg", "plain"), ("cg", "leaflets-collect"), ("cg", "ordermap"),
         ("ua", "leaflets-collect"), ("ua", "ordermap-leaflets-errors"),
         ("ua-ch1u", "errors")]


@pytest.mark.parametrize("system,option", CASES,
                         ids=[f"{s}-{o}" for s, o in CASES])
def test_views_match_jax(request, system, option):
    files = request.getfixturevalue(f"{system[:2]}_files")
    # the dynamic normals agree to float noise only, jitted or not
    dynamic = option == "dynamic-collect"
    want = snapshot(_jax_run(_analysis(jax_gorder, files, system, option),
                             op_by_op=not dynamic))
    got = snapshot(_analysis(port_gorder, files, system, option).run(
        device="cpu"))
    assert_same(got, want,
                tol=1e-6 if dynamic or system == "ua-ch1u" else 0.0,
                normals_tol=1e-5 if dynamic else None)
    # the walk reached what the case is about
    mol = want["molecules"][0]
    assert want["n_analyzed_frames"] > 0 and mol["bonds"]
    if option.endswith("collect"):
        key = "normals_data" if dynamic else "leaflets_data"
        assert want[key][mol["molecule"]] is not None
    if option.startswith("ordermap"):
        assert want["average_ordermaps"]["total"] is not None
    if option == "errors":
        assert mol["convergence"]["frames"] and \
            mol["average_order"]["total"][1] is not None


#: the vesicle of a 36 nm box: its XTC integers overflow int16
VESICLE_FRAMES = 8


@pytest.fixture(scope="module")
def vesicle_files(tmp_path_factory):
    from . import synthetic

    d = tmp_path_factory.mktemp("vesicle")
    return synthetic.make_vesicle(d, r_outer=16.5, r_inner=12.0,
                                  n_frames=VESICLE_FRAMES)[:3]


def test_vesicle_in_a_wide_box_matches_jax(vesicle_files, monkeypatch,
                                           caplog):
    """A box over 32.767 nm at precision 1000: both packages ride d8, the
    exact int32 XTC integers, and every view is equal at tolerance 0. On
    the f32 wire (what the port rode before it had d8) the bond vectors
    subtract two rounded positions and the values differ. `gorder_tpu`
    runs op by op in batches of 8: its spherical classifier maps over the
    frames of a batch one at a time without jit."""
    import logging

    import gorder_tpu.analysis

    monkeypatch.setattr(gorder_tpu.analysis, "DEFAULT_BATCH_SIZE", 8)

    def analysis(g):
        gro, bnd, xtc = vesicle_files
        return g.Analysis(
            structure=gro, bonds=bnd, trajectory=xtc,
            analysis_type=g.analysis_types.CGOrder("resname POPC"),
            leaflets=g.leaflets.SphericalClusteringClassification(
                "name PO4"), silent=True, overwrite=True)

    with caplog.at_level(logging.INFO, logger="gorder"):
        want = snapshot(_jax_run(analysis(jax_gorder)))
        got = snapshot(analysis(port_gorder).run(device="cpu"))
    wires = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("wire format")]
    assert len(wires) == 2 and all("wire format: d8" in w for w in wires)
    assert_same(got, want)
    assert want["n_analyzed_frames"] == VESICLE_FRAMES
    monkeypatch.setenv("GORDER_TPU_WIRE", "f32")
    f32 = snapshot(analysis(port_gorder).run(device="cpu"))
    with pytest.raises(AssertionError):
        assert_same(f32, want)


def test_api_error_messages(aa_files, cg_files, ua_files):
    """The reference's APIError messages, word for word, from both
    packages: a missing molecule, atom and bond, a CG atom lookup, UA bond
    lookups by relative indices and a UA bond's atoms()."""
    seen = {}
    for name, g, run in (("jax", jax_gorder, _jax_run),
                         ("port", port_gorder,
                          lambda a: a.run(device="cpu"))):
        aa = run(_analysis(g, aa_files, "aa", "plain"))
        cg = run(_analysis(g, cg_files, "cg", "plain"))
        ua = run(_analysis(g, ua_files, "ua", "plain"))
        mol = aa.get_molecule("POPC")
        carbon = mol.atoms()[0]
        ua_mol = ua.get_molecule("POPC")
        seen[name] = [
            _call(aa.get_molecule, "DOPE"),
            _call(mol.get_atom, NOT_THERE),
            _call(mol.get_bond, 0, NOT_THERE),
            _call(carbon.get_bond, NOT_THERE),
            _call(cg.get_molecule("POPC").atoms),
            _call(cg.get_molecule("POPC").get_atom, 0),
            _call(ua_mol.get_bond, 0, 1),
            _call(ua_mol.bonds()[0].atoms),
            _call(ua_mol.atoms()[0].get_bond, NOT_THERE),
        ]
    assert seen["port"] == seen["jax"]
    assert [m for _, _, m in seen["port"]] == [
        "molecule with the given name does not exist",
        "atom with the given relative index does not exist or was not "
        "analyzed",
        "bond specified by the given relative indices does not exist",
        "bond between the atom type and the specified (virtual) hydrogen "
        "type does not exist",
        "results for individual atoms are not available for coarse-grained "
        "order parameters",
        "results for individual atoms are not available for coarse-grained "
        "order parameters",
        "united-atom results for individual bonds cannot be accesed by "
        "using relative indices",
        "united-atom bond types involve only one real atom type",
        "bond between the atom type and the specified (virtual) hydrogen "
        "type does not exist"]
    assert {kind for _, kind, _ in seen["port"]} == {"GorderError"}
    assert port_gorder.exceptions.APIError is gorder_tpu_torch.GorderError


def test_from_file_matches_jax(cg_files, tmp_path):
    """`Analysis.from_file` through both namespaces, with error estimation
    and its convergence file; `write()` writes the same YAML."""
    gro, bnd, xtc = cg_files
    outs = {}
    for name, g in (("jax", jax_gorder), ("port", port_gorder)):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(
            f"structure: {gro}\nbonds: {bnd}\ntrajectory: {xtc}\n"
            f"type: !CGOrder\n  atoms: \"resname POPC\"\n"
            f"output: {tmp_path / name}_order.yaml\n"
            f"estimate_error: !EstimateError\n  n_blocks: 4\n"
            f"silent: true\noverwrite: true\n")
        analysis = g.Analysis.from_file(str(cfg))
        assert isinstance(analysis, g.Analysis)
        results = (_jax_run(analysis) if name == "jax"
                   else analysis.run(device="cpu"))
        assert isinstance(results.average_order(), g.results.OrderCollection)
        results.write()
        outs[name] = snapshot(results)
        with open(f"{tmp_path / name}_order.yaml") as fh:
            outs[name + " yaml"] = [ln for ln in fh.read().splitlines()
                                    if not ln.startswith("#")]
    assert_same(outs["port"], outs["jax"])
    assert outs["port yaml"] == outs["jax yaml"]


@pytest.mark.parametrize("system", ["aa", "ua"])
def test_run_partial_merge_matches_jax(request, tmp_path, system):
    """`run_partial` and `merge` through the drop-in namespace: two frame
    shards merged, each state through the partial-state file, equal the
    single run's views, and each package merges the other's states."""
    files = request.getfixturevalue(f"{system}_files")
    port = _analysis(port_gorder, files, system, "errors")
    jaxa = _analysis(jax_gorder, files, system, "errors")
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"part{i}.npz"))
        save_partial(paths[-1], port.run_partial(i, 2, device="cpu"))
    merged = snapshot(port.merge(paths))
    assert_same(merged, snapshot(port.run(device="cpu")))
    with jax.disable_jit():
        jax_states = [jaxa.run_partial(i, 2) for i in range(2)]
    assert_same(snapshot(port.merge(jax_states)),
                snapshot(jaxa.merge(jax_states)))
    assert_same(snapshot(jaxa.merge(paths)), merged)


def test_compat_run_defaults_to_the_card(aa_files):
    """pygorder code calls `run()` with no argument: on the GPU, so
    without a card it raises as `gorder_tpu_torch.run` does."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    analysis = _analysis(port_gorder, aa_files, "aa", "plain")
    for call in (analysis.run, lambda: analysis.run_partial(0, 2)):
        with pytest.raises(gorder_tpu_torch.AnalysisError, match="cuda"):
            call()


def test_top_level_exports():
    """Every public name of `gorder_tpu` but JAX's own is on
    `gorder_tpu_torch`, the pygorder namespaces are importable as modules
    of the package, and the compat namespace's names all resolve."""
    import importlib

    for name in dir(gorder_tpu):
        value = getattr(gorder_tpu, name)
        # submodules are attributes once imported; the JAX facade
        # `gorder_tpu.analysis` is not ported
        if not name.startswith("_") and not isinstance(value, type(os)):
            assert hasattr(gorder_tpu_torch, name), name
    assert gorder_tpu_torch.estimate_error is \
        gorder_tpu_torch.estimate_error_module
    for name in ("analysis_types", "estimate_error", "exceptions",
                 "geometry", "leaflets", "membrane_normal", "ordermap"):
        module = importlib.import_module(f"gorder_tpu_torch.{name}")
        assert module is getattr(gorder_tpu_torch, name)
        assert module is getattr(port_gorder, name)
        assert set(module.__all__) == set(getattr(jax_gorder,
                                                  name).__all__), name
    import gorder_tpu_torch.compat.results as results

    assert results is port_gorder.results
    assert set(port_gorder.__all__) == set(jax_gorder.__all__)
    public = {n for n in dir(jax_gorder.results) if not n.startswith("_")
              and isinstance(getattr(jax_gorder.results, n), type)}
    for name in public:
        assert hasattr(results, name), name
    assert gorder_tpu_torch.__version__ == gorder_tpu.__version__
