"""The analysis set-up's whole-array passes in gorder_tpu_torch, on the CPU,
each held against its `gorder_tpu` counterpart (the per-line and per-atom
loops they replace):

- `io/gro.py read_gro`: equal `System`s, array for array and dtype for
  dtype, on regular GRO files (fixed columns) and on every file the
  columns refuse (the per-line loop), errors word for word;
- `io/bnd.py parse_bnd`: equal bonds from `target partner...` lines with
  `#` comments in one pass and from everything else line by line, errors
  word for word and from the same pair;
- `select/select.py`: `connected_components` gives the same partition,
  `select_mask` the same masks (regexes once per distinct string, which
  `system.distinct_strings` finds);
- `topology/classify.py`: `classify_molecules` the same kinds (order,
  names, instances, bond types, order atoms) and `compile_bonds` the
  same arrays on AA, CG and UA systems, shuffled and mixed ones too;
- the counter `slow_parse_lines`: 0 on regular files, the lines the
  loops parsed otherwise.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from gorder_tpu.io import bnd as jax_bnd
from gorder_tpu.io import gro as jax_gro
from gorder_tpu.select.select import connected_components as jax_components
from gorder_tpu.select.select import select_mask as jax_select_mask
from gorder_tpu.topology import classify as jax_classify
from gorder_tpu_torch.errors import BondsError, StructureError
from gorder_tpu_torch.io import bnd, gro
from gorder_tpu_torch.select.select import connected_components, select_mask
from gorder_tpu_torch.system import canonical_bonds, distinct_strings
from gorder_tpu_torch.topology import classify
from gorder_tpu_torch.utils.timers import timers

_ROOT = Path(__file__).resolve().parents[1]

# ------------------------------------------------------------------ systems


def _atom_line(resid, resname, name, serial, values, fmt="8.3f"):
    return (f"{resid % 100000:>5d}{resname:<5.5s}{name:>5.5s}"
            f"{serial % 100000:>5d}" + "".join(f"{v:{fmt}}" for v in values))


def _gro_text(lines, box="   3.00000   3.00000   3.00000", title="t"):
    return "\n".join([title, f"{len(lines):>5d}", *lines, box]) + "\n"


def _hand_lines(n=12, values=3, start=1, fmt="8.3f"):
    rng = np.random.default_rng(n + values + start)
    out = []
    for i in range(n):
        v = rng.uniform(-9, 99, values)
        out.append(_atom_line(start + i // 3, "POPC" if i < 9 else "SOL",
                              ("C1", "H11", "C 2")[i % 3], start + i, v, fmt))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name → (gro, bnd) paths: the systems the cases read."""
    d = tmp_path_factory.mktemp("setup_arrays")
    out = {}

    from benchmark import synth

    with open(_ROOT / "benchmark" / "configs" / "aa-bilayer-256.json") as fh:
        cfg = json.load(fh)
    cfg.update(n_lipids=8, total_atoms=8 * 118 + 300)
    system = synth.make_system(cfg, 2 ** 31 + 11, "cpu")
    out["aa-bilayer-256"] = (d / "bench.gro", d / "bench.bnd")
    synth.write_structure(system, *out["aa-bilayer-256"])

    gro_path, bnd_path, _ = chip_smoke.synthesize_structure(
        str(tmp_path_factory.mktemp("smoke")), n_lipids=6,
        total_atoms=6 * 134 + 60)
    out["chip_smoke"] = (gro_path, bnd_path)
    ua_gro, ua_bnd, _ = chip_smoke.synthesize_ua(
        str(tmp_path_factory.mktemp("ua")), 1, n_lipids=6, total_atoms=6 * 51 + 90)
    out["ua"] = (ua_gro, ua_bnd)
    cg_gro, cg_bnd, _ = chip_smoke.synthesize_cg(
        str(tmp_path_factory.mktemp("cg")), 1, n_lipids=8, total_atoms=8 * 12 + 40)
    out["cg"] = (cg_gro, cg_bnd)
    out["shuffled"] = _shuffled(d, *out["chip_smoke"])
    out["mixed"] = _mixed(d, *out["chip_smoke"])
    return {k: (str(g), str(b)) for k, (g, b) in out.items()}


def _read_port(gro_path, bnd_path):
    system = gro.read_gro(gro_path)
    bnd.read_bnd(bnd_path, system)
    return system


def _read_jax(gro_path, bnd_path):
    system = jax_gro.read_gro(gro_path)
    jax_bnd.read_bnd(bnd_path, system)
    return system


def _shuffled(d, gro_path, bnd_path):
    """The AA system with its atoms in a random order: molecules spread
    over the whole index range, residues split up."""
    s = _read_port(gro_path, bnd_path)
    perm = np.random.default_rng(5).permutation(s.n_atoms)
    where = np.empty_like(perm)
    where[perm] = np.arange(s.n_atoms)
    lines = [_atom_line(int(s.resids[i]), str(s.resnames[i]),
                        str(s.atom_names[i]), k + 1, s.positions[i])
             for k, i in enumerate(perm)]
    g, b = d / "shuffled.gro", d / "shuffled.bnd"
    g.write_text(_gro_text(lines))
    b.write_text("".join(f"{where[x] + 1} {where[y] + 1}\n"
                         for x, y in s.bonds))
    return g, b


def _mixed(d, gro_path, bnd_path):
    """The AA system with a bond added to the second lipid (its atoms
    unchanged), an atom of the third renamed and a bond of the fourth
    dropped: four POPC topologies, named POPC1 to POPC4."""
    s = _read_port(gro_path, bnd_path)
    first = [int(np.nonzero(s.resids == s.resids[0] + k)[0][0])
             for k in range(4)]
    names = s.atom_names.copy()
    names[first[2]] = "CX"
    bonds = {tuple(b) for b in s.bonds.tolist()}
    extra = next((first[1], first[1] + k) for k in range(2, 40)
                 if (first[1], first[1] + k) not in bonds)
    dropped = next(b for b in sorted(bonds) if b[0] >= first[3])
    bonds = sorted((bonds | {extra}) - {dropped})
    lines = [_atom_line(int(s.resids[i]), str(s.resnames[i]), str(names[i]),
                        i + 1, s.positions[i]) for i in range(s.n_atoms)]
    g, b = d / "mixed.gro", d / "mixed.bnd"
    g.write_text(_gro_text(lines))
    b.write_text("".join(f"{x + 1} {y + 1}\n" for x, y in bonds))
    return g, b


# ---------------------------------------------------------------------- GRO


def _hand_gro(case):
    """(GRO text, parsed by the columns)."""
    if case == "velocities":
        return _gro_text(_hand_lines(values=6, fmt="8.4f")), True
    if case == "four-values":
        return _gro_text(_hand_lines(values=4)), True
    if case == "seven-values":
        return _gro_text(_hand_lines(values=7)), True
    if case == "triclinic":
        box = " ".join(f"{v:10.5f}" for v in
                       (3.0, 3.1, 3.2, 0.0, 0.0, 0.4, 0.0, 0.5, 0.6))
        return _gro_text(_hand_lines(), box=box), True
    if case == "wrapped-at-100000":
        return _gro_text(_hand_lines(n=15, start=99_990)), True
    if case == "negative-numbers":
        lines = _hand_lines()
        lines[0] = "   -5" + lines[0][5:15] + "   -1" + lines[0][20:]
        return _gro_text(lines), True
    if case == "ragged":
        lines = _hand_lines()
        lines[4] = lines[4] + "  "
        return _gro_text(lines), False
    if case == "mixed-value-counts":
        lines = _hand_lines(values=6)
        lines[2] = lines[2][:44] + " " * 24
        return _gro_text(lines), False
    if case == "plus-signs":
        lines = _hand_lines()
        lines[1] = "   +1" + lines[1][5:]
        return _gro_text(lines), False
    if case == "non-ascii-name":
        lines = _hand_lines()
        lines[3] = lines[3][:10] + "  Cα1" + lines[3][15:]
        return _gro_text(lines), False
    if case == "underscore-number":
        lines = _hand_lines()
        lines[5] = lines[5][:20] + "   1_000" + lines[5][28:]
        return _gro_text(lines), False
    raise KeyError(case)


_HAND_GRO = ["velocities", "four-values", "seven-values", "triclinic",
             "wrapped-at-100000", "negative-numbers", "ragged",
             "mixed-value-counts", "plus-signs", "non-ascii-name",
             "underscore-number"]


def _assert_same_system(port, ref):
    assert port.name == ref.name
    for key in ("atom_names", "resids", "resnames", "serials", "positions",
                "box"):
        a, b = getattr(port, key), getattr(ref, key)
        assert a.dtype == b.dtype, key
        assert a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    if ref.velocities is None:
        assert port.velocities is None
    else:
        assert port.velocities.dtype == ref.velocities.dtype
        np.testing.assert_array_equal(port.velocities, ref.velocities)


def _slow_lines(fn, *args):
    timers.reset()
    out = fn(*args)
    return out, timers.counters().get("slow_parse_lines")


@pytest.mark.parametrize("name", ["aa-bilayer-256", "chip_smoke", "ua",
                                  "cg", "shuffled"])
def test_read_gro_of_a_synthesized_system(files, name):
    path = files[name][0]
    port, slow = _slow_lines(gro.read_gro, path)
    _assert_same_system(port, jax_gro.read_gro(path))
    assert slow == 0


@pytest.mark.parametrize("case", _HAND_GRO)
def test_read_gro_of_a_written_file(tmp_path, case):
    text, by_columns = _hand_gro(case)
    path = tmp_path / "s.gro"
    path.write_text(text, encoding="utf-8")
    port, slow = _slow_lines(gro.read_gro, str(path))
    _assert_same_system(port, jax_gro.read_gro(str(path)))
    assert slow == (0 if by_columns else len(text.splitlines()) - 3)


def _broken_gro(case):
    lines = _hand_lines()
    if case == "letters-in-resid":
        lines[2] = "  x1" + lines[2][4:]
    elif case == "blank-serial":
        lines[6] = lines[6][:15] + "     " + lines[6][20:]
    elif case == "letters-in-position":
        lines[7] = lines[7][:28] + "     abc" + lines[7][36:]
    elif case == "two-values":
        lines = [ln[:36] for ln in lines]
    elif case == "two-values-on-one-line":
        lines[5] = lines[5][:36] + " " * 8
    elif case == "no-values":
        lines = [ln[:20] + " " * 24 for ln in lines]
    elif case == "merged-values":
        lines[3] = lines[3][:28] + "-100.000-100.000"
    elif case == "bad-box":
        return _gro_text(lines, box="   3.0   x   3.0")
    elif case == "box-of-two":
        return _gro_text(lines, box="   3.0   3.0")
    elif case == "fewer-lines":
        return "\n".join(_gro_text(lines).splitlines()[:8]) + "\n"
    elif case == "bad-count":
        return _gro_text(lines).replace("   12", "  1x2", 1)
    elif case == "too-short":
        return "t\n"
    else:
        raise KeyError(case)
    return _gro_text(lines)


@pytest.mark.parametrize("case", [
    "letters-in-resid", "blank-serial", "letters-in-position", "two-values",
    "two-values-on-one-line", "no-values", "merged-values", "bad-box",
    "box-of-two", "fewer-lines", "bad-count", "too-short"])
def test_read_gro_errors_word_for_word(tmp_path, case):
    path = tmp_path / "s.gro"
    path.write_text(_broken_gro(case))
    with pytest.raises(StructureError) as port:
        gro.read_gro(str(path))
    with pytest.raises(Exception) as ref:
        jax_gro.read_gro(str(path))
    assert type(ref.value).__name__ == "StructureError"
    assert str(port.value) == str(ref.value)


def test_read_gro_of_a_missing_file(tmp_path):
    path = str(tmp_path / "none.gro")
    with pytest.raises(StructureError) as port:
        gro.read_gro(path)
    with pytest.raises(Exception) as ref:
        jax_gro.read_gro(path)
    assert str(port.value) == str(ref.value)


# -------------------------------------------------------------------- bonds

_BND = {
    "two-a-line": ("1 2\n2 3\n4 5\n", True),
    "several-partners": ("1 2 3 4\n2 5\n6 7 8\n", True),
    "comments": ("# header\n1 2 # a comment\n3 4\n#\n", True),
    "partners-and-comments": ("# target partners\n1 2 3 # head\n"
                              "4 5#x\n6 # alone\n7 8 9 10\n", True),
    "comment-not-ascii": ("# Cα–Hβ bonds\n1 2 3\n", True),
    "duplicates": ("1 2\n2 1\n1 2\n5 4\n", True),
    "blank-lines-tabs-crlf": ("\n1\t2\r\n\r\n  3 4  \n\n", True),
    "leading-zeros": ("001 002\n0010 9\n", True),
    "single-numbers": ("5\n1 2\n", True),
    "empty": ("", True),
    "only-a-comment": ("# nothing\n", True),
    "words-on-short-lines": ("x\n1 2\n", False),
    "line-end-in-a-comment": ("1 2 # a\x0c3 4\n", False),
    "a-sign": ("1 +2\n", False),
}


@pytest.mark.parametrize("case", sorted(_BND))
def test_parse_bnd_of_a_written_file(tmp_path, case):
    text, one_pass = _BND[case]
    path = tmp_path / "b.bnd"
    path.write_text(text)
    port, slow = _slow_lines(bnd.parse_bnd, str(path), 10)
    ref = jax_bnd.parse_bnd(str(path), 10)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)
    assert slow == (0 if one_pass else len(text.splitlines()))


@pytest.mark.parametrize("name", ["aa-bilayer-256", "chip_smoke", "ua",
                                  "cg", "shuffled"])
def test_parse_bnd_of_a_synthesized_system(files, name):
    gro_path, bnd_path = files[name]
    n = gro.read_gro(gro_path).n_atoms
    port, slow = _slow_lines(bnd.parse_bnd, bnd_path, n)
    ref = jax_bnd.parse_bnd(bnd_path, n)
    assert port.dtype == ref.dtype
    np.testing.assert_array_equal(port, ref)
    assert slow == 0


@pytest.mark.parametrize("text", [
    "1 2\n11 3\n",                 # target past the end
    "0 2\n",                       # target 0
    "1 2\n3 99\n",                 # partner past the end
    "3 0\n",                       # partner 0
    "3 3\n",                       # self-bond
    "1 2\n4 4\n5 99\n",            # the first fault is the self-bond
    "1 2\n5 99\n4 4\n",            # the first fault is the partner
    "11 11\n",                     # the target before the self-bond
    "1 abc\n",                     # not a number
    "1 2 99\n",                    # several partners, one past the end
    "1 2 2 1\n",                   # several partners, a self-bond last
    "1 12345678901234567890\n",    # too long for int64
    "1 -2\n",                      # a minus
    "99999 2\n",
    "# c\n1 2 3 # x\n4 5 4\n",    # a self-bond after comments
    "1 2\n5 # 99\n6 7 99 3\n",   # a partner past the end, in the middle
    "1 2 3\n11 # 4\n12 1 2\n",   # a lone number is no target; then one
])
def test_parse_bnd_errors_word_for_word(tmp_path, text):
    path = tmp_path / "b.bnd"
    path.write_text(text)
    with pytest.raises(BondsError) as port:
        bnd.parse_bnd(str(path), 10)
    with pytest.raises(Exception) as ref:
        jax_bnd.parse_bnd(str(path), 10)
    assert type(ref.value).__name__ == "BondsError"
    assert str(port.value) == str(ref.value)


def test_parse_bnd_of_a_missing_file(tmp_path):
    path = str(tmp_path / "none.bnd")
    with pytest.raises(BondsError) as port:
        bnd.parse_bnd(path, 10)
    with pytest.raises(Exception) as ref:
        jax_bnd.parse_bnd(path, 10)
    assert str(port.value) == str(ref.value)


# --------------------------------------------------------------- molecules


def _same_partition(a, b):
    pairs = np.unique(np.stack([a, b], axis=1), axis=0)
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


def _graph(case, n=400):
    rng = np.random.default_rng(17)
    if case == "random-sparse":
        return n, rng.integers(0, n, (n // 2, 2))
    if case == "random-dense":
        return n, rng.integers(0, n, (3 * n, 2))
    if case == "path-descending":
        return n, np.stack([np.arange(n - 1, 0, -1),
                            np.arange(n - 2, -1, -1)], axis=1)
    if case == "path-shuffled":
        p = rng.permutation(n)
        return n, np.stack([p[:-1], p[1:]], axis=1)
    if case == "star-last-centre":
        return n, np.stack([np.full(n - 1, n - 1), np.arange(n - 1)], axis=1)
    if case == "no-bonds":
        return n, np.zeros((0, 2), np.int64)
    if case == "no-atoms":
        return 0, np.zeros((0, 2), np.int64)
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "random-sparse", "random-dense", "path-descending", "path-shuffled",
    "star-last-centre", "no-bonds", "no-atoms"])
def test_connected_components_of_a_graph(case):
    n, pairs = _graph(case)
    bonds = canonical_bonds(np.asarray(pairs, np.int64))
    port = connected_components(n, bonds)
    ref = jax_components(n, bonds)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    assert _same_partition(port, ref)
    # numbered in the order of each component's first atom
    _, first = np.unique(port, return_index=True)
    assert (np.diff(first) > 0).all()


@pytest.mark.parametrize("name", ["aa-bilayer-256", "chip_smoke", "ua",
                                  "cg", "shuffled", "mixed"])
def test_connected_components_of_a_system(files, name):
    s = _read_port(*files[name])
    port = connected_components(s.n_atoms, s.bonds)
    ref = jax_components(s.n_atoms, s.bonds)
    assert _same_partition(port, ref)


# ---------------------------------------------------------------- selection

_QUERIES = [
    "name C21",
    "name r'^C'",
    "name r'^H' C21",
    "resname POPC",
    "resname r'^PO' and name r'^H'",
    "resname POPC and name r'^C'",
    "name r'^(C2|H2)' or resname r'SOL|TIP'",
    "not name r'^O'",
    "molwith name P",
    "molwith resname r'^PO'",
    "molwith (name r'^C3' and resid 2)",
    "element name carbon",
    "element symbol r'^H'",
    "name r'[' C21",
]


@pytest.mark.parametrize("query", _QUERIES)
@pytest.mark.parametrize("name", ["chip_smoke", "shuffled"])
def test_select_mask_equal(files, name, query):
    port = _read_port(*files[name])
    ref = _read_jax(*files[name])
    if query.endswith("'[' C21"):
        with pytest.raises(Exception) as a:
            select_mask(port, query)
        with pytest.raises(Exception) as b:
            jax_select_mask(ref, query)
        assert str(a.value) == str(b.value)
        return
    np.testing.assert_array_equal(select_mask(port, query),
                                  jax_select_mask(ref, query))


@pytest.mark.parametrize("dtype", ["U8", "U4", "U12", "U20", "O", "S5",
                                   "S8", "S12"])
def test_distinct_strings(dtype):
    """Distinct strings and the inverse for short Latin-1 and byte strings
    (the 8-byte path) and for everything else (`np.unique`)."""
    words = ["C1", "C1 ", "", "Hé11", "Cα", "C±", "ABCDEFGH", "a",
             "C1", "", "zz", " C1"]
    if dtype.startswith("S"):
        words = [w.encode("latin-1") for w in words if w.isascii()]
    data = np.array(words * 3, dtype=dtype)
    distinct, inverse = distinct_strings(data)
    assert len(distinct) == len(set(data.tolist()))
    assert list(distinct[inverse]) == list(data)


# ----------------------------------------------------------------- topology


def _kinds_as_dicts(kinds):
    return [dataclasses.asdict(k) for k in kinds]


def _masks(system, mask_of, name):
    if name == "cg":
        return (mask_of(system, "resname POPC"),), "bonds"
    if name == "ua":
        return (mask_of(system, "resname POPC and name r'^C'"),), "atoms"
    return (mask_of(system, chip_smoke.HEAVY),
            mask_of(system, chip_smoke.HYDROGENS)), "bonds"


@pytest.mark.parametrize("name", ["aa-bilayer-256", "chip_smoke", "ua",
                                  "cg", "shuffled", "mixed"])
def test_classify_and_compile_equal(files, name):
    port_system = _read_port(*files[name])
    ref_system = _read_jax(*files[name])
    masks, mode = _masks(port_system, select_mask, name)
    ref_masks, _ = _masks(ref_system, jax_select_mask, name)
    port = classify.classify_molecules(port_system, *masks, mode=mode)
    ref = jax_classify.classify_molecules(ref_system, *ref_masks, mode=mode)
    assert port and _kinds_as_dicts(port) == _kinds_as_dicts(ref)
    if name == "mixed":
        assert [(k.name, k.n_molecules) for k in port] == [
            ("POPC1", 3), ("POPC2", 1), ("POPC3", 1), ("POPC4", 1)]
    if name == "shuffled":
        assert len(port) > 1
    if mode == "bonds":
        a, b = classify.compile_bonds(port), jax_classify.compile_bonds(ref)
        for field in dataclasses.fields(a):
            x, y = getattr(a, field.name), getattr(b, field.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, field.name
                np.testing.assert_array_equal(x, y, err_msg=field.name)
            else:
                assert x == y, field.name


def test_classify_with_a_second_group_of_its_own(files):
    """CG with the second group another selection: bonds from group 1 to
    group 2 only, oriented group 1 first."""
    port_system = _read_port(*files["cg"])
    ref_system = _read_jax(*files["cg"])
    queries = ("resname POPC and name r'^[CG]'", "resname POPC")
    port = classify.classify_molecules(
        port_system, *(select_mask(port_system, q) for q in queries),
        mode="bonds")
    ref = jax_classify.classify_molecules(
        ref_system, *(jax_select_mask(ref_system, q) for q in queries),
        mode="bonds")
    assert port and _kinds_as_dicts(port) == _kinds_as_dicts(ref)


# ---------------------------------------------------------------- whole run


@pytest.mark.parametrize("ragged", [False, True])
def test_a_run_counts_its_slow_lines(tmp_path, ragged):
    """A whole analysis: the phase line carries `slow_parse_lines`, 0 for
    the regular files a writer of fixed columns makes, every atom line
    for a GRO whose lines differ in length."""
    from gorder_tpu_torch.engine.drivers import run_analysis
    from gorder_tpu_torch.input.config import Analysis, AnalysisType

    from .synthetic import make_flat_bilayer

    gro_path, bnd_path, xtc = make_flat_bilayer(tmp_path, n_frames=4)
    n_atoms = gro.read_gro(gro_path).n_atoms
    if ragged:
        with open(gro_path) as fh:
            lines = fh.read().splitlines()
        lines[2] += "   "
        with open(gro_path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    out = tmp_path / "o.yaml"
    run_analysis(Analysis(structure=gro_path, bonds=bnd_path, trajectory=xtc,
                          analysis_type=AnalysisType.cgorder("resname POPC"),
                          output_yaml=str(out), silent=True, overwrite=True),
                 "cpu").write()
    assert timers.counters()["slow_parse_lines"] == (n_atoms if ragged
                                                     else 0)
    assert f"slow_parse_lines {n_atoms if ragged else 0}" in timers.summary()
