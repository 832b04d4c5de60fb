"""The plain reference finds its methods by name: a leaflet classifier, a
tagged membrane normal or an order kind planted as one file under a
reference directory is used with no other edit; a classifier sees every
frame once, in order, across chunks of uneven size; an unknown tag fails
naming the file looked for, and no test holds a method of gorder's own
grammar absent."""

import re
import shutil
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells
from benchmark.reference.order import OrderReference

#: the tags of gorder's YAML grammar (order kinds, membrane normals,
#: leaflet classifiers), each a method the reference may gain as a file
GORDER_TAGS = ("AAOrder", "CGOrder", "UAOrder", "Dynamic", "FromFile",
               "Global", "Local", "Individual", "FromMap", "FromNdx",
               "Clustering", "SphericalClustering")
#: a path to a method file of the reference, as a test would name it
METHOD_FILE = re.compile(r"reference/(kinds|normals|leaflets)/(\w+)\.py")

AA = {"!": "AAOrder", "heavy_atoms": "resname LIP and name r'^C'",
      "hydrogens": "resname LIP and name r'^H'"}

#: classes that alternate by molecule and frame, counting frames over
#: every chunk; it records each frame's y offset of atom 0
ALTERNATE = """
import torch


class Alternate:
    def __init__(self, spec, view):
        self.n = len(view.molecules)
        self.device = view.device
        self.frame = 0
        self.seen = []

    def classes(self, ints):
        f = ints.shape[0]
        self.seen += ints[:, 0, 1].tolist()
        frames = torch.arange(self.frame, self.frame + f, device=self.device)
        self.frame += f
        mols = torch.arange(self.n, device=self.device)
        return (frames[:, None] + mols[None, :]) % 2


build = Alternate
"""

#: the spec's fixed axis as every molecule's normal
FIXED = """
import torch


class Fixed:
    def __init__(self, spec, view):
        self.axis = torch.tensor(spec["axis"], dtype=view.dtype,
                                 device=view.device)
        self.n = len(view.molecules)

    def normals(self, ints):
        return self.axis.expand(ints.shape[0], self.n, 3)


build = Fixed
"""

#: a kind whose vector is no atom pair: a heavy atom's two hydrogens'
#: bisector, H1 + H2 - 2 C, each offset under the minimum image
BISECTOR = """
import torch

from benchmark.reference.bonds import PairBonds


class BisectorOrder(PairBonds):
    sign = -1.0

    def __init__(self, spec, view):
        heavy = set(view.select(spec["heavy_atoms"]))
        hyd = set(view.select(spec["hydrogens"]))
        partners = {}
        for a, b in view.bonds:
            if a in heavy and b in hyd:
                partners.setdefault(int(a), []).append(int(b))
        super().__init__([(c, hs[0]) for c, hs in sorted(partners.items())
                          if len(hs) == 2], view)
        second = {c: hs[1] for c, hs in partners.items()}
        self.atom_c = torch.as_tensor(
            [second[int(c)] for c in self.atom_a.tolist()], device=view.device)

    def vectors(self, ints):
        d = (ints.index_select(1, self.atom_c).to(torch.int64)
             - ints.index_select(1, self.atom_a).to(torch.int64)).double()
        d = d - self.box * torch.round(d / self.box)
        return super().vectors(ints) + d / self.precision

    def entries(self, name, ids):
        for t in ids:
            yield (name, "order parameters", self.types[t][3]), [t]


build = BisectorOrder
"""


def _two_lipids(offsets):
    """Two C1(H1 H2)C2 lipids in a 10 nm box (molecule 1 across the x
    edge), one frame a y offset of every atom."""
    names = ["C1", "H1", "H2", "C2"] * 2
    molecule = np.repeat([0, 1], 4)
    bonds = np.array([[0, 1], [0, 2], [0, 3], [4, 5], [4, 6], [4, 7]])
    frame = np.array([[1000, 1000, 1000], [1000, 1000, 1100],
                      [1100, 1000, 1000], [900, 1000, 1000],
                      [9950, 5000, 5000], [50, 5000, 5100],
                      [9950, 5100, 5000], [9850, 5000, 5000]])
    ints = np.stack([frame + [0, dy, 0] for dy in offsets])
    return (names, ["LIP"] * 8, molecule, bonds,
            torch.tensor(ints, dtype=torch.int32))


def _reference(gorder, system):
    names, resnames, molecule, bonds, _ = system
    return OrderReference(names, resnames, molecule, bonds, [10.0] * 3,
                          1000.0, gorder, "cpu")


def _fed(ref, ints, chunks):
    start = 0
    for n in chunks:
        ref.add(ints[start:start + n])
        start += n
    assert start == ints.shape[0]
    return ref.values()


@pytest.fixture
def planted(tmp_path, monkeypatch):
    """A reference directory with the real kinds and the planted modules,
    the lookup pointed at it."""
    shutil.copytree(cells.REFERENCE / "kinds", tmp_path / "kinds")
    for rel, source in (("leaflets/alternate.py", ALTERNATE),
                        ("normals/fixed.py", FIXED),
                        ("kinds/bisector_order.py", BISECTOR)):
        (tmp_path / rel).parent.mkdir(exist_ok=True)
        (tmp_path / rel).write_text(textwrap.dedent(source))
    monkeypatch.setattr(cells, "REFERENCE", tmp_path)
    return tmp_path


@pytest.mark.parametrize("tag, name", [
    ("SphericalClustering", "spherical_clustering"), ("AAOrder", "aa_order"),
    ("CGOrder", "cg_order"), ("UAOrder", "ua_order"), ("Dynamic", "dynamic"),
    ("Clustering", "clustering"), ("Local", "local")])
def test_tags_in_snake_case(tag, name):
    assert cells.snake_case(tag) == name


def test_a_planted_classifier_sees_every_frame_once_in_order(planted):
    offsets = [10 * f for f in range(9)]
    system = _two_lipids(offsets)
    ref = _reference({"type": AA, "membrane_normal": "z",
                      "leaflets": {"!": "Alternate"}}, system)
    got = _fed(ref, system[-1], [2, 1, 3, 1, 2])
    assert ref.leaflets.seen == [1000 + dy for dy in offsets]
    assert ref.classes == ("total", "upper", "lower")
    # C1-H1: S = 1 in molecule 0, 0.25 in molecule 1; molecule 0 is upper
    # in the 5 even frames of 9, molecule 1 in the 4 odd ones
    bond = ("LIP", "order parameters", "LIP C1 (0)", "bonds", "LIP H1 (1)")
    assert got[bond + ("total",)] == -0.625
    assert got[bond + ("upper",)] == pytest.approx(-(5 + 4 * 0.25) / 9,
                                                   abs=1e-12)
    assert got[bond + ("lower",)] == pytest.approx(-(4 + 5 * 0.25) / 9,
                                                   abs=1e-12)


def test_a_planted_normal_is_used(planted):
    system = _two_lipids([0, 10, 20])
    fixed = _fed(_reference({"type": AA, "membrane_normal": {
        "!": "Fixed", "axis": [1.0, 0.0, 0.0]}}, system), system[-1],
        [1, 2])
    plain = _fed(_reference({"type": AA, "membrane_normal": "x"}, system),
                 system[-1], [3])
    assert fixed == plain
    # C1-H1 against x: S = -0.5 in molecule 0, 0.25 in molecule 1
    bond = ("LIP", "order parameters", "LIP C1 (0)", "bonds", "LIP H1 (1)",
            "total")
    assert fixed[bond] == 0.125


def test_a_planted_kind_is_used(planted):
    system = _two_lipids([0, 10])
    ref = _reference({"type": dict(AA, **{"!": "BisectorOrder"})}, system)
    got = _fed(ref, system[-1], [2])
    # the bisectors: (1, 0, 1) in molecule 0 (S = 0.25), (1, 1, 1) across
    # the x edge in molecule 1 (S = 0)
    assert got == {("average order", "total"): -0.125,
                   ("LIP", "average order", "total"): -0.125,
                   ("LIP", "order parameters", "LIP C1 (0)", "total"):
                   -0.125}


#: (key, tagged value, file looked for) of tags that no gorder method has:
#: a method of gorder's own grammar may gain its file at any time
UNKNOWN_METHODS = [
    ("type", {"!": "NoSuchKind", "saturated": "name C2"},
     "benchmark/reference/kinds/no_such_kind.py"),
    ("membrane_normal", {"!": "NoSuchNormal", "file": "normals.yaml"},
     "benchmark/reference/normals/no_such_normal.py"),
    ("leaflets", {"!": "NoSuchLeaflets", "heads": "name C1"},
     "benchmark/reference/leaflets/no_such_leaflets.py"),
    ("leaflets", {"!": "NoSuchClassifier", "heads": "name C1",
                  "radius": 2.5},
     "benchmark/reference/leaflets/no_such_classifier.py")]


@pytest.mark.parametrize("key, spec, file", UNKNOWN_METHODS)
def test_an_unknown_method_names_the_file(key, spec, file):
    gorder = {"type": AA, key: spec}
    with pytest.raises(NotImplementedError) as err:
        _reference(gorder, _two_lipids([0]))
    assert f"no {file}" in str(err.value) and repr(spec) in str(err.value)


@pytest.mark.parametrize("key, spec, file", UNKNOWN_METHODS,
                         ids=[spec["!"] for _, spec, _ in UNKNOWN_METHODS])
def test_no_unknown_method_is_a_gorder_tag(key, spec, file):
    """No unknown-method case uses a tag of gorder's YAML grammar; the
    file scan below is the one check on the files looked for."""
    assert spec["!"] not in GORDER_TAGS


def test_no_test_names_a_missing_gorder_method_file():
    """No test file names the reference file of one of gorder's methods
    that is not on disk: what a test would hold absent, a later method
    file would contradict."""
    methods = {cells.snake_case(t) for t in GORDER_TAGS}
    named = [(test.name, match.group(0)) for test in sorted(
        Path(__file__).parent.glob("*.py"))
        for match in METHOD_FILE.finditer(test.read_text())
        if match.group(2) in methods]
    assert [(test, rel) for test, rel in named
            if not (cells.REFERENCE.parent / rel).is_file()] == []


@pytest.mark.parametrize("gorder", [
    {"type": AA, "membrane_normal": [0.0, 0.0, 1.0]},
    {"type": AA, "leaflets": {"heads": "name C1"}},
    {"type": AA, "leaflets": {"!": "../kinds/aa_order"}},
    {"type": AA, "map": {"bin_size": [0.1, 0.1]}}])
def test_what_the_reference_cannot_read_fails(gorder):
    with pytest.raises(NotImplementedError):
        _reference(gorder, _two_lipids([0]))
