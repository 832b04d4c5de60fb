"""Lipid templates are found by name: a configuration's `template` is the
file `benchmark/templates/<template with "-" as "_">.py` and its
`template()`; an unknown one fails naming the file looked for; a cached
system goes stale with its own template file only; `popc-aa` is
CHARMM36m's POPC; and `aa-bilayer-256`'s inputs are still the ones its
frozen digests were made from."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from benchmark import cells, synth

#: each template's atoms, bonds, C-H bonds and SHA-256 of
#: json.dumps([names, bonds])
FROZEN = {
    "popc-aa": (134, 133, 82, "41410b881599627b197f1f3b47851302"
                              "723acdf9942aba4abe6cf0caf997fc8a"),
    "popc-cg-martini": (12, 11, 0, "3ac22007c480dc4166bc8599aaa43007"
                                   "b910184e1432ee79e0b46e5a348945b4"),
}

#: POPC atoms at their 0-based index in the molecule, as gorder's own test
#: data on a CHARMM36 membrane name them (`ordermap_POPC-C218-87--POPC-
#: H18R-88_full.dat` and the like)
UPSTREAM_INDICES = {"C22": 32, "H2R": 33, "H2S": 34, "C24": 47, "H4R": 48,
                    "H4S": 49, "C218": 87, "H18R": 88, "H18S": 89,
                    "H18T": 90}

#: SHA-256 of `aa-bilayer-256`'s structure, bonds and first 16 frames at
#: one seed, made on the CPU with ATen's default (unvectorised) kernels,
#: whose draws no host's instruction set changes
SEED = 3_141_592_653
INPUTS = {
    "structure.gro": "dee63f6d279932e9fa9b1a898ac765f0"
                     "3f057e401ff1e2c69d346da853d73ac8",
    "bonds.bnd": "8196fad3ad4335a1eb91207f4c6e8a4a"
                 "da31464fc4fb12478683ff14ada9db2f",
    "traj.xtc": "2e3a94c023d70cab1eab6f6a86435b7a"
                "e9ea9e3c7bda0af293f1fc0d6149ca79",
}

#: writes the structure, the bonds and the first 16 frames of the
#: configuration's trajectory as the benchmark makes them; prints their
#: digests
INPUTS_SCRIPT = """
import hashlib, json, sys
from pathlib import Path

root, seed, out = Path(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
sys.path.insert(0, str(root))
import torch

torch.set_num_threads(1)
from benchmark import synth, xtc

cfg = json.loads((root / "benchmark/configs/aa-bilayer-256.json").read_text())
system = synth.make_system(cfg, seed, "cpu")
files = [out / "structure.gro", out / "bonds.bnd", out / "traj.xtc"]
synth.write_structure(system, files[0], files[1])
for start, ints in synth.trajectory_chunks(system, seed, n_frames=16):
    boxes, times, steps = synth.frame_meta(cfg, start, ints.shape[0])
    xtc.append_frames(files[2], ints.numpy(), boxes, times, steps,
                      cfg["precision"], 1, append=start > 0)
print(json.dumps({f.name: hashlib.sha256(f.read_bytes()).hexdigest()
                  for f in files}))
"""


def _names():
    return sorted(p.stem.replace("_", "-")
                  for p in cells.TEMPLATES.glob("*.py"))


def _digest(names, bonds):
    return hashlib.sha256(json.dumps(
        [list(names), [list(b) for b in bonds]]).encode()).hexdigest()


@pytest.mark.parametrize("name", _names())
def test_template_found_by_name(name):
    """Each file on disk is found by its name and gives names and bonds
    within the molecule, each bond once."""
    module = cells.template_part(name)
    assert callable(module.template)
    names, bonds = module.template()
    assert names and all(isinstance(n, str) for n in names)
    pairs = {tuple(sorted(b)) for b in bonds}
    assert len(pairs) == len(bonds)
    assert all(0 <= a < b < len(names) for a, b in pairs)


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_template_unchanged(name):
    atoms, n_bonds, ch, digest = FROZEN[name]
    names, bonds = cells.template_part(name).template()
    assert (len(names), len(bonds)) == (atoms, n_bonds)
    assert sum({names[a][0], names[b][0]} == {"C", "H"}
               for a, b in bonds) == ch
    assert _digest(names, bonds) == digest


def test_popc_aa_is_charmm36m_popc():
    """C42H82NO8P as RESI POPC of top_all36_lipid.rtf: a tree of 133
    bonds, each hydrogen on one carbon, the sn-2 chain's C29=C210 with one
    hydrogen each, both esters' carbonyls with none, and the atoms at the
    indices gorder's own data gives them."""
    names, bonds = cells.template_part("popc-aa").template()
    elements = [n[0] for n in names]
    assert {e: elements.count(e) for e in "CHNOP"} == {
        "C": 42, "H": 82, "N": 1, "O": 8, "P": 1}
    assert len(set(names)) == len(names) == len(bonds) + 1
    hydrogens = {n: 0 for n in names if n[0] == "C"}
    for a, b in bonds:
        pair = sorted((names[a], names[b]), key=lambda n: n[0])
        if [p[0] for p in pair] == ["C", "H"]:
            hydrogens[pair[0]] += 1
    assert sum(hydrogens.values()) == 82
    assert [c for c, h in hydrogens.items() if h == 0] == ["C21", "C31"]
    assert [c for c, h in hydrogens.items() if h == 1] == ["C2", "C29",
                                                           "C210"]
    chains = [c for c in hydrogens if len(c) > 2]
    assert max(int(c[2:]) for c in chains if c[:2] == "C2") == 18
    assert max(int(c[2:]) for c in chains if c[:2] == "C3") == 16
    assert {n: names.index(n) for n in UPSTREAM_INDICES} == UPSTREAM_INDICES


@pytest.mark.parametrize("name", ["no-such-lipid", "no-such-lipid-2"])
def test_an_unknown_template_names_the_file(name):
    with pytest.raises(NotImplementedError) as err:
        cells.template_part(name)
    file = name.replace("-", "_")
    assert f"no benchmark/templates/{file}.py" in str(err.value)
    assert repr(name) in str(err.value)


@pytest.mark.parametrize("name", ["../reference/order", "", None, "-aa",
                                  "popc_aa", "POPC-AA"])
def test_what_is_no_template_name_fails(name):
    with pytest.raises(NotImplementedError):
        cells.template_part(name)


def test_a_cell_goes_stale_with_its_own_template_only(tmp_path, monkeypatch):
    """A new template file leaves every stamp as it was; an edit of one
    template changes the stamps of the configurations that lay it out and
    of no other."""
    for path in cells.TEMPLATES.glob("*.py"):
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(cells, "TEMPLATES", tmp_path)
    configs = {name: {"template": name} for name in FROZEN}

    def stamps():
        return {name: synth._stamp(json.dumps(cfg).encode(), 7)
                for name, cfg in configs.items()}

    before = stamps()
    (tmp_path / "popc_ua_berger.py").write_text(
        "def template():\n    return ['C1'], []\n")
    assert stamps() == before
    with open(tmp_path / "popc_aa.py", "a") as fh:
        fh.write("# edited\n")
    after = stamps()
    assert after["popc-aa"] != before["popc-aa"]
    assert after["popc-cg-martini"] == before["popc-cg-martini"]


def test_aa_bilayer_inputs_unchanged(tmp_path):
    """`aa-bilayer-256`'s structure, bonds and first 16 XTC frames at one
    seed, byte for byte, in a process on ATen's default kernels."""
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default",
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", INPUTS_SCRIPT, str(cells.ROOT), str(SEED),
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == INPUTS
