"""The port's own copy of the host code stands alone: its codec, built
from `gorder_tpu_torch/native/xdr.cpp`, decodes like `gorder_tpu`'s; its
`Analysis.run` runs the port, never the JAX engine; and what
`chip_smoke.py` runs loads no file of `gorder_tpu/`."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from gorder_tpu.io.traj import Trajectory as JaxTrajectory
from gorder_tpu_torch.engine import drivers
from gorder_tpu_torch.io import native
from gorder_tpu_torch.io.traj import AtomSubset, Trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh(code):
    """Run `code` in a fresh interpreter from the repository root."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


_NO_JAX_PACKAGE = (
    "import os, sys\n"
    f"jax_pkg = os.path.join({ROOT!r}, 'gorder_tpu') + os.sep\n"
    "shared = [m for m, mod in list(sys.modules.items())\n"
    "          if (getattr(mod, '__file__', None) or '').startswith(jax_pkg)]\n"
    "assert not shared, shared\n"
    "assert 'jax' not in sys.modules and 'gorder_tpu' not in sys.modules\n"
)


@pytest.fixture(scope="module")
def aa_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("aa"))
    gro, bnd, system = chip_smoke.synthesize_structure(
        d, n_lipids=4, total_atoms=4 * 134 + 60)
    return gro, bnd, chip_smoke.synthesize_trajectory(d, system, 40), system


def test_codec_builds_from_the_copy():
    path = native._build_library()
    assert path.parent == native._NATIVE_DIR.parent / "_build"
    assert str(path).startswith(os.path.join(ROOT, "gorder_tpu_torch", ""))
    assert native._SRC == native._NATIVE_DIR / "xdr.cpp"
    assert str(native._SRC).startswith(os.path.join(ROOT, "gorder_tpu_torch",
                                                    "native", ""))


def test_copied_codec_decodes_like_gorder_tpu(aa_files):
    """The same frames through both codecs: f32 and int16 positions, the b7
    wire with its aux and COG side channels, and the standalone COG pass,
    on a subset of atoms."""
    _, _, xtc, system = aa_files
    n = system.n_atoms
    rng = np.random.default_rng(0)
    atoms = np.sort(rng.choice(n, 300, replace=False))
    frames = np.arange(0, 40, 3)
    port, ref = Trajectory([xtc], expected_atoms=n), \
        JaxTrajectory([xtc], expected_atoms=n)
    space = AtomSubset.from_indices(atoms)
    from gorder_tpu.io.traj import AtomSubset as JaxAtomSubset
    jspace = JaxAtomSubset.from_indices(atoms)

    got, want = port.read_frames(frames, space), ref.read_frames(frames,
                                                                 jspace)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = port.read_frames_quantized(frames, space)
    want = ref.read_frames_quantized(frames, jspace)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    a = rng.integers(0, len(atoms), 200).astype(np.int32)
    b = rng.integers(0, len(atoms), 200).astype(np.int32)
    aux_slots = np.arange(0, len(atoms), 7, dtype=np.int32)
    cog_slots = np.arange(len(atoms), dtype=np.int32)
    outs = []
    for traj, sp in ((port, space), (ref, jspace)):
        stride = native.b7_stride(len(a))
        buf = (np.zeros((len(frames), stride), np.uint8),
               np.zeros((len(frames), 1024), np.uint16),
               np.zeros((len(frames), 1024), np.int16),
               np.zeros((len(frames), len(aux_slots), 3), np.int32),
               np.zeros(len(frames), np.float32))
        res, nesc = traj.read_frames_b7(
            frames, sp, a, b, *buf[:3], aux_slots=aux_slots,
            aux_out=buf[3], cog_slots=cog_slots, cog_axis=2,
            cog_out=buf[4])
        assert res is not None
        cog = np.zeros(len(frames), np.float32)
        assert traj.read_cog_axis(frames, sp, cog_slots, 2, cog)
        outs.append((res, nesc, buf, cog))
    (res, nesc, buf, cog), (jres, jnesc, jbuf, jcog) = outs
    assert nesc == jnesc
    for g, w in zip(res + buf, jres + jbuf):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(cog, jcog)
    np.testing.assert_array_equal(cog, buf[4])   # the same COG either way


def test_analysis_run_is_the_ports(aa_files, tmp_path, monkeypatch):
    """`Analysis.run()` calls the port's driver on the card by default;
    `run(device="cpu")` is `gorder_tpu_torch.run(a, "cpu")`."""
    gro, bnd, xtc, _ = aa_files
    a = chip_smoke.aa_analysis(gro, bnd, xtc, str(tmp_path / "o.yaml"))
    calls = []
    real = drivers.run_analysis
    monkeypatch.setattr(drivers, "run_analysis",
                        lambda an, dev, **kw: calls.append(dev) or real(
                            an, "cpu", **kw))
    a.run()
    a.run(device="cpu")
    assert calls == ["cuda", "cpu"]


def test_analysis_run_without_card_raises_and_loads_no_jax(aa_files,
                                                          tmp_path):
    """Without a card the default device raises for `run` and
    `run_partial`; a merge is host work, and of no state it raises that
    the states cover no frame."""
    gro, bnd, xtc, _ = aa_files
    out = tmp_path / "o.yaml"
    printed = _fresh(
        "import torch\n"
        "if torch.cuda.is_available():\n"
        "    raise SystemExit(0)  # the default device works here\n"
        "import gorder_tpu_torch as g\n"
        f"a = g.Analysis(structure={gro!r}, bonds={bnd!r},\n"
        f"               trajectory={xtc!r}, output_yaml={str(out)!r},\n"
        "               analysis_type=g.AnalysisType.aaorder(\n"
        f"                   {chip_smoke.HEAVY!r},\n"
        f"                   {chip_smoke.HYDROGENS!r}),\n"
        "               silent=True)\n"
        "for call in (a.run, lambda: a.run_partial(0, 2),\n"
        "             lambda: a.merge([])):\n"
        "    try:\n"
        "        call()\n"
        "    except g.AnalysisError as e:\n"
        "        print(e)\n"
        "    else:\n"
        "        raise AssertionError('no AnalysisError')\n"
        + _NO_JAX_PACKAGE)
    assert not out.exists()
    if printed:
        lines = printed.splitlines()
        assert lines[0] == lines[1] and "no CUDA device" in lines[0]
        assert lines[2].startswith("partial states cover 0 frames")


def test_chip_smoke_path_loads_no_jax_package(tmp_path):
    """What chip_smoke.py runs, at a tiny size and on the CPU: the
    synthesis of the three membranes, the analyses it builds (with a
    leaflet run and a clustering one), the port's run, a sharded run
    through the partial-state files, and the harness's validation."""
    d = str(tmp_path)
    _fresh(
        "import chip_smoke, bench, os\n"
        "from tools import bench_modes\n"
        "import gorder_tpu_torch\n"
        "from gorder_tpu_torch.input.config import LeafletClassification\n"
        f"d = {d!r}\n"
        "gro, bnd, system = chip_smoke.synthesize_structure(\n"
        "    d, n_lipids=4, total_atoms=4 * 134 + 60)\n"
        "xtc = chip_smoke.synthesize_trajectory(d, system, 20)\n"
        "a = chip_smoke.aa_analysis(gro, bnd, xtc, os.path.join(d, 'o.yaml'))\n"
        "a.leaflets = LeafletClassification.global_(\n"
        "    'resname POPC', 'resname POPC and name P')\n"
        "gorder_tpu_torch.run(a, device='cpu').write()\n"
        "assert bench.validate_output(a.output_yaml, 'aa', 20) is None\n"
        "files = chip_smoke.synthesize_ua(d, 20, n_lipids=2,\n"
        "                                 total_atoms=2 * 51 + 30)\n"
        "u = chip_smoke.ua_analysis('ua', *files, os.path.join(d, 'u.yaml'))\n"
        "gorder_tpu_torch.run(u, device='cpu').write()\n"
        "chip_smoke.ua_problem(1, 4, 3)\n"
        "aab = chip_smoke.synthesize_aab(d, 20, n_mols=8,\n"
        "                                total_atoms=8 * 134 + 30,\n"
        "                                box=(2.4, 2.4, 11.0))\n"
        "c = chip_smoke.leaflet_analysis('aa-clustering-leaflets', *aab, d,\n"
        "                                os.path.join(d, 'c.yaml'))\n"
        "gorder_tpu_torch.run(c, device='cpu').write()\n"
        "from gorder_tpu_torch.parallel.shard import load_partial, "
        "save_partial\n"
        "for i in range(2):\n"
        "    save_partial(os.path.join(d, f'p{i}.npz'),\n"
        "                 c.run_partial(i, 2, device='cpu'))\n"
        "c.merge([os.path.join(d, f'p{i}.npz') for i in range(2)])\n"
        + _NO_JAX_PACKAGE)
