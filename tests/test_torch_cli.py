"""The port's command line (`gorder_tpu_torch.cli.main`) held against
`gorder_tpu.cli.main` on the same configurations, in this process, on a
small CG bilayer: the same exit codes, the same standard output (the
banner and the ✔ line), the same error lines on standard error (the INFO
log lines of a run name each package's own wire and times, so a run that
is not silent is compared by its `error`/`✖` lines), and the same files.
The port runs with `--device cpu`. Mirrors the jax-free cases of
tests/test_cli.py, whose fixtures need the reference corpus."""

import logging
import os

import pytest

from gorder_tpu import cli as jax_cli
from gorder_tpu_torch import cli

from .synthetic import make_flat_bilayer


@pytest.fixture(scope="module")
def cg_files(tmp_path_factory):
    return make_flat_bilayer(tmp_path_factory.mktemp("cg"), n_frames=12)


@pytest.fixture(autouse=True)
def _restore_logging():
    """The CLI installs its own root handler; put the test's back."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    root.handlers[:] = handlers
    root.setLevel(level)


def _config(path, files, extra="", output="output: order.yaml\n"):
    gro, bnd, xtc = files
    path.write_text(f"structure: {gro}\nbonds: {bnd}\ntrajectory: {xtc}\n"
                    f"type: !CGOrder\n  atoms: \"resname POPC\"\n"
                    f"{output}{extra}")
    return path


def _both(tmp_path, capsys, monkeypatch, cfg_text, args=()):
    """Run both CLIs, each in its own directory with the same config; →
    {who: (rc, stdout, stderr, directory)}."""
    out = {}
    for who, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / who
        d.mkdir()
        (d / "cfg.yaml").write_text(cfg_text)
        monkeypatch.chdir(d)
        argv = ["cfg.yaml", *args] + (["--device", "cpu"]
                                      if who == "port" else [])
        rc = main(argv)
        captured = capsys.readouterr()
        out[who] = (rc, captured.out, captured.err, d)
    return out


def _errors(err):
    return [ln for ln in err.splitlines()
            if ln.startswith(("error", "✖", "Analysis completed", "    "))]


def _files(d):
    return sorted(os.listdir(d))


def _yaml(d):
    with open(d / "order.yaml") as fh:
        return [ln for ln in fh.read().splitlines() if not ln.startswith("#")]


@pytest.mark.parametrize("flags", [
    ("--silent",), ("-s",), ("-o", "-s"), ("--overwrite",), (),
    ("-s", "--export-config", "exported.yaml")])
def test_flags_match_jax(cg_files, tmp_path, capsys, monkeypatch, flags):
    """Each flag: the banner and ✔ line unless silent, nothing on standard
    error when silent, a backup of an existing output unless -o, and the
    same exported configuration."""
    cfg = _config(tmp_path / "cfg.yaml", cg_files).read_text()
    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
        (tmp_path / who / "order.yaml").write_text("previous\n")
    out = {}
    for who, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / who
        (d / "cfg.yaml").write_text(cfg)
        monkeypatch.chdir(d)
        rc = main(["cfg.yaml", *flags]
                  + (["--device", "cpu"] if who == "port" else []))
        captured = capsys.readouterr()
        out[who] = (rc, captured.out, captured.err, d)
    (rc, stdout, err, d), (jrc, jout, jerr, jd) = out["port"], out["jax"]
    assert rc == jrc == 0
    assert stdout == jout
    silent = "-s" in flags or "--silent" in flags
    if silent:
        assert err == jerr == ""
    else:
        assert ">>> GORDER-TPU v" in stdout and "✔ analysis completed" \
            in stdout
    assert _yaml(d) == _yaml(jd)
    assert _files(d) == _files(jd)
    backups = [n for n in _files(d) if n.startswith("#order.yaml")]
    assert bool(backups) == ("-o" not in flags and "--overwrite" not in flags)
    if "--export-config" in flags:
        assert (d / "exported.yaml").read_text() \
            == (jd / "exported.yaml").read_text()


@pytest.mark.parametrize("case", ["no_yaml_output", "map_without_directory",
                                  "invalid_config", "missing_trajectory",
                                  "missing_trajectory_silent"])
def test_errors_match_jax(cg_files, tmp_path, capsys, monkeypatch, case):
    """Refused configurations (NoYamlOutput, NoOrdermapsOutput) before the
    run, an invalid configuration, and an error during the run (the ✖ line
    when not silent): exit code 1, the same error lines, no output file."""
    gro, bnd, xtc = cg_files
    if case == "no_yaml_output":
        text = _config(tmp_path / "c.yaml", cg_files, output="").read_text()
    elif case == "map_without_directory":
        text = _config(tmp_path / "c.yaml", cg_files,
                       extra="map: default\n").read_text()
    elif case == "invalid_config":
        text = "structure: nothing.tpr\n"
    else:
        text = _config(tmp_path / "c.yaml", (gro, bnd, "no_such_file.xtc"),
                       extra="silent: true\n" if case.endswith("silent")
                       else "").read_text()
    out = _both(tmp_path, capsys, monkeypatch, text)
    (rc, stdout, err, d), (jrc, jout, jerr, jd) = out["port"], out["jax"]
    assert rc == jrc == 1
    assert stdout == jout
    assert _errors(err) == _errors(jerr) and _errors(err)
    assert not (d / "order.yaml").exists()
    if case == "no_yaml_output":
        assert "no yaml output file specified" in err
    elif case == "map_without_directory":
        assert "no output directory for ordermaps" in err
    elif case.startswith("missing"):
        assert _errors(err)[-1].startswith(
            "error" if case.endswith("silent") else "✖ error")


def test_export_failure_keeps_success(cg_files, tmp_path, capsys,
                                      monkeypatch):
    """An unwritable --export-config path does not fail the run: exit 0, the
    results written, the same two lines on standard error."""
    text = _config(tmp_path / "c.yaml", cg_files).read_text()
    out = _both(tmp_path, capsys, monkeypatch, text,
                ("-s", "--export-config", "no_such_dir/out.yaml"))
    (rc, _, err, d), (jrc, _, jerr, _) = out["port"], out["jax"]
    assert rc == jrc == 0
    assert err == jerr and "could not create file" in err
    assert (d / "order.yaml").is_file()


def test_version_matches_jax(capsys):
    versions = {}
    for who, main in (("jax", jax_cli.main), ("port", cli.main)):
        with pytest.raises(SystemExit) as done:
            main(["--version"])
        assert done.value.code == 0
        versions[who] = capsys.readouterr().out.split()
    assert versions["port"] == ["gorder-tpu-torch", versions["jax"][1]]


@pytest.mark.parametrize("args", [
    ("--frame-shard", "0/2", "--partial", "p.npz"),
    ("--merge", "a.npz", "b.npz"),
    ("--frame-shard", "0/2"),
    ("--frame-shard", "x", "--partial", "p.npz")])
def test_sharding_flags_parse_and_are_not_ported(cg_files, tmp_path, capsys,
                                                 monkeypatch, args):
    """--frame-shard, --partial and --merge do what gorder-tpu's do: a
    shard writes its partial state (the same arrays), a merge of two shards
    (written beforehand by the same CLI) writes the single run's YAML, and
    a shard without --partial or a malformed shard is refused. The same
    exit codes, standard output (banner and ✔ line), error lines and
    files (the merged YAML also equal to a single run's, byte for
    byte)."""
    import numpy as np

    from gorder_tpu_torch.parallel.shard import load_partial

    text = _config(tmp_path / "c.yaml", cg_files).read_text()
    merge = args[0] == "--merge"
    out = {}
    for who, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / who
        d.mkdir()
        (d / "cfg.yaml").write_text(text)
        monkeypatch.chdir(d)
        device = ["--device", "cpu"] if who == "port" else []
        if merge:
            for i, name in enumerate(("a.npz", "b.npz")):
                assert main(["cfg.yaml", "-s", "--frame-shard", f"{i}/2",
                             "--partial", name, *device]) == 0
            capsys.readouterr()
        rc = main(["cfg.yaml", *args, *device])
        captured = capsys.readouterr()
        out[who] = (rc, captured.out, captured.err, d)
    (rc, stdout, err, d), (jrc, jout, jerr, jd) = out["port"], out["jax"]
    assert rc == jrc
    assert stdout == jout
    assert _errors(err) == _errors(jerr)
    assert _files(d) == _files(jd)
    if "x" in args or "--partial" not in args and not merge:
        assert rc == 1 and _errors(err)[0].startswith("error: ")
        assert not (d / "order.yaml").exists()
    elif merge:
        assert rc == 0 and "✔ merged partial states" in stdout
        assert _yaml(d) == _yaml(jd)
        direct = tmp_path / "direct"
        direct.mkdir()
        (direct / "cfg.yaml").write_text(text)
        monkeypatch.chdir(direct)
        assert cli.main(["cfg.yaml", "-s", "--device", "cpu"]) == 0
        assert (d / "order.yaml").read_text() == (
            direct / "order.yaml").read_text()
    else:
        assert rc == 0 and "✔ shard 0/2 state written to 'p.npz'" in stdout
        assert not (d / "order.yaml").exists()
        # the same keys, fingerprint and counts; the int64 sums within
        # one 1e-6 quantum a sample of gorder_tpu's jitted XLA:CPU program
        # (ROADMAP.md's exactness contract)
        mine, theirs = (load_partial(str(x / "p.npz")) for x in (d, jd))
        assert mine.keys() == theirs.keys()
        for key, value in mine.items():
            if key == "sums_total":
                bound = mine["counts_total"]
                assert (np.abs(value - theirs[key]) <= bound).all()
            elif isinstance(value, np.ndarray):
                np.testing.assert_array_equal(value, theirs[key])
            else:
                assert value == theirs[key], key
