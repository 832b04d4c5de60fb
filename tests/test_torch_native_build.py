"""The XTC codec's build (gorder_tpu_torch/io/native.py `_build_library`)
when another process builds the same library at the same time, as test
workers that start together do: each build compiles into a temporary file
of its own and renames it into place, so one build's rename never takes
away the file that another is about to rename. With one temporary name
shared by all builds, the second build's rename found no file and failed
with FileNotFoundError."""

import os
import subprocess

import pytest

from gorder_tpu_torch.io import native


def test_a_build_that_overlaps_another_renames_its_own_file(tmp_path,
                                                            monkeypatch):
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    src = native_dir / "xdr.cpp"
    src.write_text("// the source stands in for the codec's\n")
    monkeypatch.setattr(native, "_NATIVE_DIR", native_dir)
    monkeypatch.setattr(native, "_SRC", src)
    outputs = []
    pid = os.getpid()

    def compiler(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as fh:
            fh.write(f"build {len(outputs)}\n")
        outputs.append(out)
        if len(outputs) == 1:
            # the interleaving of two workers: this build's compiler has
            # written its output when another process's build runs from
            # start to end
            with monkeypatch.context() as other:
                other.setattr(native.os, "getpid", lambda: pid + 1)
                assert native._build_library().exists()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native.subprocess, "run", compiler)
    so_path = native._build_library()
    assert len(outputs) == 2 and outputs[0] != outputs[1]
    assert so_path.read_text() == "build 0\n"
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [
        so_path.name]


def test_a_failed_build_leaves_no_temporary_file(tmp_path, monkeypatch):
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    src = native_dir / "xdr.cpp"
    src.write_text("not C++\n")
    monkeypatch.setattr(native, "_NATIVE_DIR", native_dir)
    monkeypatch.setattr(native, "_SRC", src)

    def compiler(cmd, **kw):
        raise subprocess.CalledProcessError(1, cmd, "", "error: not C++")

    monkeypatch.setattr(native.subprocess, "run", compiler)
    with pytest.raises(native.TrajectoryError, match="not C\\+\\+"):
        native._build_library()
    assert list((tmp_path / "_build").iterdir()) == []
