"""The XTC codec's build (gorder_tpu_torch/io/native.py `_build_library`)
when another process builds the same library at the same time, as test
workers that start together do: each build compiles into a temporary file
of its own and renames it into place, so one build's rename never takes
away the file that another is about to rename. With one temporary name
shared by all builds, the second build's rename found no file and failed
with FileNotFoundError.

gorder_tpu's own codec (gorder_tpu/io/native.py, the reference, which the
tests' fixtures use to write their trajectories) still compiles every
build into one shared `.so.tmp`. So this module builds it once while the
test workers collect, before any test runs (pytest-xdist schedules no test
until every worker has collected), one worker at a time under a file
lock: the others then find the library built. Two workers that built it
at once in a test's set-up lost `tests/test_torch_neighbors.py`'s
`test_a_batch_hands_out_its_consumers[b7]` and `[d8]` to that error.
This holds only where this file is collected with the others: a run of
other files alone builds the codec in a fixture, as before. A build that
fails here is kept and fails `test_the_reference_codec_is_built_before_
the_tests` alone, not the collection."""

import fcntl
import os
import subprocess
import threading
import time

import pytest

from gorder_tpu.io import native as reference_native
from gorder_tpu_torch.io import native


def build_reference_codec():
    """gorder_tpu's XTC codec, built unless it is, one process at a time
    (an exclusive `flock` on a file beside the library). → its path."""
    build_dir = reference_native._NATIVE_DIR / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return reference_native._build_library()


def _build_while_collecting():
    """→ (the library's path, None), or (None, the error that stopped its
    build): every test worker imports this module while it collects."""
    try:
        return build_reference_codec(), None
    except Exception as e:   # noqa: BLE001 - the test below reports it
        return None, e


COLLECTED_BUILD, COLLECTION_ERROR = _build_while_collecting()


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


def test_the_reference_codec_is_built_before_the_tests(monkeypatch):
    """Collection built gorder_tpu's codec: asked again, nothing compiles."""
    assert COLLECTION_ERROR is None, f"the build failed: {COLLECTION_ERROR!r}"
    assert COLLECTED_BUILD.exists()

    def compiler(cmd, **kw):
        raise AssertionError(f"compiled again: {cmd}")

    monkeypatch.setattr(reference_native.subprocess, "run", compiler)
    assert build_reference_codec().exists()


def test_two_reference_builds_at_once_compile_once(tmp_path, monkeypatch):
    """Two builds of gorder_tpu's codec started together (threads here, as
    the lock is per open file, as processes there) compile once and both
    find the library; its one shared temporary name is safe under the
    lock."""
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    src = native_dir / "xdr.cpp"
    src.write_text("// the source stands in for the codec's\n")
    monkeypatch.setattr(reference_native, "_NATIVE_DIR", native_dir)
    monkeypatch.setattr(reference_native, "_SRC", src)
    compiled = []

    def compiler(cmd, **kw):
        compiled.append(cmd)
        time.sleep(0.2)   # both builds are under way
        with open(cmd[cmd.index("-o") + 1], "w") as fh:
            fh.write("built\n")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(reference_native.subprocess, "run", compiler)
    got, errors = [], []

    def build():
        try:
            got.append(build_reference_codec())
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(compiled) == 1
    assert got[0] == got[1] and got[0].read_text() == "built\n"
