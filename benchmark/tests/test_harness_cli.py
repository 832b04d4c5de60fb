"""The command refuses to run, and prints no result line, without the
card the cell asks for, and in a directory that holds only
BENCHMARK.json and the benchmark's own files (no program)."""

import json
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

ARGS = ["--workload", "aa-static", "--seed", "7", "--seconds", "1",
        "--trace", "0"]


def _no_result(proc):
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is not reachable")
    proc = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr
    _no_result(proc)


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "_cache",
                                                  "__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0
    assert "gorder_tpu_torch" in proc.stderr
    _no_result(proc)
