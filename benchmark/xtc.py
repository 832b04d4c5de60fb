"""The benchmark's XTC writer: builds `xtc_encode.cpp` with g++ into
`benchmark/_build/` (git-ignored; keyed by a hash of the source and the
flags, so a checkout builds it once) and appends frames of grid integers
to a file through it."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE / "xtc_encode.cpp"
BUILD_DIR = _HERE / "_build"
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_LIB = None


def _library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libxtcenc-{digest}.so"


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        subprocess.run([os.environ.get("CXX", "g++"), *_FLAGS, str(_SOURCE),
                        "-o", str(tmp)], check=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.xtc_encode_error.restype = ctypes.c_char_p
    lib.xtc_encode_append.restype = ctypes.c_int64
    lib.xtc_encode_append.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32]
    _LIB = lib
    return lib


def append_frames(path, ints, boxes, times, steps, precision: float,
                  n_threads: int, append: bool) -> int:
    """Encode (F, A, 3) int32 grid integers with (F, 9) f32 boxes, (F,) f32
    times and (F,) int32 steps as XTC frames at `precision`, appended to
    `path` (or starting it) → bytes written."""
    lib = _load()
    ints = np.ascontiguousarray(ints, np.int32)
    boxes = np.ascontiguousarray(boxes, np.float32)
    times = np.ascontiguousarray(times, np.float32)
    steps = np.ascontiguousarray(steps, np.int32)
    n_frames, n_atoms = ints.shape[0], ints.shape[1]
    written = lib.xtc_encode_append(
        str(path).encode(), n_atoms, n_frames, ints.ctypes.data,
        boxes.ctypes.data, times.ctypes.data, steps.ctypes.data,
        float(precision), int(n_threads), int(append))
    if written < 0:
        raise OSError(f"XTC encoding failed: "
                      f"{lib.xtc_encode_error().decode()}")
    return int(written)
