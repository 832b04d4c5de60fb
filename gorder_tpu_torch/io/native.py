"""ctypes bindings for the native XTC/TRR codec (native/xdr.cpp).

The reference reads trajectories through groan_rs's vendored C `xdrfile`
(SURVEY.md §2.6.1, "reads only the necessary atoms from XTC"); this is the
TPU-era equivalent with subset/early-stop reads and fixed-point wire
formats.

The shared library is compiled on first use with g++ -O3 into the
package's git-ignored `_build/` directory, beside the CUDA kernels, and
cached there (keyed by a source hash), so no build step is needed at
install time and stale binaries never survive a source change.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..errors import TrajectoryError

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SRC = _NATIVE_DIR / "xdr.cpp"
_LOCK = threading.Lock()
_LIB = None


def _host_isa_tag() -> str:
    """Hash of the host CPU identity (model + feature flags). The library
    is built with -march=native, and this environment migrates between
    physical hosts: a binary tuned for one microarchitecture can run an
    order of magnitude slower on another (measured 24 vs 540 frames/s for
    the same source), so the cache key must include the host, exactly like
    XLA's cpuinfo-keyed persistent cache."""
    try:
        with open("/proc/cpuinfo") as fh:
            lines = [ln for ln in fh.read().splitlines()
                     if ln.startswith(("model name", "flags"))]
        ident = lines[0] + "|" + (lines[1] if len(lines) > 1 else "")
    except OSError:
        import platform

        ident = platform.processor() or platform.machine()
    return hashlib.sha256(ident.encode()).hexdigest()[:8]


def _build_library() -> Path:
    source = _SRC.read_bytes()
    tag = (hashlib.sha256(source).hexdigest()[:16] + "-"
           + _host_isa_tag())
    build_dir = _NATIVE_DIR.parent / "_build"
    build_dir.mkdir(exist_ok=True)
    so_path = build_dir / f"libxdr-{tag}.so"
    if so_path.exists():
        return so_path
    # each process builds into a temporary file of its own and renames it
    # into place (as ops/build.py does): several processes (test workers)
    # may build the same library at once, and a shared temporary name lets
    # one rename away the file another is about to
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3", "-march=native", "-funroll-loops", "-fno-plt",
        "-shared", "-fPIC", "-std=c++17", "-pthread",
        str(_SRC), "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise TrajectoryError(
            f"failed to build native XDR codec:\n{e.stderr}"
        ) from None
    os.replace(tmp, so_path)
    # clean superseded builds
    for old in build_dir.glob("libxdr-*.so"):
        if old != so_path:
            try:
                old.unlink()
            except OSError:
                pass
    return so_path


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build_library()))
            lib.xdr_last_error.restype = ctypes.c_char_p
            lib.xtc_scan.restype = ctypes.c_int64
            lib.xtc_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ]
            lib.xtc_decode.restype = ctypes.c_int32
            lib.xtc_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            lib.xtc_decode_i16.restype = ctypes.c_int32
            lib.xtc_decode_i16.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ]
            lib.xtc_decode_i12.restype = ctypes.c_int32
            lib.xtc_decode_i12.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ]
            lib.xtc_decode_i32.restype = ctypes.c_int32
            lib.xtc_decode_i32.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ]
            lib.xtc_read_raw.restype = ctypes.c_int32
            lib.xtc_read_raw.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            lib.xtc_decode_d8.restype = ctypes.c_int32
            lib.xtc_decode_d8.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            lib.xtc_decode_s6.restype = ctypes.c_int32
            lib.xtc_decode_s6.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            lib.xtc_decode_b7.restype = ctypes.c_int32
            lib.xtc_decode_b7.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint16),
                ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.xtc_cog_axis.restype = ctypes.c_int32
            lib.xtc_cog_axis.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32,
            ]
            lib.xtc_geo_mask.restype = ctypes.c_int32
            lib.xtc_geo_mask.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ]
            lib.xtc_write.restype = ctypes.c_int32
            lib.xtc_write.argtypes = [
                ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_float, ctypes.c_int32,
            ]
            lib.trr_scan.restype = ctypes.c_int64
            lib.trr_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.trr_decode.restype = ctypes.c_int32
            lib.trr_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ]
            _LIB = lib
        return _LIB


def _err(lib) -> str:
    return lib.xdr_last_error().decode("utf-8", "replace")


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def xtc_scan(path: str):
    """Index an XTC file → dict of offsets/natoms/steps/times arrays."""
    lib = get_lib()
    encoded = path.encode()
    null64 = ctypes.POINTER(ctypes.c_int64)()
    null32 = ctypes.POINTER(ctypes.c_int32)()
    nullf = ctypes.POINTER(ctypes.c_float)()
    n = lib.xtc_scan(encoded, 0, null64, null32, null32, nullf)
    if n < 0:
        raise TrajectoryError(f"could not index xtc file '{path}': {_err(lib)}")
    offsets = np.empty(n, np.int64)
    natoms = np.empty(n, np.int32)
    steps = np.empty(n, np.int32)
    times = np.empty(n, np.float32)
    if n:
        n2 = lib.xtc_scan(encoded, n, _i64p(offsets), _i32p(natoms),
                          _i32p(steps), _f32p(times))
        if n2 != n:
            raise TrajectoryError(f"inconsistent xtc index for '{path}': {_err(lib)}")
    return {"offsets": offsets, "natoms": natoms, "steps": steps, "times": times}


def _slot_args(first_n: int, slot_of: np.ndarray, n_out: int = None):
    """(slot_of array-or-None, ptr or NULL, n_out) for subset-gather decode
    calls. n_out defaults to first_n (prefix reads) or max(slot)+1; callers
    may pass a larger n_out to pad output columns to a fixed width."""
    if slot_of is None:
        return None, ctypes.POINTER(ctypes.c_int32)(), (n_out or first_n)
    slot_of = np.ascontiguousarray(slot_of, np.int32)
    assert len(slot_of) >= first_n
    if n_out is None:
        n_out = int(slot_of.max()) + 1
    return slot_of, _i32p(slot_of), n_out


def xtc_decode(path: str, offsets: np.ndarray, first_n: int,
               slot_of: np.ndarray = None, n_out: int = None,
               n_threads: int = 1):
    """Decode frames at `offsets` → (coords (n, n_out, 3), boxes (n, 3, 3),
    times (n,), steps (n,)). `slot_of` (len ≥ first_n, −1 = skip) gathers a
    sparse atom subset into compact output slots."""
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    slot_of, slot_p, n_out = _slot_args(first_n, slot_of, n_out)
    n = len(offsets)
    coords = np.empty((n, n_out, 3), np.float32)
    boxes = np.empty((n, 3, 3), np.float32)
    times = np.empty(n, np.float32)
    steps = np.empty(n, np.int32)
    if n:
        rc = lib.xtc_decode(path.encode(), _i64p(offsets), n, first_n,
                            slot_p, n_out,
                            _f32p(coords), _f32p(boxes), _f32p(times),
                            _i32p(steps), n_threads)
        if rc != 0:
            raise TrajectoryError(f"could not decode xtc file '{path}': {_err(lib)}")
    return coords, boxes, times, steps


def xtc_decode_i16(path: str, offsets: np.ndarray, first_n: int,
                   slot_of: np.ndarray = None, n_out: int = None,
                   out: np.ndarray = None, n_threads: int = 1):
    """Decode frames as raw XTC fixed-point int16 integers.

    Returns (coords_i16 (n, n_out, 3), inv_precision (n,), boxes, times,
    steps) or None when any coordinate exceeds int16 range (caller falls
    back to the f32 path). `float(i16) * inv_precision` reproduces the f32
    coordinates bit-for-bit."""
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    slot_of, slot_p, n_out = _slot_args(first_n, slot_of, n_out)
    n = len(offsets)
    if out is not None and out.shape[0] >= n and out.shape[1] == n_out:
        coords = out[:n]
    else:
        coords = np.empty((n, n_out, 3), np.int16)
    inv_prec = np.empty(n, np.float32)
    boxes = np.empty((n, 3, 3), np.float32)
    times = np.empty(n, np.float32)
    steps = np.empty(n, np.int32)
    if n:
        rc = lib.xtc_decode_i16(
            path.encode(), _i64p(offsets), n, first_n, slot_p, n_out,
            coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            _f32p(inv_prec), _f32p(boxes), _f32p(times), _i32p(steps),
            n_threads)
        if rc == 1:
            return None  # out of i16 range somewhere
        if rc != 0:
            raise TrajectoryError(
                f"could not decode xtc file '{path}': {_err(lib)}")
    return coords, inv_prec, boxes, times, steps


def i12_stride(n_out: int) -> int:
    """Bytes per frame for the 12-bit packed layout."""
    return ((n_out * 3 + 1) // 2) * 3


def xtc_decode_i12(path: str, offsets: np.ndarray, first_n: int,
                   slot_of: np.ndarray = None, n_out: int = None,
                   out: np.ndarray = None, n_threads: int = 1):
    """Decode frames as 12-bit-packed XTC fixed-point integers (two values
    per 3 bytes — 25% fewer wire bytes than int16).

    Returns (packed_u8 (n, stride), inv_precision (n,), boxes, times,
    steps) or None when any coordinate exceeds the 12-bit range (caller
    falls back to int16/f32). Device-side unpacking then dequantization
    reproduces the f32 coordinates bit-for-bit."""
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    slot_of, slot_p, n_out = _slot_args(first_n, slot_of, n_out)
    n = len(offsets)
    stride = i12_stride(n_out)
    if out is not None and out.shape[0] >= n and out.shape[1] == stride:
        coords = out[:n]
    else:
        coords = np.empty((n, stride), np.uint8)
    inv_prec = np.empty(n, np.float32)
    boxes = np.empty((n, 3, 3), np.float32)
    times = np.empty(n, np.float32)
    steps = np.empty(n, np.int32)
    if n:
        rc = lib.xtc_decode_i12(
            path.encode(), _i64p(offsets), n, first_n, slot_p, n_out,
            coords.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _f32p(inv_prec), _f32p(boxes), _f32p(times), _i32p(steps),
            n_threads)
        if rc == 1:
            return None  # out of 12-bit range somewhere
        if rc != 0:
            raise TrajectoryError(
                f"could not decode xtc file '{path}': {_err(lib)}")
    return coords, inv_prec, boxes, times, steps


def xtc_decode_i32(path: str, offsets: np.ndarray, first_n: int,
                   slot_of: np.ndarray = None, n_out: int = None,
                   n_threads: int = 1):
    """Decode frames as the int32 XTC integers themselves → (coords_i32
    (n, n_out, 3), inv_precision (n,), boxes, times, steps): what every
    wire carries, whatever its range."""
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    slot_of, slot_p, n_out = _slot_args(first_n, slot_of, n_out)
    n = len(offsets)
    coords = np.zeros((n, n_out, 3), np.int32)
    inv_prec = np.empty(n, np.float32)
    boxes = np.empty((n, 3, 3), np.float32)
    times = np.empty(n, np.float32)
    steps = np.empty(n, np.int32)
    if n:
        rc = lib.xtc_decode_i32(
            path.encode(), _i64p(offsets), n, first_n, slot_p, n_out,
            _i32p(coords), _f32p(inv_prec), _f32p(boxes), _f32p(times),
            _i32p(steps), n_threads)
        if rc != 0:
            raise TrajectoryError(
                f"could not decode xtc file '{path}': {_err(lib)}")
    return coords, inv_prec, boxes, times, steps


def xtc_read_raw(path: str, offsets: np.ndarray, natoms: int,
                 raw_out: np.ndarray, lengths_out: np.ndarray,
                 inv_prec_out: np.ndarray, boxes_out: np.ndarray,
                 times_out: np.ndarray, steps_out: np.ndarray,
                 n_threads: int = 1) -> int:
    """Copy each frame's whole record, header included, into a row of
    `raw_out` ((≥ n, stride) uint8) and its length into `lengths_out`,
    with its box, time, step and 1/precision (native/xdr.cpp
    xtc_read_raw). Returns 0, or 1 when a frame does not fit the xtc wire
    (a plain frame, another atom count than `natoms`, a record longer than
    the stride, a range the decoder refuses); the buffers are the
    caller's, sliced to this call's rows."""
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets)
    if n == 0:
        return 0
    if raw_out.dtype != np.uint8 or raw_out.ndim != 2 \
            or not raw_out.flags.c_contiguous or raw_out.shape[0] < n:
        raise ValueError("raw_out must be a C-contiguous (n, stride) uint8 "
                         "array")
    for name, a, dtype in (("lengths_out", lengths_out, np.int32),
                           ("inv_prec_out", inv_prec_out, np.float32),
                           ("times_out", times_out, np.float32),
                           ("steps_out", steps_out, np.int32)):
        if a.dtype != dtype or a.shape[0] < n or not a.flags.c_contiguous:
            raise ValueError(f"{name} must be a contiguous {dtype.__name__} "
                             f"array of at least {n} rows")
    if boxes_out.dtype != np.float32 or boxes_out.shape[1:] != (3, 3) \
            or boxes_out.shape[0] < n or not boxes_out.flags.c_contiguous:
        raise ValueError("boxes_out must be a contiguous (n, 3, 3) float32 "
                         "array")
    rc = lib.xtc_read_raw(
        path.encode(), _i64p(offsets), n, int(natoms), raw_out.shape[1],
        raw_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i32p(lengths_out), _f32p(inv_prec_out), _f32p(boxes_out),
        _f32p(times_out), _i32p(steps_out), n_threads)
    if rc == -1:
        raise TrajectoryError(
            f"could not read xtc file '{path}': {_err(lib)}")
    return rc


def xtc_decode_d8(path: str, offsets: np.ndarray, first_n: int,
                  base_io: np.ndarray, has_base: bool,
                  abs0: np.ndarray, lo_out: np.ndarray,
                  corr_idx_out: np.ndarray, corr_hi_out: np.ndarray,
                  inv_prec_out: np.ndarray, boxes_out: np.ndarray,
                  times_out: np.ndarray, steps_out: np.ndarray,
                  slot_of: np.ndarray = None, n_out: int = None,
                  n_threads: int = 1) -> int:
    """Temporal-delta decode (8-bit deltas + sparse corrections; see
    native/xdr.cpp xtc_decode_d8). Caller owns all output buffers, sliced
    to this call's rows; `base_io` chains multi-segment batches. Returns
    (rc, max_ncorr): rc 0 ok / 1 unfit (caller falls back or re-sizes the
    correction capacity to max_ncorr)."""
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    slot_of, slot_p, n_out = _slot_args(first_n, slot_of, n_out)
    n = len(offsets)
    if n == 0:
        return 0, 0
    assert lo_out.shape[0] >= n and lo_out.shape[1] == n_out
    corr_cap = corr_idx_out.shape[1]
    max_ncorr = np.zeros(1, np.int32)
    rc = lib.xtc_decode_d8(
        path.encode(), _i64p(offsets), n, first_n, slot_p, n_out,
        _i32p(base_io), int(has_base), _i32p(abs0),
        lo_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        _i32p(corr_idx_out),
        corr_hi_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        corr_cap, _i32p(max_ncorr),
        _f32p(inv_prec_out), _f32p(boxes_out), _f32p(times_out),
        _i32p(steps_out), n_threads)
    if rc == -1:
        raise TrajectoryError(
            f"could not decode xtc file '{path}': {_err(lib)}")
    return rc, int(max_ncorr[0])


def s6_stride(n_out: int) -> int:
    """Bytes per frame for the 6-bit packed residual stream."""
    nv4 = (n_out * 3 + 3) // 4 * 4
    return nv4 // 4 * 3


def xtc_decode_s6(path: str, offsets: np.ndarray, first_n: int,
                  group_of: np.ndarray, n_groups: int, gmean_stride: int,
                  w_base: int, base_io: np.ndarray, has_base: bool,
                  gmean_out: np.ndarray, pack_out: np.ndarray,
                  esc_gap_out: np.ndarray, esc_val_out: np.ndarray,
                  inv_prec_out: np.ndarray, boxes_out: np.ndarray,
                  times_out: np.ndarray, steps_out: np.ndarray,
                  slot_of: np.ndarray = None, n_out: int = None,
                  n_threads: int = 1):
    """Smoothed-base 6-bit residual decode (see native/xdr.cpp
    xtc_decode_s6). Caller owns all output buffers sliced to this call's
    rows; `base_io` carries the per-batch base across multi-file segments.
    Returns (rc, max_nesc): rc 0 ok / 1 unfit (caller re-sizes esc_cap or
    falls back to d8)."""
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    slot_of, slot_p, n_out = _slot_args(first_n, slot_of, n_out)
    n = len(offsets)
    if n == 0:
        return 0, 0
    group_of = np.ascontiguousarray(group_of, np.int32)
    assert len(group_of) == n_out
    assert pack_out.shape[0] >= n and pack_out.shape[1] == s6_stride(n_out)
    esc_cap = esc_gap_out.shape[1]
    max_nesc = np.zeros(1, np.int32)
    rc = lib.xtc_decode_s6(
        path.encode(), _i64p(offsets), n, first_n, slot_p, n_out,
        _i32p(group_of), n_groups, gmean_stride, w_base,
        _i32p(base_io), int(has_base),
        gmean_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        pack_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        esc_gap_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        esc_val_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        esc_cap, _i32p(max_nesc),
        _f32p(inv_prec_out), _f32p(boxes_out), _f32p(times_out),
        _i32p(steps_out), n_threads)
    if rc == -1:
        raise TrajectoryError(
            f"could not decode xtc file '{path}': {_err(lib)}")
    return rc, int(max_nesc[0])


def b7_stride(n_bonds: int) -> int:
    """Bytes per frame for the 7-bit packed bond-difference stream."""
    nb8 = (n_bonds * 3 + 7) // 8 * 8
    return nb8 // 8 * 7


def xtc_decode_b7(path: str, offsets: np.ndarray, first_n: int,
                  bond_a: np.ndarray, bond_b: np.ndarray,
                  w_base: int, base_io: np.ndarray, has_base: bool,
                  pack_out: np.ndarray, esc_gap_out: np.ndarray,
                  esc_val_out: np.ndarray, inv_prec_out: np.ndarray,
                  boxes_out: np.ndarray, times_out: np.ndarray,
                  steps_out: np.ndarray, slot_of: np.ndarray = None,
                  n_out: int = None, n_threads: int = 1,
                  aux_slots: np.ndarray = None, aux_out: np.ndarray = None,
                  cog_slots: np.ndarray = None, cog_axis: int = 2,
                  cog_out: np.ndarray = None,
                  geo: tuple = None, geo_out: np.ndarray = None):
    """Bond-difference 7-bit residual decode (see native/xdr.cpp
    xtc_decode_b7): per-batch per-value int32 base over the bond integer
    differences, packed 7-bit residuals, sparse (gap u16, val i16)
    escapes. Optional side channels for leaflet runs: aux_out (n, n_aux, 3)
    int32 absolute positions of the aux_slots subset; cog_out (n,) f32
    refined Bai-Breen center of the cog_slots subset along cog_axis.
    Returns (rc, max_nesc): rc 0 ok / 1 unfit."""
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    slot_of, slot_p, n_out = _slot_args(first_n, slot_of, n_out)
    n = len(offsets)
    if n == 0:
        return 0, 0
    bond_a = np.ascontiguousarray(bond_a, np.int32)
    bond_b = np.ascontiguousarray(bond_b, np.int32)
    n_bonds = len(bond_a)
    assert len(bond_b) == n_bonds
    assert pack_out.shape[0] >= n and pack_out.shape[1] == b7_stride(n_bonds)
    esc_cap = esc_gap_out.shape[1]
    max_nesc = np.zeros(1, np.int32)
    nullp = ctypes.POINTER(ctypes.c_int32)()
    if aux_slots is not None and len(aux_slots):
        aux_slots = np.ascontiguousarray(aux_slots, np.int32)
        assert aux_out is not None and aux_out.dtype == np.int32 \
            and aux_out.shape[0] >= n \
            and aux_out.shape[1] == len(aux_slots) and aux_out.shape[2] == 3
        aux_args = (_i32p(aux_slots), len(aux_slots), _i32p(aux_out))
    else:
        aux_args = (nullp, 0, nullp)
    if cog_slots is not None and len(cog_slots):
        cog_slots = np.ascontiguousarray(cog_slots, np.int32)
        assert cog_out is not None and cog_out.dtype == np.float32 \
            and cog_out.shape[0] >= n
        cog_args = (_i32p(cog_slots), len(cog_slots), int(cog_axis),
                    _f32p(cog_out))
    else:
        cog_args = (nullp, 0, 0, ctypes.POINTER(ctypes.c_float)())
    nullf = ctypes.POINTER(ctypes.c_float)()
    nullu8 = ctypes.POINTER(ctypes.c_uint8)()
    if geo is not None:
        # inline geometry mask channel (b7geo): same computation as the
        # standalone xtc_geo_mask pass, reusing this decode's integers.
        # geo = (spec, ref_mode, ref_point, geo_slots, handle_pbc)
        spec, ref_mode, ref_point, geo_slots, handle_pbc = geo
        kind = {"cuboid": 0, "cylinder": 1, "sphere": 2}[spec.kind]
        bounds = np.asarray([spec.xdim[0], spec.xdim[1],
                             spec.ydim[0], spec.ydim[1],
                             spec.zdim[0], spec.zdim[1],
                             spec.radius, spec.span[0], spec.span[1]],
                            np.float32)
        ref_arr = np.asarray(ref_point if ref_point is not None
                             else (0.0, 0.0, 0.0), np.float32)
        if geo_slots is None:
            geo_slots = np.zeros(0, np.int32)
        geo_slots = np.ascontiguousarray(geo_slots, np.int32)
        assert geo_out is not None and geo_out.dtype == np.uint8 \
            and geo_out.shape[0] >= n \
            and geo_out.shape[1] == geo_stride(n_bonds)
        geo_args = (kind, int(bool(spec.invert)), int(spec.orientation),
                    int(bool(handle_pbc)), _f32p(bounds), int(ref_mode),
                    _f32p(ref_arr), _i32p(geo_slots), len(geo_slots),
                    geo_out.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint8)))
        # keep the arrays alive through the call
        _geo_keep = (bounds, ref_arr, geo_slots)
    else:
        geo_args = (-1, 0, 0, 0, nullf, 0, nullf, nullp, 0, nullu8)
    rc = lib.xtc_decode_b7(
        path.encode(), _i64p(offsets), n, first_n, slot_p, n_out,
        _i32p(bond_a), _i32p(bond_b), n_bonds, w_base,
        _i32p(base_io), int(has_base),
        pack_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        esc_gap_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        esc_val_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        esc_cap, _i32p(max_nesc),
        _f32p(inv_prec_out), _f32p(boxes_out), _f32p(times_out),
        _i32p(steps_out), n_threads, *aux_args, *cog_args, *geo_args)
    if rc == -1:
        raise TrajectoryError(
            f"could not decode xtc file '{path}': {_err(lib)}")
    return rc, int(max_nesc[0])


def xtc_cog_axis(path: str, offsets: np.ndarray, first_n: int,
                 cog_slots: np.ndarray, cog_axis: int, cog_out: np.ndarray,
                 slot_of: np.ndarray = None, n_out: int = None,
                 n_threads: int = 1) -> None:
    """Per-frame refined Bai-Breen center of the cog_slots subset along
    cog_axis (native/xdr.cpp xtc_cog_axis) — the exact computation the
    b7g wire's side channel performs, as a standalone pass so
    global-leaflet runs riding a COORDINATE wire classify against the
    same per-frame value (bitwise cross-wire output equality)."""
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    slot_of, slot_p, n_out = _slot_args(first_n, slot_of, n_out)
    n = len(offsets)
    if n == 0:
        return
    cog_slots = np.ascontiguousarray(cog_slots, np.int32)
    assert cog_out.dtype == np.float32 and cog_out.shape[0] >= n
    rc = lib.xtc_cog_axis(
        path.encode(), _i64p(offsets), n, first_n, slot_p, n_out,
        _i32p(cog_slots), len(cog_slots), int(cog_axis), _f32p(cog_out),
        n_threads)
    if rc != 0:
        raise TrajectoryError(
            f"could not decode xtc file '{path}': {_err(lib)}")


def geo_stride(n_bonds: int) -> int:
    """Bytes per frame of the geometry mask bitplane."""
    return (n_bonds + 7) // 8


def xtc_geo_mask(path: str, offsets: np.ndarray, first_n: int,
                 bond_a: np.ndarray, bond_b: np.ndarray, spec,
                 ref_mode: int, ref_point, geo_slots, mask_out: np.ndarray,
                 handle_pbc: bool = True, slot_of: np.ndarray = None,
                 n_out: int = None, n_threads: int = 1) -> None:
    """Per-frame per-bond inside-geometry bitplane (native/xdr.cpp
    xtc_geo_mask): midpoints from the kernel's single-rounding integer
    formulation, selection references from an f64 refined circular COG.
    All wire formats consume this one mask, so geometry output is bitwise
    identical across wires. spec is a core.geometry.GeometrySpec;
    ref_mode: 0 point, 1 box center, 2 selection COG over geo_slots."""
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    slot_of, slot_p, n_out = _slot_args(first_n, slot_of, n_out)
    n = len(offsets)
    if n == 0:
        return
    bond_a = np.ascontiguousarray(bond_a, np.int32)
    bond_b = np.ascontiguousarray(bond_b, np.int32)
    kind = {"cuboid": 0, "cylinder": 1, "sphere": 2}[spec.kind]
    bounds = np.asarray([spec.xdim[0], spec.xdim[1],
                         spec.ydim[0], spec.ydim[1],
                         spec.zdim[0], spec.zdim[1],
                         spec.radius, spec.span[0], spec.span[1]],
                        np.float32)
    ref_arr = np.asarray(ref_point if ref_point is not None
                         else (0.0, 0.0, 0.0), np.float32)
    if geo_slots is None:
        geo_slots = np.zeros(0, np.int32)
    geo_slots = np.ascontiguousarray(geo_slots, np.int32)
    assert mask_out.dtype == np.uint8 and mask_out.shape[0] >= n \
        and mask_out.shape[1] == geo_stride(len(bond_a))
    rc = lib.xtc_geo_mask(
        path.encode(), _i64p(offsets), n, first_n, slot_p, n_out,
        _i32p(bond_a), _i32p(bond_b), len(bond_a),
        kind, int(bool(spec.invert)), int(spec.orientation),
        int(bool(handle_pbc)), _f32p(bounds),
        int(ref_mode), _f32p(ref_arr), _i32p(geo_slots), len(geo_slots),
        mask_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads)
    if rc != 0:
        raise TrajectoryError(
            f"could not decode xtc file '{path}': {_err(lib)}")


def xtc_write(path: str, coords: np.ndarray, boxes: np.ndarray,
              times: np.ndarray, steps: np.ndarray,
              precision: float = 1000.0, append: bool = False) -> None:
    lib = get_lib()
    coords = np.ascontiguousarray(coords, np.float32)
    n, natoms = coords.shape[0], coords.shape[1]
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(n, 9)
    times = np.ascontiguousarray(times, np.float32)
    steps = np.ascontiguousarray(steps, np.int32)
    rc = lib.xtc_write(path.encode(), natoms, n, _f32p(coords), _f32p(boxes),
                       _f32p(times), _i32p(steps), precision, int(append))
    if rc != 0:
        raise TrajectoryError(f"could not write xtc file '{path}': {_err(lib)}")


def trr_scan(path: str):
    lib = get_lib()
    encoded = path.encode()
    null64 = ctypes.POINTER(ctypes.c_int64)()
    null32 = ctypes.POINTER(ctypes.c_int32)()
    nullf = ctypes.POINTER(ctypes.c_float)()
    n = lib.trr_scan(encoded, 0, null64, null32, null32, nullf, null32)
    if n < 0:
        raise TrajectoryError(f"could not index trr file '{path}': {_err(lib)}")
    offsets = np.empty(n, np.int64)
    natoms = np.empty(n, np.int32)
    steps = np.empty(n, np.int32)
    times = np.empty(n, np.float32)
    has_coords = np.empty(n, np.int32)
    if n:
        n2 = lib.trr_scan(encoded, n, _i64p(offsets), _i32p(natoms),
                          _i32p(steps), _f32p(times), _i32p(has_coords))
        if n2 != n:
            raise TrajectoryError(f"inconsistent trr index for '{path}': {_err(lib)}")
    return {
        "offsets": offsets, "natoms": natoms, "steps": steps, "times": times,
        "has_coords": has_coords.astype(bool),
    }


def trr_decode(path: str, offsets: np.ndarray, first_n: int):
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets)
    coords = np.empty((n, first_n, 3), np.float32)
    boxes = np.empty((n, 3, 3), np.float32)
    times = np.empty(n, np.float32)
    steps = np.empty(n, np.int32)
    if n:
        rc = lib.trr_decode(path.encode(), _i64p(offsets), n, first_n,
                            _f32p(coords), _f32p(boxes), _f32p(times),
                            _i32p(steps))
        if rc != 0:
            raise TrajectoryError(f"could not decode trr file '{path}': {_err(lib)}")
    return coords, boxes, times, steps
