"""Build the hand-written CUDA kernels (`csrc/*.cu`) at first use, and the
argument checks and launch call their wrappers share.

nvcc compiles every source to an object file, one process per source, all
started together, and links them into one shared library with a plain C
interface, loaded with ctypes — no PyTorch headers, so a build takes
seconds. The library goes into `gorder_tpu_torch/_build/` (git-ignored),
keyed by a hash of the sources and flags like the XTC codec's build
(gorder_tpu/io/native.py). Nothing here runs at import time.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

# -fmad=false, -prec-div=true and -prec-sqrt=true keep every f32 step of
# the per-sample chain separately and correctly rounded (the sources also
# spell add, multiply and divide out with _rn intrinsics); -Xptxas=-v
# reports registers and spills.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xptxas=-v", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None


class Trig(ctypes.Structure):
    """csrc/ua.cu `Trig`, passed by value: the pinned cos/sin constants."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "cos_tet", "sin_tet", "cos_half", "sin_half", "cos_ch3", "sin_ch3")]


class MapGrid(ctypes.Structure):
    """csrc/common.cuh `MapGrid`, passed by value: an ordermap's grid and
    its int64 state (a null state: no map)."""
    _fields_ = ([("state", ctypes.c_void_p)]
                + [(name, ctypes.c_float)
                   for name in ("start0", "start1", "bin0", "bin1")]
                + [(name, ctypes.c_int)
                   for name in ("ax0", "ax1", "n0", "n1")])


class GeoShape(ctypes.Structure):
    """csrc/common.cuh `GeoShape`, passed by value: a geometry's inside
    test (`core/geometry.py ShapeBounds`), kind -1 without one."""
    _fields_ = [("kind", ctypes.c_int), ("invert", ctypes.c_int),
                ("orientation", ctypes.c_int), ("has_radius", ctypes.c_int),
                ("bounded", ctypes.c_int * 3), ("lo", ctypes.c_float * 3),
                ("extent", ctypes.c_float * 3), ("radius2", ctypes.c_float)]


_vp = ctypes.c_void_p
_int = ctypes.c_int
# category, x, [scale,] target, h1, h2, h3, mol, bond_type, box, normal,
# trig, mask, classes, out, map, geo, reference, n_frames, n_atoms, n_cat,
# n_types, pbc, mol_normals, n_molecules, accumulate, stream
_UA = [_int] + [_vp] * 8 + [_vp, _vp, Trig, _vp, _vp, _vp, MapGrid,
                            GeoShape, _vp] + [_int] * 8 + [_vp]
# every P2 entry point ends: classes, bond_mol, geo, out, [map,] its ints,
# mol_normals, n_molecules, stream
_SIGNATURES = {
    "p2_b7": [_vp] * 13 + [_int] * 8 + [_vp],
    "p2_positions_i16": [_vp] * 12 + [_int] * 7 + [_vp],
    "p2_positions_i16_pair": [_vp] * 12 + [MapGrid] + [_int] * 7 + [_vp],
    "p2_positions_i32": [_vp] * 12 + [_int] * 7 + [_vp],
    "p2_positions_i32_pair": [_vp] * 12 + [MapGrid] + [_int] * 7 + [_vp],
    "p2_positions_f32": [_vp] * 11 + [MapGrid] + [_int] * 7 + [_vp],
    "ua_positions_i16": _UA,
    "ua_positions_i32": _UA,
    "ua_positions_f32": _UA[:2] + _UA[3:],
    # neighbors.cu: the pointers, the sizes, r2, margin, pbc, tile, stream
    "normal_cloud": [_vp] * 5 + [_int] * 3 + [ctypes.c_float] * 2
                    + [_int] * 2 + [_vp],
    "local_sums": [_vp] * 4 + [_int] * 3 + [ctypes.c_float] * 2
                  + [_int] * 2 + [_vp],
    # spectral.cu: the pointers (a null scratch: shared memory; null
    # steps: not recorded), the sizes, [sigma, pbc, triangle, tile |
    # iters, warp | iters, ring,] stream
    "spectral_affinity": [_vp] * 4 + [_int] * 2 + [ctypes.c_float]
                         + [_int] * 3 + [_vp],
    "top3_subspace": [_vp] * 5 + [_int] * 4 + [_vp],
    "top2_span": [_vp] * 5 + [_int] * 2 + [_vp],
    "rayleigh_kmeans": [_vp] * 5 + [_int] * 4 + [_vp],
    # xtc.cu: raw, lengths, slot_of, out, status, n_frames, stride,
    # first_n, n_out, stream
    "xtc_decode": [_vp] * 5 + [_int, ctypes.c_longlong] + [_int] * 2
                  + [_vp],
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return found


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> tuple[Path, str]:
    """Compile `csrc/*.cu` unless an up-to-date library exists. Returns
    (library path, compiler output — empty when it was already built)."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    so_path = _BUILD / f"libgorder_kernels-{digest.hexdigest()[:16]}.so"
    if so_path.exists():
        return so_path, ""
    _BUILD.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objects = [_BUILD / f"{src.stem}-{tag}.o" for src in sources]
    with cf.ThreadPoolExecutor(max_workers=len(sources)) as pool:
        logs = list(pool.map(
            _run, [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                   for src, obj in zip(sources, objects)]))
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    logs.append(_run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objects),
                      "-o", str(tmp)]))
    for obj in objects:
        obj.unlink()
    os.replace(tmp, so_path)
    return so_path, "".join(logs)


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device`: what an entry point of the library takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def device_of(t):
    """The device of a wrapper's first tensor: the CPU (plain version) or
    a CUDA device (the kernel)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels take CPU or CUDA tensors, not "
                         f"{t.device}")
    return t.device


def frame_args(box_diag, frame_mask, bond_type, n_frames, n_samples,
               device):
    """Check the per-frame arguments every order kernel takes; returns the
    frame mask as uint8."""
    check_tensor("box_diag", box_diag, torch.float32, (n_frames, 3), device)
    if frame_mask.dtype == torch.bool:
        frame_mask = frame_mask.view(torch.uint8)
    check_tensor("frame_mask", frame_mask, torch.uint8, (n_frames,), device)
    check_tensor("bond_type", bond_type, torch.int32, (n_samples,), device)
    return frame_mask


def normal_args(normal, n_frames, device) -> int:
    """Check the membrane normal: the static (3,) f32 normal, or (B, M, 3)
    f32 per-molecule normals (the `per_bond_normal` variants). Returns M,
    or 0 for the static normal."""
    if normal.dim() == 1:
        check_tensor("normal", normal, torch.float32, (3,), device)
        return 0
    if normal.dim() != 3 or normal.shape[1] == 0:
        raise ValueError(f"normal has shape {tuple(normal.shape)}, expected "
                         f"(3,) or (n_frames, n_molecules, 3)")
    check_tensor("normal", normal, torch.float32,
                 (n_frames, normal.shape[1], 3), device)
    return int(normal.shape[1])


def leaflet_args(classes, bond_mol, n_frames, n_samples, device):
    """Check the `with_leaflets` arguments: classes (B, M) int32 and the
    (n_samples,) int32 molecule of each sample, or both None. Returns
    (classes, bond_mol, M); M is 0 without classes."""
    if classes is None and bond_mol is None:
        return None, None, 0
    if classes is None or bond_mol is None:
        raise ValueError("leaflet classes need bond_mol, and bond_mol needs "
                         "classes")
    if classes.dim() != 2:
        raise ValueError(f"classes has shape {tuple(classes.shape)}, "
                         f"expected (n_frames, n_molecules)")
    check_tensor("classes", classes, torch.int32,
                 (n_frames, classes.shape[1]), device)
    check_tensor("bond_mol", bond_mol, torch.int32, (n_samples,), device)
    return classes, bond_mol, int(classes.shape[1])


def molecule_args(normal, classes, bond_mol, n_frames, n_samples, device):
    """Check what a kernel reads by each sample's molecule: per-molecule
    normals (`normal_args`) and leaflet classes (`leaflet_args`), with the
    (n_samples,) int32 `bond_mol`, given exactly when either is. Returns
    (per-molecule normals?, classes, bond_mol, M); M is 0 when neither."""
    n_normals = normal_args(normal, n_frames, device)
    if n_normals and classes is None:
        if bond_mol is None:
            raise ValueError("per-molecule normals need bond_mol")
        check_tensor("bond_mol", bond_mol, torch.int32, (n_samples,),
                     device)
        return True, None, bond_mol, n_normals
    classes, bond_mol, n_molecules = leaflet_args(classes, bond_mol,
                                                  n_frames, n_samples, device)
    if n_normals and n_normals != n_molecules:
        raise ValueError(f"normals of {n_normals} molecules and classes of "
                         f"{n_molecules}")
    return bool(n_normals), classes, bond_mol, n_molecules


def shape_args(spec, reference, n_frames, device) -> GeoShape:
    """Check a UA geometry: `spec` a `core.geometry.GeometrySpec` and
    `reference` its contiguous (B, 3) f32 point per frame on `device`, or
    both None. Returns their GeoShape (kind -1 without one): the f32
    bounds of `core.geometry.shape_bounds`, which ctypes passes exactly."""
    from ..core.geometry import shape_bounds

    if (spec is None) != (reference is None):
        raise ValueError("a geometry needs its reference, and a reference "
                         "its geometry")
    if spec is None:
        return GeoShape(kind=-1)
    check_tensor("reference", reference, torch.float32, (n_frames, 3),
                 device)
    g = shape_bounds(spec)
    return GeoShape(g.kind, int(g.invert), g.orientation,
                    int(g.radius2 is not None),
                    (ctypes.c_int * 3)(*map(int, g.bounded)),
                    (ctypes.c_float * 3)(*g.lo),
                    (ctypes.c_float * 3)(*g.extent),
                    g.radius2 if g.radius2 is not None else 0.0)


def geo_args(geo, n_frames, n_bonds, device):
    """Check a geometry bitplane: (B, ⌈N/8⌉) contiguous uint8 on `device`
    (`engine/wire.py geo_bits`), or None. Returns it."""
    if geo is not None:
        check_tensor("geo", geo, torch.uint8, (n_frames, (n_bonds + 7) // 8),
                     device)
    return geo


def map_args(spec, state, n_classes: int, n_types: int, device) -> MapGrid:
    """Check an ordermap: `spec` a `core.ordermap.MapSpec` and `state` its
    contiguous (n_classes, 2, T·n0·n1 + 1) int64 state on `device`.
    Returns their MapGrid, or the null grid when `state` is None. ctypes
    rounds the float fields to f32, as the JAX package's map_cells takes
    its Python-float start and bin size."""
    from ..core.ordermap import MapSpec

    if state is None:
        return MapGrid()
    if not isinstance(spec, MapSpec):
        raise TypeError(f"map_spec is {type(spec).__name__}, expected "
                        f"MapSpec")
    check_tensor("map_state", state, torch.int64,
                 (n_classes, 2, n_types * spec.ncells + 1), device)
    return MapGrid(state.data_ptr(), spec.start0, spec.start1, spec.bin0,
                   spec.bin1, spec.ax0, spec.ax1, spec.n0, spec.n1)


def call(fn_name: str, *args) -> None:
    """Enqueue one launch through entry point `fn_name`; raise if the
    launch was refused."""
    lib = load()
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.kernel_error_string(rc).decode()}")


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with every entry point's
    argument types declared (pointers and the stream as c_void_p)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()[0]))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB
