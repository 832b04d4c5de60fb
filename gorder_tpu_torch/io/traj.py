"""Unified trajectory reading: XTC/TRR/GRO, multi-file concatenation,
time-window + stride selection, batched subset decode.

Behavioral reference: the reference's `read_trajectory` dispatch
(src/analysis/common.rs:239-342) and its trajectory-concatenation semantics
(CHANGELOG §1.1: duplicate frames at file boundaries are analyzed only once).

The reader is host-side; it produces NumPy frame batches `(B, first_n, 3)`
that the engine ships to the TPU. `first_n` is the number of leading atoms to
decode (the Master group is arranged to be a prefix permutation — atoms past
the highest selected index are never decompressed).
"""

from __future__ import annotations

import glob as _glob
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..errors import AnalysisError, TrajectoryError
from . import native

_XTC_EXT = (".xtc",)
_TRR_EXT = (".trr",)
_GRO_EXT = (".gro",)

# trajectory formats the reference dropped in v0.7 with a dedicated
# deprecation message (src/input/analysis.rs:358-360)
_DEPRECATED_EXT = (".pdb", ".nc", ".dcd", ".lammpstrj")


def _traj_format(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext in _XTC_EXT:
        return "xtc"
    if ext in _TRR_EXT:
        return "trr"
    if ext in _GRO_EXT:
        return "gro"
    if ext in _DEPRECATED_EXT:
        return "deprecated"
    return "unknown"


def validate_trajectory_formats(paths: List[str]) -> None:
    """Reference-parity trajectory format validation
    (src/input/analysis.rs:342-378): XTC/TRR freely concatenable, GRO only
    alone, PDB/NC/DCD/LAMMPSTRJ deprecated since v0.7, mixed formats
    rejected."""
    from ..errors import ConfigError

    if not paths:
        raise ConfigError("no trajectory file has been provided")
    last = None
    for path in paths:
        fmt = _traj_format(path)
        if fmt == "gro":
            if len(paths) > 1:
                raise ConfigError(
                    "trajectory concatenation is only supported for XTC and "
                    "TRR files; please provide only one trajectory file")
        elif fmt == "deprecated":
            raise ConfigError(
                "since 'gorder' v0.7, PDB, NC, DCD, and LAMPPSTR "
                "trajectories are not supported; if you want to use them, "
                "switch to version 0.6")
        elif fmt == "unknown":
            raise ConfigError(
                f"the provided trajectory file '{path}' has an unknown, "
                f"invalid, or unsupported format")
        if last is not None and fmt != last[0]:
            raise ConfigError(
                f"the provided trajectory files '{path}' and '{last[1]}' "
                f"have inconsistent file format")
        last = (fmt, path)


def expand_trajectory_paths(spec) -> List[str]:
    """Expand a path / glob / list-of-paths into an ordered file list."""
    if isinstance(spec, (list, tuple)):
        paths: List[str] = []
        for s in spec:
            paths.extend(expand_trajectory_paths(s))
        return paths
    if any(ch in spec for ch in "*?["):
        matched = sorted(_glob.glob(spec))
        if not matched:
            raise TrajectoryError(f"no trajectory files match '{spec}'")
        return matched
    return [spec]


@dataclass
class _FileIndex:
    path: str
    fmt: str                     # 'xtc' | 'trr' | 'gro'
    offsets: np.ndarray          # (n,) int64 (gro: frame ordinal)
    natoms: np.ndarray
    steps: np.ndarray
    times: np.ndarray
    # xtc-only: each frame's record bytes (the gap to the next offset)
    sizes: Optional[np.ndarray] = None
    # gro-only: preparsed coordinates/boxes
    gro_coords: Optional[np.ndarray] = None
    gro_boxes: Optional[np.ndarray] = None


def _index_file(path: str) -> _FileIndex:
    ext = os.path.splitext(path)[1].lower()
    if ext in _XTC_EXT:
        info = native.xtc_scan(path)
        offsets = info["offsets"]
        sizes = np.diff(np.append(offsets, os.path.getsize(path)))
        return _FileIndex(path, "xtc", offsets, info["natoms"],
                          info["steps"], info["times"], sizes=sizes)
    if ext in _TRR_EXT:
        info = native.trr_scan(path)
        keep = info["has_coords"]
        return _FileIndex(path, "trr", info["offsets"][keep],
                          info["natoms"][keep], info["steps"][keep],
                          info["times"][keep])
    if ext in _GRO_EXT:
        return _index_gro(path)
    raise TrajectoryError(
        f"'{path}' does not have a supported trajectory format "
        f"(supported: xtc, trr, gro)"
    )


def _index_gro(path: str) -> _FileIndex:
    """Multi-frame GRO trajectory: parse all frames up-front (small files)."""
    from .gro import _parse_gro_box

    with open(path, "r") as fh:
        lines = fh.read().splitlines()
    coords, boxes, times = [], [], []
    pos = 0
    frame = 0
    while pos + 2 <= len(lines):
        title = lines[pos]
        try:
            n = int(lines[pos + 1].strip())
        except ValueError:
            raise TrajectoryError(
                f"could not parse frame {frame} of gro trajectory '{path}'"
            ) from None
        if pos + 2 + n + 1 > len(lines):
            raise TrajectoryError(f"truncated gro trajectory '{path}'")
        xyz = np.empty((n, 3), np.float32)
        for i in range(n):
            values = lines[pos + 2 + i][20:].split()
            xyz[i] = [float(v) for v in values[0:3]]
        box = _parse_gro_box(lines[pos + 2 + n].split(), path)
        t = 0.0
        if "t=" in title:
            try:
                t = float(title.rsplit("t=", 1)[1].split()[0])
            except (ValueError, IndexError):
                t = float(frame)
        else:
            t = float(frame)
        coords.append(xyz)
        boxes.append(box)
        times.append(t)
        pos += 2 + n + 1
        frame += 1
        while pos < len(lines) and not lines[pos].strip():
            pos += 1
    n_frames = len(coords)
    natoms = coords[0].shape[0] if n_frames else 0
    return _FileIndex(
        path, "gro",
        offsets=np.arange(n_frames, dtype=np.int64),
        natoms=np.full(n_frames, natoms, np.int32),
        steps=np.arange(n_frames, dtype=np.int32),
        times=np.array(times, np.float32),
        gro_coords=np.stack(coords) if n_frames else None,
        gro_boxes=np.stack(boxes) if n_frames else None,
    )


@dataclass
class AtomSubset:
    """Which atoms to extract from each frame, and the output layout.

    The reference reads only Master-group atoms from XTC
    (src/analysis/common.rs:283-304); this is the TPU-era equivalent: the
    decoder early-stops after `first_n` atoms and gathers the selected ones
    into compact output slots, so the wire carries exactly the analyzed
    subset."""

    first_n: int                          # decode bound: max(sel) + 1
    n_out: int                            # output columns (≥ n_sel; padded)
    sel: Optional[np.ndarray] = None      # (n_sel,) sorted global indices
    slot_of: Optional[np.ndarray] = None  # (first_n,) int32; -1 = skip

    @staticmethod
    def prefix(first_n: int, n_out: Optional[int] = None) -> "AtomSubset":
        return AtomSubset(first_n=first_n, n_out=n_out or first_n)

    @staticmethod
    def from_indices(sel: np.ndarray, n_out: Optional[int] = None
                     ) -> "AtomSubset":
        sel = np.asarray(sel, np.int64)
        first_n = int(sel[-1]) + 1
        if len(sel) == first_n:           # contiguous prefix: no slot map
            return AtomSubset.prefix(first_n, n_out)
        slot_of = np.full(first_n, -1, np.int32)
        slot_of[sel] = np.arange(len(sel), dtype=np.int32)
        return AtomSubset(first_n=first_n, n_out=n_out or len(sel),
                          sel=sel, slot_of=slot_of)

    @property
    def n_sel(self) -> int:
        return len(self.sel) if self.sel is not None else self.first_n

    def gather_host(self, coords: np.ndarray) -> np.ndarray:
        """Apply the subset to host-decoded (n, A, 3) coords (gro/trr
        fallback paths), padding columns to n_out."""
        part = coords[:, self.sel] if self.sel is not None \
            else coords[:, :self.first_n]
        if part.shape[1] == self.n_out:
            return part
        out = np.zeros((part.shape[0], self.n_out, 3), part.dtype)
        out[:, :part.shape[1]] = part
        return out


def _as_subset(subset) -> AtomSubset:
    return subset if isinstance(subset, AtomSubset) \
        else AtomSubset.prefix(int(subset))


class Trajectory:
    """Concatenated multi-file trajectory with a global frame table."""

    def __init__(self, paths, expected_atoms: Optional[int] = None):
        self.paths = expand_trajectory_paths(paths)
        self.expected_atoms = expected_atoms
        validate_trajectory_formats(self.paths)
        self.files = [_index_file(p) for p in self.paths]

        for f in self.files:
            if len(f.natoms) and expected_atoms is not None:
                if int(f.natoms[0]) != expected_atoms:
                    raise TrajectoryError(
                        f"number of atoms in trajectory '{f.path}' "
                        f"({int(f.natoms[0])}) does not match the structure "
                        f"({expected_atoms})"
                    )

        # global frame table with boundary dedup: when the first frame of the
        # next file has the same time as the last kept frame, skip it
        file_ids, local_idx = [], []
        last_time = None
        for fid, f in enumerate(self.files):
            start = 0
            if (
                last_time is not None
                and len(f.times)
                and np.float32(f.times[0]) == np.float32(last_time)
            ):
                start = 1
            count = len(f.times)
            for i in range(start, count):
                file_ids.append(fid)
                local_idx.append(i)
            if count:
                last_time = f.times[count - 1]
        self.frame_file = np.array(file_ids, np.int32)
        self.frame_local = np.array(local_idx, np.int64)
        self.times = np.array(
            [self.files[fid].times[li] for fid, li in zip(file_ids, local_idx)],
            np.float32,
        )
        self.steps = np.array(
            [self.files[fid].steps[li] for fid, li in zip(file_ids, local_idx)],
            np.int64,
        )

    @property
    def n_frames(self) -> int:
        return len(self.frame_file)

    # ------------------------------------------------------------- selection
    def select_frames(self, begin: Optional[float], end: Optional[float],
                      step: int) -> np.ndarray:
        """Global frame indices for the [begin, end] window with stride."""
        if step < 1:
            raise AnalysisError("step must be at least 1")
        mask = np.ones(self.n_frames, dtype=bool)
        if begin is not None:
            mask &= self.times >= np.float32(begin)
        if end is not None:
            mask &= self.times <= np.float32(end)
        idx = np.nonzero(mask)[0]
        return idx[::step]

    # --------------------------------------------------------------- reading
    def _segments(self, frame_indices: np.ndarray):
        """Contiguous same-file runs of the batch, in row order."""
        fids = self.frame_file[frame_indices]
        bounds = np.flatnonzero(np.diff(fids)) + 1
        for rows in np.split(np.arange(len(frame_indices)), bounds):
            fid = fids[rows[0]]
            yield (slice(rows[0], rows[-1] + 1), self.files[fid],
                   self.frame_local[frame_indices[rows]])

    def _all_xtc(self, frame_indices: np.ndarray) -> bool:
        if len(frame_indices) == 0:
            return False
        fids = self.frame_file[frame_indices]
        return all(self.files[f].fmt == "xtc" for f in np.unique(fids))

    def read_frames(self, frame_indices: Sequence[int], subset,
                    n_threads: int = 1, out: Optional[np.ndarray] = None):
        """Decode the given global frames → (coords, boxes, times, steps).

        `subset` is an AtomSubset (or a plain int = prefix length). `out`
        may supply a reusable (≥n, n_out, 3) f32 buffer; page-faulting a
        fresh buffer per batch costs more than the decode itself.
        """
        sub = _as_subset(subset)
        frame_indices = np.asarray(frame_indices, np.int64)
        n = len(frame_indices)
        if out is not None and out.shape[0] >= n and out.shape[1] == sub.n_out:
            coords = out[:n]
        else:
            coords = np.empty((n, sub.n_out, 3), np.float32)
        boxes = np.empty((n, 3, 3), np.float32)
        times = np.empty(n, np.float32)
        steps = np.empty(n, np.int64)

        for sl, f, local in self._segments(frame_indices):
            if f.fmt == "xtc":
                c, b, t, s = native.xtc_decode(
                    f.path, f.offsets[local], sub.first_n,
                    slot_of=sub.slot_of, n_out=sub.n_out, n_threads=n_threads)
            elif f.fmt == "trr":
                c, b, t, s = native.trr_decode(f.path, f.offsets[local],
                                               sub.first_n)
                c = sub.gather_host(c)
            else:  # gro
                c = sub.gather_host(f.gro_coords[local])
                b = f.gro_boxes[local]
                t = f.times[local]
                s = f.steps[local]
            coords[sl] = c
            boxes[sl] = b
            times[sl] = t
            steps[sl] = s
        return coords, boxes, times, steps

    def read_frames_quantized(self, frame_indices: Sequence[int],
                              subset, n_threads: int = 1,
                              out: Optional[np.ndarray] = None):
        """Decode XTC frames as fixed-point int16 (halves the host→device
        transfer; `float(i16) * inv_precision` is bit-identical to the f32
        decode). Returns (coords_i16, inv_precision, boxes, times, steps) or
        None when unsupported (non-XTC files or coordinates out of range)."""
        sub = _as_subset(subset)
        frame_indices = np.asarray(frame_indices, np.int64)
        if not self._all_xtc(frame_indices):
            return None
        n = len(frame_indices)
        if out is not None and out.shape[0] >= n \
                and out.shape[1] == sub.n_out and out.dtype == np.int16:
            coords = out[:n]
        else:
            coords = np.zeros((n, sub.n_out, 3), np.int16)
        inv_prec = np.empty(n, np.float32)
        boxes = np.empty((n, 3, 3), np.float32)
        times = np.empty(n, np.float32)
        steps = np.empty(n, np.int64)
        for sl, f, local in self._segments(frame_indices):
            res = native.xtc_decode_i16(f.path, f.offsets[local], sub.first_n,
                                        slot_of=sub.slot_of, n_out=sub.n_out,
                                        out=coords[sl], n_threads=n_threads)
            if res is None:
                return None
            c, ip, b, t, s = res
            inv_prec[sl] = ip
            boxes[sl] = b
            times[sl] = t
            steps[sl] = s
        return coords, inv_prec, boxes, times, steps

    def _xtc_natoms(self, frame_indices: np.ndarray) -> int:
        """The atom count every frame of the xtc wire has: the structure's,
        or without one the first frame's."""
        if self.expected_atoms is not None:
            return int(self.expected_atoms)
        return int(self.files[self.frame_file[frame_indices[0]]].natoms[0])

    def xtc_layout(self, frame_indices: Sequence[int]):
        """(stride, mean record bytes) of the xtc wire for the frames
        (`read_frames_xtc`): rows of the largest record rounded up to 16
        bytes, and the mean record, both from the scan's offsets; None
        unless every frame is a compressed XTC frame (more than 9 atoms)
        of the structure's atom count."""
        frame_indices = np.asarray(frame_indices, np.int64)
        if not self._all_xtc(frame_indices):
            return None
        natoms = self._xtc_natoms(frame_indices)
        sizes = []
        for _sl, f, local in self._segments(frame_indices):
            if natoms <= 9 or (f.natoms[local] != natoms).any():
                return None
            sizes.append(f.sizes[local])
        sizes = np.concatenate(sizes)
        return (int(sizes.max()) + 15) // 16 * 16, float(sizes.mean())

    def read_frames_xtc(self, frame_indices: Sequence[int],
                        raw_out: np.ndarray, lengths_out: np.ndarray,
                        n_threads: int = 1):
        """Copy the frames' whole XTC records into the rows of `raw_out`
        ((≥ n, stride) uint8, stride at least `xtc_layout`'s) and
        their lengths into `lengths_out` (native/xdr.cpp xtc_read_raw): the
        xtc wire, which the card decodes (`ops/xtc.py`). Returns
        (inv_precision, boxes, times, steps), or None when a frame does not
        fit the wire (non-XTC input, a plain frame, another atom count, a
        longer record, a range the decoder refuses)."""
        frame_indices = np.asarray(frame_indices, np.int64)
        if not self._all_xtc(frame_indices):
            return None
        n = len(frame_indices)
        inv_prec = np.empty(n, np.float32)
        boxes = np.empty((n, 3, 3), np.float32)
        times = np.empty(n, np.float32)
        steps = np.empty(n, np.int32)
        natoms = self._xtc_natoms(frame_indices)
        for sl, f, local in self._segments(frame_indices):
            if native.xtc_read_raw(f.path, f.offsets[local], natoms,
                                   raw_out[sl], lengths_out[sl],
                                   inv_prec[sl], boxes[sl], times[sl],
                                   steps[sl], n_threads=n_threads) != 0:
                return None
        return inv_prec, boxes, times, steps.astype(np.int64)

    def read_frames_packed12(self, frame_indices: Sequence[int],
                             subset, n_threads: int = 1,
                             out: Optional[np.ndarray] = None):
        """Decode XTC frames as 12-bit packed fixed-point integers (25%
        fewer host→device bytes than int16; device unpack + dequantize is
        bit-identical to the f32 decode). Returns (packed_u8 (n, stride),
        inv_precision, boxes, times, steps) or None when unsupported."""
        sub = _as_subset(subset)
        frame_indices = np.asarray(frame_indices, np.int64)
        if not self._all_xtc(frame_indices):
            return None
        n = len(frame_indices)
        stride = native.i12_stride(sub.n_out)
        if out is not None and out.shape[0] >= n and out.shape[1] == stride \
                and out.dtype == np.uint8:
            coords = out[:n]
        else:
            coords = np.zeros((n, stride), np.uint8)
        inv_prec = np.empty(n, np.float32)
        boxes = np.empty((n, 3, 3), np.float32)
        times = np.empty(n, np.float32)
        steps = np.empty(n, np.int64)
        for sl, f, local in self._segments(frame_indices):
            res = native.xtc_decode_i12(f.path, f.offsets[local], sub.first_n,
                                        slot_of=sub.slot_of, n_out=sub.n_out,
                                        out=coords[sl], n_threads=n_threads)
            if res is None:
                return None
            c, ip, b, t, s = res
            inv_prec[sl] = ip
            boxes[sl] = b
            times[sl] = t
            steps[sl] = s
        return coords, inv_prec, boxes, times, steps

    def read_frames_delta8(self, frame_indices: Sequence[int], subset,
                           lo_out: np.ndarray, corr_idx_out: np.ndarray,
                           corr_hi_out: np.ndarray, n_threads: int = 1):
        """Decode XTC frames in the temporal-delta wire format: int8
        per-value deltas vs the previous frame plus sparse int16 corrections,
        anchored on an int32 absolute first frame. ~3 bytes/atom on the wire;
        on-device cumsum reconstruction is bit-identical to the f32 decode
        (native/xdr.cpp xtc_decode_d8).

        Fills the caller's (n, n_out, 3) int8 / (n, K) int32 / (n, K) int16
        buffers and returns ((abs0 (n_out, 3) int32, inv_precision, boxes,
        times, steps), max_ncorr). The payload is None when unsupported
        (non-XTC input, mixed compression precision, correction overflow) —
        max_ncorr still reports the observed per-frame correction demand so
        the caller can re-size the capacity and retry."""
        sub = _as_subset(subset)
        frame_indices = np.asarray(frame_indices, np.int64)
        if not self._all_xtc(frame_indices):
            return None, 0
        n = len(frame_indices)
        abs0 = np.zeros((sub.n_out, 3), np.int32)
        base = np.zeros(sub.n_out * 3, np.int32)
        inv_prec = np.empty(n, np.float32)
        boxes = np.empty((n, 3, 3), np.float32)
        times = np.empty(n, np.float32)
        steps = np.empty(n, np.int64)
        has_base = False
        prev_inv = None
        worst_ncorr = 0
        failed = False
        for sl, f, local in self._segments(frame_indices):
            st32 = np.empty(sl.stop - sl.start, np.int32)
            rc, max_ncorr = native.xtc_decode_d8(
                f.path, f.offsets[local], sub.first_n, base, has_base,
                abs0.reshape(-1), lo_out[sl], corr_idx_out[sl],
                corr_hi_out[sl], inv_prec[sl], boxes[sl], times[sl], st32,
                slot_of=sub.slot_of, n_out=sub.n_out, n_threads=n_threads)
            worst_ncorr = max(worst_ncorr, max_ncorr)
            if rc != 0:
                failed = True
                continue  # keep scanning to report full correction demand
            # the integer delta chain requires one compression precision
            # across file boundaries too
            if prev_inv is not None and inv_prec[sl.start] != prev_inv:
                return None, worst_ncorr
            prev_inv = inv_prec[sl.stop - 1]
            steps[sl] = st32
            has_base = True
        if failed:
            return None, worst_ncorr
        return (abs0, inv_prec, boxes, times, steps), worst_ncorr

    def read_frames_s6(self, frame_indices: Sequence[int], subset,
                       group_of: np.ndarray, n_groups: int,
                       pack_out: np.ndarray, esc_gap_out: np.ndarray,
                       esc_val_out: np.ndarray, gmean_out: np.ndarray,
                       n_threads: int = 1, w_base: int = 24):
        """Decode XTC frames in the smoothed-base 6-bit residual wire
        format (~0.77 B/value): a per-batch per-value int32 base, per-frame
        per-group int16 medians, packed 6-bit residuals and a sparse
        (gap u16, val i16) escape channel. Device reconstruction
        `base + median[group] + residual` is bit-identical to the f32
        decode (native/xdr.cpp xtc_decode_s6) with no cross-frame chain.

        Fills the caller's buffers and returns ((base (n_out*3,) int32,
        inv_precision, boxes, times, steps), max_nesc). The payload is None
        when unsupported (non-XTC input, mixed compression precision,
        escape demand over capacity, escape value outside int16) —
        max_nesc still reports the demand so the caller can re-size."""
        sub = _as_subset(subset)
        frame_indices = np.asarray(frame_indices, np.int64)
        if not self._all_xtc(frame_indices):
            return None, 0
        n = len(frame_indices)
        base = np.zeros(sub.n_out * 3, np.int32)
        inv_prec = np.empty(n, np.float32)
        boxes = np.empty((n, 3, 3), np.float32)
        times = np.empty(n, np.float32)
        steps = np.empty(n, np.int64)
        has_base = False
        prev_inv = None
        worst_nesc = 0
        failed = False
        for sl, f, local in self._segments(frame_indices):
            st32 = np.empty(sl.stop - sl.start, np.int32)
            rc, max_nesc = native.xtc_decode_s6(
                f.path, f.offsets[local], sub.first_n, group_of, n_groups,
                gmean_out.shape[1], w_base, base, has_base,
                gmean_out[sl], pack_out[sl], esc_gap_out[sl],
                esc_val_out[sl], inv_prec[sl], boxes[sl], times[sl], st32,
                slot_of=sub.slot_of, n_out=sub.n_out, n_threads=n_threads)
            worst_nesc = max(worst_nesc, max_nesc)
            if rc != 0:
                failed = True
                continue  # keep scanning to report the full escape demand
            if prev_inv is not None and inv_prec[sl.start] != prev_inv:
                return None, worst_nesc
            prev_inv = inv_prec[sl.stop - 1]
            steps[sl] = st32
            has_base = True
        if failed:
            return None, worst_nesc
        return (base, inv_prec, boxes, times, steps), worst_nesc

    def read_frames_b7(self, frame_indices: Sequence[int], subset,
                       bond_a: np.ndarray, bond_b: np.ndarray,
                       pack_out: np.ndarray, esc_gap_out: np.ndarray,
                       esc_val_out: np.ndarray,
                       n_threads: int = 1, w_base: int = 24,
                       aux_slots: np.ndarray = None,
                       aux_out: np.ndarray = None,
                       cog_slots: np.ndarray = None, cog_axis: int = 2,
                       cog_out: np.ndarray = None,
                       geo: tuple = None, geo_out: np.ndarray = None):
        """Decode XTC frames in the bond-difference 7-bit wire format
        (~0.875 B per bond-vector value): the per-bond integer differences
        d = c[bond_b] - c[bond_a] (exact int32 arithmetic) coded as 7-bit
        residuals vs a per-batch median base plus a sparse (gap u16,
        val i16) escape channel (native/xdr.cpp xtc_decode_b7). Ships only
        bond VECTORS — the bond-order hot path never sees absolute
        positions, so per-group drift medians are unnecessary (drift
        cancels in the difference). The integers are bit-exact; the f32
        bond vector f32(d)·(1/precision) differs from the position-pair
        formulation by its last ulp (see xdr.cpp commentary).

        Optional side channels for leaflet-classifying runs (see
        native/xdr.cpp emit_channels): aux_out (n, n_aux, 3) int32
        absolute positions of the aux_slots subset; cog_out (n,) f32
        refined Bai-Breen center of the cog_slots subset along cog_axis.

        Fills the caller's buffers and returns ((base (n_bonds*3,) int32,
        inv_precision, boxes, times, steps), max_nesc); None payload when
        unsupported, like read_frames_s6."""
        sub = _as_subset(subset)
        frame_indices = np.asarray(frame_indices, np.int64)
        if not self._all_xtc(frame_indices):
            return None, 0
        n = len(frame_indices)
        base = np.zeros(len(bond_a) * 3, np.int32)
        inv_prec = np.empty(n, np.float32)
        boxes = np.empty((n, 3, 3), np.float32)
        times = np.empty(n, np.float32)
        steps = np.empty(n, np.int64)
        has_base = False
        prev_inv = None
        worst_nesc = 0
        failed = False
        for sl, f, local in self._segments(frame_indices):
            st32 = np.empty(sl.stop - sl.start, np.int32)
            rc, max_nesc = native.xtc_decode_b7(
                f.path, f.offsets[local], sub.first_n, bond_a, bond_b,
                w_base, base, has_base,
                pack_out[sl], esc_gap_out[sl], esc_val_out[sl],
                inv_prec[sl], boxes[sl], times[sl], st32,
                slot_of=sub.slot_of, n_out=sub.n_out, n_threads=n_threads,
                aux_slots=aux_slots,
                geo=geo,
                geo_out=geo_out[sl] if geo_out is not None else None,
                aux_out=aux_out[sl] if aux_out is not None else None,
                cog_slots=cog_slots, cog_axis=cog_axis,
                cog_out=cog_out[sl] if cog_out is not None else None)
            worst_nesc = max(worst_nesc, max_nesc)
            if rc != 0:
                failed = True
                continue  # keep scanning to report the full escape demand
            if prev_inv is not None and inv_prec[sl.start] != prev_inv:
                return None, worst_nesc
            prev_inv = inv_prec[sl.stop - 1]
            steps[sl] = st32
            has_base = True
        if failed:
            return None, worst_nesc
        return (base, inv_prec, boxes, times, steps), worst_nesc

    def read_cog_axis(self, frame_indices: Sequence[int], subset,
                      cog_slots: np.ndarray, cog_axis: int,
                      cog_out: np.ndarray, n_threads: int = 1) -> bool:
        """Per-frame refined Bai-Breen membrane center along one axis
        (native/xdr.cpp xtc_cog_axis) — the exact value the b7g wire's
        side channel ships, computed as a standalone pass so
        global-leaflet runs riding a COORDINATE wire classify against
        the same number (bitwise cross-wire output equality; see
        analysis.py channel unification). Fills cog_out[:n]; returns
        False when unsupported (non-XTC frames)."""
        sub = _as_subset(subset)
        frame_indices = np.asarray(frame_indices, np.int64)
        if not self._all_xtc(frame_indices):
            return False
        for sl, f, local in self._segments(frame_indices):
            native.xtc_cog_axis(f.path, f.offsets[local], sub.first_n,
                                cog_slots, cog_axis, cog_out[sl],
                                slot_of=sub.slot_of, n_out=sub.n_out,
                                n_threads=n_threads)
        return True

    def read_geo_mask(self, frame_indices: Sequence[int], subset,
                      bond_a: np.ndarray, bond_b: np.ndarray, spec,
                      ref_mode: int, ref_point, geo_slots,
                      mask_out: np.ndarray, handle_pbc: bool = True,
                      n_threads: int = 1) -> bool:
        """Per-frame per-bond inside-geometry bitplane (native/xdr.cpp
        xtc_geo_mask): the decoder evaluates the shape's inside test on
        every bond midpoint using the kernel's single-rounding integer
        formulation, with selection references from an f64 refined
        circular COG. Every wire format consumes this one mask, so
        geometry output is bitwise identical across wires (the
        read_cog_axis pattern, extended to geometry-restricted runs).
        Fills mask_out[:n]; returns False when unsupported (non-XTC)."""
        sub = _as_subset(subset)
        frame_indices = np.asarray(frame_indices, np.int64)
        if not self._all_xtc(frame_indices):
            return False
        for sl, f, local in self._segments(frame_indices):
            native.xtc_geo_mask(f.path, f.offsets[local], sub.first_n,
                                bond_a, bond_b, spec, ref_mode, ref_point,
                                geo_slots, mask_out[sl],
                                handle_pbc=handle_pbc,
                                slot_of=sub.slot_of, n_out=sub.n_out,
                                n_threads=n_threads)
        return True

    def iter_batches(self, frame_indices: Sequence[int], subset,
                     batch_size: int, n_threads: int = 1
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]]:
        """Yield (coords, boxes, times, steps, analyzed_frame_numbers).

        The coords array is a view into a persistent buffer that is
        overwritten by the next iteration — consumers must copy it to the
        device (jax.device_put does) before advancing.
        """
        sub = _as_subset(subset)
        frame_indices = np.asarray(frame_indices, np.int64)
        buffer = np.zeros((batch_size, sub.n_out, 3), np.float32)
        for lo in range(0, len(frame_indices), batch_size):
            chunk = frame_indices[lo:lo + batch_size]
            coords, boxes, times, steps = self.read_frames(
                chunk, sub, n_threads, out=buffer
            )
            analyzed = np.arange(lo, lo + len(chunk), dtype=np.int64)
            if len(chunk) < batch_size:
                # expose the full fixed-size buffer so callers always ship
                # one shape to the device; rows past len(analyzed) are
                # stale padding masked out by the frame mask
                coords = buffer
            yield coords, boxes, times, steps, analyzed


_PBC_HINT = ("(hint: consider setting 'handle_pbc' to false but make sure "
             "that your lipid molecules are whole)")


def check_box(box: np.ndarray, path_hint: str = "") -> None:
    """Validate an orthogonal, non-zero box (common.rs:186-198);
    wording: src/errors.rs:122-132 (AnalysisError box variants)."""
    box = np.asarray(box)
    if box.size == 0 or not np.isfinite(box).all():
        raise AnalysisError(
            f"system has undefined simulation box {_PBC_HINT}")
    off_diag = box.copy()
    off_diag[np.arange(3), np.arange(3)] = 0.0
    if np.any(off_diag != 0.0):
        raise AnalysisError(
            f"the simulation box is not orthogonal {_PBC_HINT}")
    if np.all(np.diag(box) == 0.0):
        raise AnalysisError(
            f"all dimensions of the simulation box are zero {_PBC_HINT}")
    if np.any(np.diag(box) <= 0.0):
        # not in the reference taxonomy (groan accepts a partially-zero
        # box); min-image math would divide by it, so fail loudly
        raise AnalysisError(
            "the simulation box has a zero or negative dimension "
            f"{_PBC_HINT}")


_DIAG = np.arange(3)


def check_box_batch(boxes: np.ndarray) -> None:
    """Vectorized `check_box` over a (n, 3, 3) batch — one numpy pass
    instead of a per-frame Python loop (the driver shares its single core
    with the decode thread, so per-frame Python is throughput-critical)."""
    boxes = np.asarray(boxes)
    if boxes.size == 0:
        return
    off = boxes.copy()
    off[:, _DIAG, _DIAG] = 0.0
    if off.any():
        check_box(boxes[int(np.argmax((off != 0.0).any(axis=(1, 2))))])
    diag = boxes[:, _DIAG, _DIAG]
    if bool((diag <= 0.0).any()):
        check_box(boxes[int(np.argmax((diag <= 0.0).any(axis=1)))])
