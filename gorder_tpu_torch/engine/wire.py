"""The wires: one entry a wire format (`WIRES`), the pick among them, and
their device-side decoders on tensors (port of `gorder_tpu/engine/wire.py`),
the int16 dequantization, and the geometry bitplane (`geo_bits`, port of
`gorder_tpu/engine/fused.py:69-76`, and its inverse `pack_geo_bits`). In
the JAX package the decoders are XLA code, not Pallas, so here they are
plain PyTorch ops on whatever device the payload lies on.

- b7: bond-vector differences, 7-bit residuals (`b7_residuals`, `b7`);
- s6: absolute XTC integers as a per-batch base, per-frame residue-group
  medians and 6-bit residuals (`s6_ints`);
- d8: 8-bit temporal deltas with sparse high-byte corrections, summed
  over the batch on top of its first frame (`d8_ints`);
- i12: 12-bit packed absolute integers (`unpack12`);
- i16 and f32: positions as they are;
- xtc: each frame's whole compressed record, which the card decodes into
  int32 XTC integers (`ops/xtc.py`): the host only copies it.

`WIRES` holds one entry a format (`Wire`), all that is particular to
it: ring slot, host read, fallback, bytes a frame, probe, per-batch base,
device constants and reconstruction. `engine/batches.py` and
`engine/fused.py` look it up.

s6, d8 and xtc give int32 XTC integers (s6 and d8 exist for trajectories
whose integers overflow int16, a box over 32.767 nm at precision 1000),
i12 gives int16. `pick_wire_format` is the JAX package's
`_pick_wire_format`, with the xtc wire besides: on the card the wire of
the highest modeled end-to-end rate (`_pick_wire_by_rate`), elsewhere the
smallest the trajectory fits, or the one `GORDER_TPU_WIRE` names. Every
wire carries the same integers, so the pick never changes a result.

The bit arithmetic runs in int32: every intermediate below fits, and
PyTorch's unsigned types lack most operations. A scatter whose JAX form
drops out-of-range indices (`mode="drop"`) writes them into one spare
column past the end, sliced off after.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..io.native import b7_stride, geo_stride, i12_stride, s6_stride
from ..ops.xtc import xtc_ints
from ..parallel.mesh import to_device
from ..utils.timers import timers
from .ring import host_buffer

log = logging.getLogger("gorder")


@dataclass(frozen=True)
class Source:
    """What a wire reads and sizes itself by: the trajectory, atom space,
    decoder threads and batch size; s6's residue groups, b7's bond slots,
    xtc's row stride (`Trajectory.xtc_layout`); and the side channels of
    the run's channel class (`engine/channels.py`): the aux or head slots
    and membrane COG the b7 read ships inline, and the geometry's decoder
    arguments (spec, reference, point, selection, handle_pbc)."""

    traj: object
    space: object
    n_threads: int
    batch_size: int
    group_of: Optional[np.ndarray] = None
    n_groups: int = 0
    bond_slots: Optional[tuple] = None
    stride: Optional[int] = None
    aux_slots: Optional[np.ndarray] = None
    cog_slots: Optional[np.ndarray] = None
    cog_axis: int = 2
    geo: Optional[tuple] = None

    @property
    def n_bonds(self) -> int:
        return 0 if self.bond_slots is None else len(self.bond_slots[0])


class Wire:
    """A wire format; the defaults are int16 positions'. `slot` → a ring
    slot's arrays, `rows` frames at capacity `cap`, each made by `zeros`
    (the decode ring lays them in its pool's buffers, `engine/ring.py`);
    `read` fills one with frames `chunk`, padding rows set → (arrays
    shipped, inv_precision or None, boxes), or None when they no longer
    fit: the batch then rides `fallback`, with a warning where `changed`
    says what changed. `probe` → the capacity the run's frames fit, or
    None. A frame mesh copies the base (array `base`) whole to each
    device, or, with `chain`, to the first, each slice decoding on top of
    the one before. A `sided` wire may carry a trailing side channel (the
    `g`, `G` kinds). `constants` ride to the device once a run; `attach`
    adds them, and a (B,) status where `status`, to a batch's tensors;
    `copy_stream` puts its copies on a copy stream; `positions`
    reconstructs it on the device."""

    name, fallback, changed = "i16", "f32", ""
    reader, dtype = "read_frames_quantized", np.int16
    base = chain = None
    sided, status, copy_stream = True, False, False

    def frame_bytes(self, src, cap) -> int:
        """What the pick weighs and the plan logs: a slot's row, and the
        base the pick counts spread over the batch."""
        return (sum(a.nbytes for a in self.slot(src, 1, cap))
                + self.base_bytes(src) // max(src.batch_size, 1))

    def base_bytes(self, src) -> int:
        return 0

    def slot(self, src, rows, cap, zeros=np.zeros):
        return (zeros((rows, src.space.n_out, 3), self.dtype),)

    def pad(self, src, slot, n: int) -> None:
        for a in slot:
            a[n:] = 0

    def read(self, src, chunk, slot):
        self.pad(src, slot, len(chunk))
        res = getattr(src.traj, self.reader)(chunk, src.space, out=slot[0],
                                             n_threads=src.n_threads)
        return None if res is None else (slot, res[1], res[2])

    def probe(self, src, frames):
        """0 where the run's first, middle and last frames fit."""
        idx = frames[np.unique([0, len(frames) // 2, len(frames) - 1])]
        with timers.phase("pick." + self.name):
            timers.count("probe_frames", len(idx))
            fits = self.read(src, idx, self.slot(src, len(idx), 0))
        return None if fits is None else 0

    def constants(self, src):
        return None

    def attach(self, w, const, status):
        return w

    def positions(self, w, n_atoms: int) -> torch.Tensor:
        return w[0]


class _F32(Wire):
    name, fallback, dtype = "f32", None, np.float32

    def read(self, src, chunk, slot):
        self.pad(src, slot, len(chunk))
        _, boxes, _, _ = src.traj.read_frames(chunk, src.space, out=slot[0],
                                              n_threads=src.n_threads)
        return slot, None, boxes

    def probe(self, src, frames):
        return 0


class _I12(Wire):
    name, reader = "i12", "read_frames_packed12"

    def slot(self, src, rows, cap, zeros=np.zeros):
        return (zeros((rows, i12_stride(src.space.n_out)), np.uint8),)

    def positions(self, w, n_atoms):
        return unpack12(w[0], n_atoms)


class _Capped(Wire):
    """A wire with a sparse channel of `cap` entries a frame (b7's and
    s6's escapes: u16 gaps, int16 values; d8's corrections) and a base,
    which `fill` returns, → ((base, inv_precision, boxes, ...) or None,
    the demand seen). `caps`: the first probe's capacity, the least, the
    most, their quantum, and the headroom factor · demand + pad."""

    fallback, base = "i16", 3
    caps = (512, 128, 8192, 128, 1.4, 64)

    def windows(self, src, frames):
        # one batch-sized window: escape demand grows with distance from
        # the in-batch base window, so short probes under-estimate it
        return [frames[:min(src.batch_size, len(frames))]]

    def read(self, src, chunk, slot):
        self.pad(src, slot, len(chunk))   # they decode to the masked base
        res, _ = self.fill(src, chunk, slot)
        return None if res is None else (self.ship(slot, res[0]), res[1],
                                         res[2])

    def ship(self, slot, base):
        return (slot[0], slot[1].view(np.int16), slot[2], base, *slot[3:])

    def probe(self, src, frames):
        cap, least, most, q, factor, pad = self.caps
        with timers.phase("pick." + self.name):
            for _attempt in range(2):
                demand, ok = 0, True
                for w in self.windows(src, frames):
                    timers.count("probe_frames", len(w))
                    res, need = self.fill(src, w, self.slot(src, len(w), cap))
                    demand, ok = max(demand, need), ok and res is not None
                if ok:    # rounded up to the quantum
                    return max(least, min(most, -(-(int(demand * factor)
                                                    + pad) // q) * q))
                if demand <= cap or demand > most:
                    return None  # unfit for reasons other than capacity
                cap = min(most, -(-int(demand * 2) // q) * q)
        return None


class _B7(_Capped):
    """Bond-vector differences; the side channels of the b7 kinds ride in
    its slot, read inline."""

    name, changed, sided = "b7", "escape demand or value range", False

    def base_bytes(self, src):
        return src.n_bonds * 12

    def slot(self, src, rows, cap, zeros=np.zeros):
        side = [zeros((rows, len(src.aux_slots), 3), np.int32)
                ] if src.aux_slots is not None else []
        if src.cog_slots is not None:
            side.append(zeros(rows, np.float32))
        if src.geo is not None:
            side.append(zeros((rows, geo_stride(src.n_bonds)), np.uint8))
        return (zeros((rows, b7_stride(src.n_bonds)), np.uint8),
                zeros((rows, cap), np.uint16),
                zeros((rows, cap), np.int16), *side)

    def fill(self, src, chunk, slot):
        side = iter(slot[3:])
        aux, cog, geo = (None if c is None else next(side)
                         for c in (src.aux_slots, src.cog_slots, src.geo))
        return src.traj.read_frames_b7(
            chunk, src.space, *src.bond_slots, *slot[:3],
            n_threads=src.n_threads, aux_slots=src.aux_slots, aux_out=aux,
            cog_slots=src.cog_slots, cog_axis=src.cog_axis, cog_out=cog,
            geo=src.geo, geo_out=geo)

    def probe(self, src, frames):
        return None if src.bond_slots is None else super().probe(src, frames)

    def positions(self, w, n_atoms):
        return b7(*w[:4])        # bond differences, not positions


class _S6(_Capped):
    name, changed = "s6", "escape demand or value range"

    def base_bytes(self, src):
        return src.space.n_out * 12

    def slot(self, src, rows, cap, zeros=np.zeros):
        return (zeros((rows, s6_stride(src.space.n_out)), np.uint8),
                zeros((rows, cap), np.uint16),
                zeros((rows, cap), np.int16),
                zeros((rows, (src.n_groups + 1) * 3), np.int16))

    def fill(self, src, chunk, slot):
        return src.traj.read_frames_s6(chunk, src.space, src.group_of,
                                       src.n_groups, *slot,
                                       n_threads=src.n_threads)

    def probe(self, src, frames):
        return (None if src.group_of is None or src.n_groups <= 0
                else super().probe(src, frames))

    def constants(self, src):
        return _value_groups(src.group_of, src.n_groups)

    def attach(self, w, const, status):
        return w[:5] + (const,) + w[5:]

    def positions(self, w, n_atoms):
        return s6_ints(*w[:6])


class _D8(_Capped):
    """Temporal deltas on top of the batch's first frame, its base (not
    counted by the pick, as in gorder_tpu's)."""

    name, changed = "d8", "correction demand or compression precision"
    caps = (64, 64, 4096, 64, 2.0, 32)

    def windows(self, src, frames):
        mid = len(frames) // 2
        return [frames[:8]] + ([frames[mid:mid + 8]] if len(frames) > 16
                               else [])

    def slot(self, src, rows, cap, zeros=np.zeros):
        return (zeros((rows, src.space.n_out, 3), np.int8),
                zeros((rows, cap), np.int32),
                zeros((rows, cap), np.int16))

    def pad(self, src, slot, n):
        # padding rows add nothing: they repeat the batch's last frame
        slot[0][n:], slot[1][n:], slot[2][n:] = 0, src.space.n_out * 3, 0

    def fill(self, src, chunk, slot):
        return src.traj.read_frames_delta8(chunk, src.space, *slot,
                                           n_threads=src.n_threads)

    def ship(self, slot, base):
        return (*slot, base)

    def chain(self, lo, ci, ch, a0):
        return d8_last(lo, ci, ch, a0)

    def positions(self, w, n_atoms):
        return d8_ints(*w[:4])


class _Xtc(Wire):
    """The compressed records, in rows of `cap` (the stride) bytes, and
    their lengths; the card decodes them with the run's slot map."""

    name, fallback, changed = "xtc", "i16", "the records' layout"
    sided, status, copy_stream = False, True, True

    def slot(self, src, rows, cap, zeros=np.zeros):
        return zeros((rows, cap), np.uint8), zeros(rows, np.int32)

    def read(self, src, chunk, slot):
        slot[1][len(chunk):] = 0          # padding rows decode to zeros
        res = src.traj.read_frames_xtc(chunk, *slot, n_threads=src.n_threads)
        return None if res is None else (slot, res[0], res[1])

    def probe(self, src, frames):
        return src.stride

    def constants(self, src):
        """The (first_n,) int32 slot of each decoded atom."""
        space = src.space
        return (space.slot_of if space.slot_of is not None
                else np.arange(space.first_n, dtype=np.int32))

    def attach(self, w, const, status):
        return w + (const, status)

    def positions(self, w, n_atoms):
        return xtc_ints(w[0], w[1], w[2], w[2].shape[0], n_atoms, w[3])


#: the wires by name
WIRES = {w.name: w for w in (_B7(), _S6(), _D8(), _I12(), Wire(), _F32(),
                             _Xtc())}


def _value_groups(group_of, n_groups) -> np.ndarray:
    """s6: each value's index into the (n_groups + 1)-wide table of group
    medians (the last group is the always-zero padding group)."""
    g_rep = np.repeat(group_of, 3)
    k_rep = np.tile(np.arange(3), len(group_of))
    return np.where(g_rep >= 0, g_rep * 3 + k_rep,
                    n_groups * 3 + k_rep).astype(np.int32)


def wire_groups(system, space):
    """(group_of, n_groups, vgidx) of the s6 wire: each slot's residue
    group (padding slots -1, which decode to exact zeros), and each
    value's index into the table of group medians (`_value_groups`)."""
    sel = space.sel if space.sel is not None \
        else np.arange(space.first_n, dtype=np.int64)
    res_ids = np.asarray(system.resids)[sel]
    _, ginv = np.unique(res_ids, return_inverse=True)
    group_of = np.full(space.n_out, -1, np.int32)
    group_of[:len(sel)] = ginv.astype(np.int32)
    n_groups = int(ginv.max()) + 1 if len(sel) else 0
    return group_of, n_groups, _value_groups(group_of, n_groups)


#: MiB of the link-rate probe's timed copy (gorder_tpu's `size_mb`)
_LINK_PROBE_MIB = 6


#: the link probe's host buffer, made and filled once a process
_LINK_PROBE = {}


def measure_link_mbps(device):
    """The host-to-device copy rate in MiB/s, measured once a run for the
    wire pick (port of `gorder_tpu/engine/wire.py:273-293`): a warm copy
    of 256 KiB, then one timed copy of 6 MiB from page-locked memory, the
    copy a run makes of each batch from its ring (`engine/ring.py`), with
    the device synchronised. None on the CPU, where there is no link."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    buf = _LINK_PROBE.get(device.type)
    if buf is None:
        buf = _LINK_PROBE[device.type] = host_buffer(device,
                                                     _LINK_PROBE_MIB << 20)
        buf[:] = np.random.default_rng(0).integers(0, 255, size=len(buf),
                                                   dtype=np.uint8)
    to_device(buf[:1 << 18], device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    to_device(buf, device)
    torch.cuda.synchronize(device)
    return _LINK_PROBE_MIB / (time.perf_counter() - t0)


#: host decode-and-encode rate of each wire relative to the plain int16
#: decode (gorder_tpu/engine/wire.py:296-300, measured there with
#: tools/decode_bench.py on the AA benchmark system)
_WIRE_HOST_FACTOR = {"b7": 0.80, "s6": 0.55, "d8": 0.75,
                     "i12": 0.90, "i16": 1.00, "f32": 0.85}


def host_i16_rate(traj, frame_indices, space, n_threads):
    """Frames/s of the plain int16 decode over the run's first 16 frames,
    the anchor of the rate pick's host model; None when the input is not
    uniform-precision XTC."""
    anchor = frame_indices[:min(16, len(frame_indices))]
    with timers.phase("pick.host_rate"):
        timers.count("probe_frames", len(anchor))
        t0 = time.perf_counter()
        if traj.read_frames_quantized(anchor, space,
                                      n_threads=n_threads) is None:
            return None
        return len(anchor) / max(time.perf_counter() - t0, 1e-9)


#: frames the xtc wire's host read is timed over: 4 × the int16 anchor's
#: 16. A read call costs ~2 ms whatever its frames on the card's host (the
#: file mapped, the threads started; PERF.md §6), which 16 int16
#: decodes hide but 16 record copies do not
XTC_RATE_FRAMES = 64


def _xtc_rows(window, stride):
    """Rows for the records of the frames `window`, touched beforehand as
    the ring's are → (raw, lengths)."""
    raw = np.empty((len(window), stride), np.uint8)
    raw.fill(0)
    return raw, np.zeros(len(window), np.int32)


def _read_xtc_rows(traj, window, rows, n_threads):
    """Read the records of the frames `window` into `rows` as the ring
    reads them → seconds of the read, or None when they do not fit the
    xtc wire."""
    timers.count("probe_frames", len(window))
    t0 = time.perf_counter()
    if traj.read_frames_xtc(window, *rows, n_threads=n_threads) is None:
        return None
    return time.perf_counter() - t0


def host_xtc_rate(traj, frame_indices, stride, n_threads):
    """Frames/s of the xtc wire's host read (each record copied into a
    ring row) over the run's first `XTC_RATE_FRAMES` frames, the faster of
    two reads into the same rows, so that one slow reading on a shared
    host does not decide the wire; None when they do not fit."""
    window = frame_indices[:min(XTC_RATE_FRAMES, len(frame_indices))]
    with timers.phase("pick.xtc"):
        rows = _xtc_rows(window, stride)
        seconds = []
        for _ in range(2):
            seconds.append(_read_xtc_rows(traj, window, rows, n_threads))
            if seconds[-1] is None:
                return None
        return len(window) / max(min(seconds), 1e-9)


#: the card decoder's frames/s by (device, stride, first_n, n_out, batch
#: size), timed once a process: a layout's rate is the kernel's, which
#: the run's records change little
_CARD_XTC_RATES = {}


def card_xtc_rate(traj, frame_indices, stride, space, n_threads, device,
                  batch_size):
    """Frames/s of the card's XTC decoder (`ops/xtc.py xtc_ints`) on a batch
    of `batch_size` rows tiled from the records of the run's first
    `XTC_RATE_FRAMES` frames: one launch on padding rows loads the kernel,
    then one launch is timed by CUDA events. Once a process for a layout
    (`_CARD_XTC_RATES`); None on the CPU or when the frames do not fit."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    key = (str(device), stride, space.first_n, space.n_out, batch_size)
    if key in _CARD_XTC_RATES:
        return _CARD_XTC_RATES[key]
    window = frame_indices[:min(XTC_RATE_FRAMES, len(frame_indices))]
    with timers.phase("pick.xtc_card"):
        rows = _xtc_rows(window, stride)
        if _read_xtc_rows(traj, window, rows, n_threads) is None:
            return None
        raw, lengths = (to_device(a, device) for a in rows)
        tile = torch.arange(batch_size, device=device) % len(window)
        raw, lengths = raw.index_select(0, tile), lengths.index_select(0, tile)
        slots = to_device(WIRES["xtc"].constants(Source(
            traj, space, n_threads, batch_size)), device)
        status = torch.empty(batch_size, dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            xtc_ints(raw, torch.zeros_like(lengths), slots, space.first_n,
                     space.n_out, status)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            xtc_ints(raw, lengths, slots, space.first_n, space.n_out, status)
            end.record()
            end.synchronize()
        rate = batch_size / max(start.elapsed_time(end) * 1e-3, 1e-9)
    _CARD_XTC_RATES[key] = rate
    return rate


def rate_candidates(src, frame_indices):
    """{wire: (cap, bytes a frame)} of every wire the trajectory fits, as
    the rate pick sizes them (gorder_tpu/engine/wire.py:362-389): int16
    and f32 always, the xtc wire where `src` gives its row stride."""
    candidates = {w: (0, WIRES[w].frame_bytes(src, 0)) for w in ("i16",
                                                                "f32")}
    for name in ("xtc", "b7", "s6", "d8", "i12"):
        cap = WIRES[name].probe(src, frame_indices)
        if cap is not None:
            candidates[name] = (cap, WIRES[name].frame_bytes(src, cap))
    return candidates


def _pick_wire_by_rate(src, frame_indices, link_mbps, device=None):
    """The wire of the highest modeled end-to-end rate, min(host f/s,
    link bytes/s ÷ bytes a frame), the fewer bytes on a tie (port of
    `gorder_tpu/engine/wire.py:329-397`) → (wire, cap), or None for input
    that is not uniform-precision XTC (the bytes policy takes it). A host
    wire's rate is the int16 decode's times its factor; the xtc wire's
    (where `src` gives its stride) is its own read's (`host_xtc_rate`),
    and at most the card decoder's on `device` (`card_xtc_rate`)."""
    traj, space, n_threads = src.traj, src.space, src.n_threads
    host_i16 = host_i16_rate(traj, frame_indices, space, n_threads)
    if host_i16 is None:
        return None
    link = link_mbps * 1024 * 1024
    host = {fmt: host_i16 * f for fmt, f in _WIRE_HOST_FACTOR.items()}
    read = card = None
    if src.stride is not None:
        read = host_xtc_rate(traj, frame_indices, src.stride, n_threads)
        if read is None:
            src = replace(src, stride=None)
        else:
            host["xtc"] = read

    def rate(fmt, bpf):
        return min(host[fmt], link / bpf)

    def best(candidates):
        return max(candidates.items(),
                   key=lambda kv: (rate(kv[0], kv[1][1]), -kv[1][1]))

    # when the link does not bind even for int16, no compact host wire can
    # model faster (their host factors are below 1): skip their probes.
    # The xtc wire's host read may be faster than the int16 decode, so it
    # is weighed against int16 alone then
    i16_bytes = WIRES["i16"].frame_bytes(src, 0)
    link_free = rate("i16", i16_bytes) >= host_i16 * 0.999
    if link_free:
        candidates = {w: (cap, WIRES[w].frame_bytes(src, cap))
                      for w, cap in (("i16", 0), ("xtc", src.stride))
                      if cap is not None}
    else:
        candidates = rate_candidates(src, frame_indices)
    fmt, (cap, bpf) = best(candidates)
    if fmt == "xtc":
        # the card decoder is timed only where the wire would win
        card = card_xtc_rate(traj, frame_indices, src.stride, space,
                             n_threads, device, src.batch_size)
        if card is not None and card < read:
            host["xtc"] = card
            fmt, (cap, bpf) = best(candidates)
    if fmt == "i16" and link_free:
        log.info("wire: i16 (link %.1f MB/s does not bind; host decode "
                 "~%.1f frames/s is the wall)", link_mbps, host_i16)
        return "i16", 0
    log.info("wire: %s (%.1f KB/frame; link %.1f MB/s -> ceiling %.1f "
             "frames/s, modeled host %.1f frames/s%s)", fmt, bpf / 1024,
             link_mbps, link / bpf, host[fmt],
             "" if read is None else f"; xtc read {read:.1f}, card "
             + ("not timed" if card is None else f"{card:.1f}"))
    return fmt, cap


def pick_wire_format(traj, frame_indices, space, n_threads, group_of=None,
                     n_groups=0, batch_size=512, bond_slots=None,
                     link_mbps=None, xtc=False, device=None):
    """The wire a run ships (port of `gorder_tpu/engine/wire.py:399-495`,
    with the xtc wire besides). With a measured `link_mbps` and no
    `GORDER_TPU_WIRE`, the rate pick (`_pick_wire_by_rate`). Otherwise the
    most compact transfer the trajectory fits, or the one
    `GORDER_TPU_WIRE` forces: 7-bit bond-vector differences (`bond_slots`
    given: runs whose only consumer of positions is the order step, or one
    of the channel classes) → 6-bit smoothed-base residuals → 8-bit
    temporal deltas (s6 and d8 compared by bytes a frame) → 12-bit packed
    absolutes → int16 → f32. The xtc wire (the compressed records, decoded
    on the card) is weighed by the rate pick only, or forced, and only
    where `xtc` says the run needs no decoder side channel and its frames
    fit it (`Trajectory.xtc_layout`); the rate pick caps its rate with the
    card decoder's on `device`. → ('b7', esc_cap) / ('s6', esc_cap) /
    ('d8', corr_cap) / ('i12', 0) / ('i16', 0) / ('f32', 0) / ('xtc',
    stride)."""
    layout = traj.xtc_layout(frame_indices) if xtc else None
    src = Source(traj, space, n_threads, batch_size, group_of, n_groups,
                 bond_slots, layout[0] if layout else None)
    forced = os.environ.get("GORDER_TPU_WIRE", "")
    if link_mbps is not None and not forced:
        picked = _pick_wire_by_rate(src, frame_indices, link_mbps, device)
        if picked is not None:
            return picked
    if forced == "xtc":
        if layout is not None:
            return "xtc", layout[0]
        log.warning("GORDER_TPU_WIRE=xtc requested but the run is not "
                    "eligible (non-XTC input, plain frames or another atom "
                    "count, or a decoder side channel); picking a host wire "
                    "instead")
        forced = ""
    b7, s6, d8 = WIRES["b7"], WIRES["s6"], WIRES["d8"]
    if forced in ("", "b7"):
        b7_cap = b7.probe(src, frame_indices)
        # b7 ships ~0.875 B per bond value against s6's ~0.75 B per atom
        # value (its row with no escapes): b7 wins unless bonds outnumber
        # atoms
        if b7_cap is not None and (forced == "b7" or b7.frame_bytes(
                src, b7_cap) < sum(a.nbytes for a in s6.slot(src, 1, 0))):
            return "b7", b7_cap
    if forced == "b7":
        log.warning("GORDER_TPU_WIRE=b7 requested but the run is not "
                    "eligible (non-XTC input, escape overflow, or a "
                    "subsystem needs absolute coordinates); probing the "
                    "coordinate formats instead")
    positions = ("i12", "i16", "f32")      # f32 fits any frames
    if forced in positions:
        positions = positions[positions.index(forced):]
    else:
        esc_cap = (s6.probe(src, frame_indices) if forced in ("", "s6")
                   else None)
        if forced == "s6" and esc_cap is not None:
            return "s6", esc_cap
        d8_cap = (d8.probe(src, frame_indices) if forced in ("", "d8", "s6")
                  else None)
        if esc_cap is not None and (d8_cap is None or s6.frame_bytes(
                src, esc_cap) < d8.frame_bytes(src, d8_cap)):
            return "s6", esc_cap
        if d8_cap is not None:
            return "d8", d8_cap
    return next((w, 0) for w in positions
                if WIRES[w].probe(src, frame_indices) is not None)


def _drop_scatter_index(idx: torch.Tensor, width: int) -> torch.Tensor:
    """int64 indices for a scatter into `width` + 1 columns: those outside
    [0, width) go to the spare column `width`, sliced off after (JAX's
    `mode="drop"`)."""
    return torch.where((idx < 0) | (idx >= width), width, idx).to(
        torch.int64)


def unpack12(p: torch.Tensor, n: int) -> torch.Tensor:
    """i12 wire → (B, n, 3) int16 XTC integers (port of `_unpack12_impl`):
    two two's-complement 12-bit values per 3 bytes, little endian.
    p (B, i12_stride(n)) uint8."""
    b = p.shape[0]
    by = p.reshape(b, -1, 3).to(torch.int32).unbind(-1)
    v0 = by[0] | ((by[1] & 0xF) << 8)
    v1 = (by[1] >> 4) | (by[2] << 4)
    vals = torch.stack([(v0 ^ 0x800) - 0x800, (v1 ^ 0x800) - 0x800],
                       dim=-1).reshape(b, -1)
    return vals[:, :n * 3].reshape(b, n, 3).to(torch.int16)


def d8_ints(lo: torch.Tensor, ci: torch.Tensor, ch: torch.Tensor,
            a0: torch.Tensor) -> torch.Tensor:
    """d8 wire → (B, n, 3) int32 absolute XTC integers (port of
    `_d8_ints_impl`): each value's int8 delta against the frame before,
    plus its sparse high-byte correction (ch << 8 at value index ci; the
    index n·3 marks an unused slot), summed over the batch on top of the
    first frame's integers a0. lo (B, n, 3) int8, ci (B, cap) int32, ch
    (B, cap) int16, a0 (n, 3) int32."""
    b, n, _ = lo.shape
    # torch sums int32 in int64; the integers fit int32 (d8's own range)
    absr = a0.reshape(1, n * 3).to(torch.int32) \
        + torch.cumsum(_d8_deltas(lo, ci, ch), dim=0).to(torch.int32)
    return absr.reshape(b, n, 3)


def _d8_deltas(lo, ci, ch) -> torch.Tensor:
    """(B, n·3) int32 deltas of a d8 wire: each int8 delta plus its sparse
    high-byte correction."""
    b, n, _ = lo.shape
    nv = n * 3
    corr = torch.zeros((b, nv + 1), dtype=torch.int32, device=lo.device)
    corr.scatter_add_(1, _drop_scatter_index(ci, nv),
                      ch.to(torch.int32) << 8)
    return lo.reshape(b, nv).to(torch.int32) + corr[:, :nv]


def d8_last(lo, ci, ch, a0) -> torch.Tensor:
    """The (n, 3) int32 integers of the last frame of a d8 wire, `d8_ints`'
    last row: `a0` plus every delta of the batch. A batch split by frames
    decodes slice i + 1 on top of slice i's last frame."""
    total = _d8_deltas(lo, ci, ch).sum(dim=0).to(torch.int32)
    return (a0.reshape(-1).to(torch.int32) + total).reshape(a0.shape)


def s6_ints(pk: torch.Tensor, gp: torch.Tensor, vl: torch.Tensor,
            bs: torch.Tensor, gm: torch.Tensor,
            vg: torch.Tensor) -> torch.Tensor:
    """s6 wire → (B, n, 3) int32 absolute XTC integers (port of
    `_s6_ints_impl`): 6-bit residual codes, four per 3 bytes little
    endian, sign-extended; the sparse escapes (u16 gaps, int16 values;
    gap 0 is padding) set in; plus each value's group median of the frame
    and the per-batch base. pk (B, s6_stride(n)) uint8; gp (B, cap) u16
    gaps carried in int16 (the bits are widened here: a gap may pass
    32,767); vl (B, cap) int16; bs (n·3,) int32 base; gm (B, (G + 1)·3)
    int16 medians; vg (n·3,) int32 indices into a row of gm."""
    b = pk.shape[0]
    nv = vg.shape[0]
    by = pk.reshape(b, -1, 3).to(torch.int32).unbind(-1)
    u = by[0] | (by[1] << 8) | (by[2] << 16)
    codes = torch.stack([u & 63, (u >> 6) & 63, (u >> 12) & 63,
                         (u >> 18) & 63], dim=-1).reshape(b, -1)
    r = torch.zeros((b, nv + 1), dtype=torch.int32, device=pk.device)
    r[:, :nv] = ((codes[:, :nv] + 32) & 63) - 32          # sign-extend
    gaps = gp.to(torch.int32) & 0xFFFF
    pos = torch.cumsum(gaps, dim=1).to(torch.int32) - 1
    pos = torch.where(gaps == 0, nv, pos)                  # padding
    r.scatter_(1, _drop_scatter_index(pos, nv), vl.to(torch.int32))
    gmv = gm.to(torch.int32).index_select(1, vg.to(torch.int64))
    absr = bs.reshape(1, nv).to(torch.int32) + gmv + r[:, :nv]
    return absr.reshape(b, nv // 3, 3)


def b7_residuals(pk: torch.Tensor, gp: torch.Tensor, vl: torch.Tensor,
                 nv: int) -> torch.Tensor:
    """Unpack the b7 wire's escape-applied residuals (port of
    `_b7_residuals_impl`): 7-bit codes, eight per 7 bytes little-endian,
    sign-extended, then the sparse escape channel scattered in.

    pk (B, stride) uint8; gp (B, cap) escape gaps, u16 values carried in an
    int16 tensor (the bits are reinterpreted here); vl (B, cap) int16
    escape values → (B, nv) int16."""
    b = pk.shape[0]
    by = pk.reshape(b, -1, 7).to(torch.int32).unbind(-1)
    lo = by[0] | (by[1] << 8) | (by[2] << 16)           # bits 0-23
    hi = by[4] | (by[5] << 8) | (by[6] << 16)           # bits 32-55
    codes = torch.stack([
        lo & 127, (lo >> 7) & 127, (lo >> 14) & 127,
        ((lo >> 21) | (by[3] << 3)) & 127,               # bits 21-27
        ((by[3] >> 4) | (hi << 4)) & 127,                # bits 28-34
        (hi >> 3) & 127, (hi >> 10) & 127, (hi >> 17) & 127,
    ], dim=-1).reshape(b, -1)
    codes = ((codes + 64) & 127) - 64                    # sign-extend
    r = torch.zeros((b, nv + 1), dtype=torch.int16, device=pk.device)
    r[:, :nv] = codes[:, :nv]
    gaps = gp.to(torch.int32) & 0xFFFF
    pos = torch.cumsum(gaps, dim=1, dtype=torch.int32) - 1
    pos = torch.where(gaps == 0, nv, pos)                  # padding
    r.scatter_(1, _drop_scatter_index(pos, nv), vl.to(torch.int16))
    return r[:, :nv].contiguous()


def b7(pk, gp, vl, base) -> torch.Tensor:
    """b7 wire → (B, n_bonds, 3) int32 exact bond integer differences
    (port of `_b7_impl`)."""
    nv = base.shape[0]
    r = b7_residuals(pk, gp, vl, nv).to(torch.int32)
    return (base.to(torch.int32)[None, :] + r).reshape(pk.shape[0], nv // 3, 3)


def dequant(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int XTC integers → f32 nm, f32(q)·s, bit-identical to the host
    decode (port of `_dequant_impl`)."""
    return q.to(torch.float32) * s[:, None, None]


def geo_bits(geo: torch.Tensor, n_bonds: int) -> torch.Tensor:
    """(B, ⌈N/8⌉) uint8 geometry bitplane → (B, n_bonds) bool: bit j of
    byte j >> 3 is bond j inside the shape, the layout of the decoder's
    bitplane (native/xdr.cpp xtc_geo_mask; gorder_tpu/engine/fused.py
    geo_bits, which gives the same bits as f32)."""
    shifts = torch.arange(8, dtype=torch.int32, device=geo.device)
    bits = (geo.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(geo.shape[0], -1)[:, :n_bonds].to(torch.bool)


def pack_geo_bits(mask: torch.Tensor) -> torch.Tensor:
    """(B, N) bool inside-shape mask → the (B, ⌈N/8⌉) uint8 bitplane of
    `geo_bits`, so that a mask computed on the device and the decoder's
    reach the P2 kernel in one layout."""
    b, n = mask.shape
    pad = (-n) % 8
    bits = torch.nn.functional.pad(mask.to(torch.int32), (0, pad))
    weights = 1 << torch.arange(8, dtype=torch.int32, device=mask.device)
    return (bits.reshape(b, -1, 8) * weights).sum(-1, dtype=torch.int32) \
        .to(torch.uint8)
