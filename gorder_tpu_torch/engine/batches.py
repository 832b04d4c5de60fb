"""The frame-batch loop: decode → device → kernel → accumulate (port of
`gorder_tpu/engine/batches.py:61-1203`, with leaflets, membrane normals,
ordermaps and geometry).

A decode thread fills a prefetch ring of host buffers (`_decode_ring`;
the native codec releases the GIL) while the main thread copies batch k
to the device and launches its kernels (`_batch_loop`); the outputs are
read back when the run drains (`_drain`). The ring's buffers are lent by
a process-wide pool (`engine/ring.py`), page-locked for a CUDA device, so
that a batch crosses by DMA. The decoder reuses its buffers, so the main
thread copies each batch to the device synchronously before it releases
the ring slot. What is particular to a wire is its entry's
(`engine/wire.py WIRES`): its slots, its read with its padding rows
(masked) and its fallback when a batch no longer fits it mid-run (b7,
s6, d8 and xtc to int16, int16 and i12 to f32, as in the JAX package,
gorder_tpu/engine/batches.py:466-590), and its constants on the device
(s6's value groups, xtc's slot map), copied once a run.

The xtc wire's copies go on a copy stream of each device, which the
step's stream waits for: a copy waits for earlier work on its own
stream, so batch k + 1's records cross while the card decodes batch k.
A frame the card could not decode is named when its batch drains, as
the dynamic normals' guard is checked.

Leaflet runs read the decoder's side channels beside the wire
(`engine/channels.py`): heads and the membrane COG (b7g), the aux atoms
(b7x), sparse assignment-frame coordinates for the host class plane (b7m),
or the COG ring of the coordinate wires. Export runs collect the classes
each batch used, in frame order.

Runs with membrane normals that are not static give the step (B, M, 3)
normals: a manual table's rows for the batch, shipped beside the wire
(padding rows zero), or dynamic normals computed with the step from what
the batch carries (`engine/fused.py`). The dynamic normals' ≥3-points
guard stays on the device and is checked when the batch drains, so no
batch waits on the host for it. Export runs collect the normals each
batch used, in frame order, at drain.

Geometry runs give the step the batch's inside-shape test. A run in the
geometry channel class (`engine/channels.py`) reads the decoder's per-bond
bitplane beside the wire: inline in the b7 decode (b7geo), or by a
standalone pass for coordinate-wire batches (the `*G` kinds). Any other
geometry run gives the step the batch's reference (`geom_ref`): a
selection's atom indices, the fixed point tiled to (B, 3), or the box
center, box·0.5 (gorder_tpu/engine/batches.py:285-298, :359-386,
:465-490, :776-778, :1006-1020). An export of normals restricted to a
geometry marks, per frame, the molecules with no bond midpoint inside as
NaN (`NormalsRuntime.molecule_inside`).

Ordermap runs keep one int64 map state on the device for the whole run
(`core/ordermap.py`): zeroed once, added to by every batch's step, and
copied to the host once, when the run drains. The JAX package fetches and
adds up a per-batch map on the host every batch, because its f32 limb
sums are exact only so far (gorder_tpu/engine/batches.py:183-198).

A caller may pass `on_batch`, which receives each batch's `DeviceBatch`
once its step has been dispatched: the device tensors, classes and
normals the step was given, to inspect or to feed to a kernel again, and
what the step gave back.

Under a frame mesh (`parallel/context.py`) the decode ring still holds
host batches of B frames, and each batch is split at the copy to the
devices: every wire array with a frame axis into N slices of B/N frames,
slice i on device i, while the b7 and s6 wires' per-batch base is copied
whole to each. A d8 slice decodes on top of the last frame of the slice
before it (`engine/wire.py d8_last`), one small copy from device to
device. Each device runs its own step, with its own replica of the run's
constants and its own map state, and `on_batch` receives one
`DeviceBatch` a slice. Classes carried between frames (manual tables,
frequency-gated and spectral classification) are made for the whole
batch on the first device and split like the wire. At drain the slices'
outputs join in frame order, and the map states add up on the host,
exactly in int64 (gorder_tpu/parallel/context.py).

A sharded run (`shard=(i, n)`) analyzes only shard i's contiguous block
of the analyzed frames, its start aligned to the leaflet assignment
frequency so that the shard owns the assignment frames its block uses.
Every per-frame index (assignment frames, manual tables) is the global
analyzed-frame ordinal, so the shards' partial states merge into the
single run's output exactly. A shard that starts after frame 0 first
classifies global frame 0: a `once` assignment is carried from it, and
spectral clustering orients its clusters against it, so that the
cluster→leaflet identities of every shard are shard 0's
(gorder_tpu/engine/batches.py:51-61, :104-150).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import dataclasses
import logging
import os
import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.order import OrderAccumulator
from ..core.ordermap import init_map_state
from ..errors import AnalysisError
from ..io.native import geo_stride
from ..io.traj import Trajectory, check_box_batch
from ..ops.xtc import STATUS
from ..parallel.mesh import gather, replicate, shard_batch, to_device
from ..utils.progress import ProgressPrinter
from ..utils.timers import timers
from .channels import plan_wire
from .fused import BY_KIND, Consumers, decode_positions
from .normals_runtime import check_normal_guard
from .ring import pinned_bytes, ring_slots
from .wire import WIRES, wire_groups

log = logging.getLogger("gorder")


def default_batch_size(device) -> int:
    """Frames a batch: `GORDER_TPU_BATCH_SIZE`, else 512 on the card, whose
    launches and copies it amortizes, and 128 on the CPU, where short
    trajectories would otherwise be mostly padding (gorder_tpu/analysis.py
    :23-32). Results do not depend on it."""
    env = os.environ.get("GORDER_TPU_BATCH_SIZE")
    if env:
        return int(env)
    return 128 if torch.device(device).type == "cpu" else 512


def prefetch_depth(n_batches: int) -> int:
    """Host batches the decoder may run ahead of the copies to the device:
    `GORDER_TPU_PREFETCH` (at least 2, 4 by default), at most the run's
    batches (gorder_tpu/engine/batches.py:227-234)."""
    prefetch = max(2, int(os.environ.get("GORDER_TPU_PREFETCH", "4")))
    return min(prefetch, max(2, n_batches))


@dataclass
class DeviceBatch:
    """One batch as the loop hands it to the run's step."""

    index: int
    kind: str                        # the wire kind (`fused.BY_KIND`)
    wire: tuple                      # the wire's tensors on the device
    scale: Optional[torch.Tensor]    # (B,) f32 for integer wires, else None
    box: torch.Tensor                # (B, 3) f32 box diagonal
    normal: torch.Tensor             # the (3,) or (B, M, 3) f32 normals used
    mask: torch.Tensor               # (B,) bool: False on padding frames
    classes: Optional[torch.Tensor]  # the (B, M) int32 classes the step used
    step: object                     # the OrderStep or UAStep
    out: torch.Tensor                # the step's int64 per-type output
    map_state: Optional[torch.Tensor]  # the run's map state (all batches)
    # a geometry run's reference for the batch: (B, 3), a selection's
    # (K,) slot indices, or None (no geometry)
    geom_ref: Optional[torch.Tensor] = None
    shard: int = 0                   # the frame slice under a mesh
    # the run's `fused.Consumers` on the slice's device: the classifier
    # and the dynamic normals the step's program called
    consumers: Optional[Consumers] = None


def _shard_wire(wire, arrays, mesh):
    """The arrays of one host batch of `wire` (`engine/wire.py WIRES`) on
    the mesh → one tuple of tensors a slice: arrays with a frame axis
    split by frames; the wire's per-batch base copied whole to each
    device, or, where the wire chains it (d8's first-frame integers), to
    the first, and each later slice's the last frame of the slice before
    it. Counts the bytes copied as `transfer_bytes`."""
    base, chain = wire.base, wire.chain
    parts = []
    for j, a in enumerate(arrays):
        if j != base:
            parts.append(shard_batch(mesh, a))
        elif chain:
            parts.append([to_device(a, mesh.devices[0])]
                         + [None] * (mesh.size - 1))
        else:
            parts.append(replicate(mesh, a))
    timers.count("transfer_bytes", sum(
        a.nbytes * (mesh.size if j == base and not chain else 1)
        for j, a in enumerate(arrays)))
    slices = [list(p) for p in zip(*parts)]
    if chain:
        for i in range(1, mesh.size):
            slices[i][base] = chain(*slices[i - 1][:base + 1]).to(
                mesh.devices[i])
    return [tuple(w) for w in slices]


@contextlib.contextmanager
def _on_streams(streams):
    """Enqueue the copies made inside on `streams`, a copy stream of each
    device (None: the current streams), and make each device's current
    stream wait for them after."""
    if streams is None:
        yield
        return
    with contextlib.ExitStack() as stack:
        for stream in streams:
            stack.enter_context(torch.cuda.stream(stream))
        yield
    for stream in streams:
        torch.cuda.current_stream(stream.device).wait_stream(stream)


def _check_decoded(traj, frames, statuses) -> None:
    """Raise naming the first of a batch's valid `frames` whose status the
    card's XTC decoder set (`ops/xtc.py STATUS`)."""
    codes = torch.cat([s.cpu() for s in statuses])[:len(frames)].numpy()
    bad = np.flatnonzero(codes)
    if len(bad):
        frame = int(frames[bad[0]])
        path = traj.files[traj.frame_file[frame]].path
        raise AnalysisError(
            f"could not decode frame {int(traj.frame_local[frame])} of xtc "
            f"file '{path}' on the device: {STATUS[int(codes[bad[0]])]}")


def _shard_block(n_frames: int, shard, align: int):
    """The contiguous block [start, end) of analyzed frames of shard (i,
    n), its start aligned to `align` (the leaflet assignment frequency)."""
    i, n = shard
    base = -(-n_frames // n)                 # ceil
    base = -(-base // max(align, 1)) * max(align, 1)
    start = min(i * base, n_frames)
    end = min(start + base, n_frames)
    return start, end


def _bootstrap_shard(leaflets, traj, frame0, space, n_threads: int, device):
    """Classify global frame 0 for a shard that starts after it: its
    (oriented) assignment becomes the carried state, and its population
    log belongs to shard 0."""
    coords, boxes, _, _ = traj.read_frames(frame0, space,
                                           n_threads=n_threads)
    box = np.ascontiguousarray(boxes[:, [0, 1, 2], [0, 1, 2]])
    assigned = leaflets.classify(to_device(coords, device),
                                 to_device(box, device)).cpu().numpy()[0]
    if leaflets.orienter is not None:
        assigned = leaflets.orienter.orient(assigned)
    leaflets.carried = assigned
    leaflets._logged_stats = True


@contextlib.contextmanager
def _decode_ring(traj, frames, plan, batch_size: int, leaflets,
                 shard_start: int, device):
    """The decode ring: `prefetch` host slots of the run's wire, lent by
    the pool of `device`'s type (`engine/ring.py`), which a decode thread
    fills batch by batch while the main thread copies the batch before to
    the devices → (each batch's future, in order, of (wire, kind, arrays,
    inv_precision, boxes, a b7m batch's sparse read, valid frames), and
    `release`, which lets the thread refill the slot of the batch the
    devices now hold)."""
    src, planned, side = plan.source, WIRES[plan.wire], plan.side
    n_out = src.space.n_out
    n_batches = -(-len(frames) // batch_size)
    prefetch = prefetch_depth(n_batches)

    def make(zeros):
        """One ring slot: the wire's arrays; the decoder's membrane COG (g)
        or geometry bitplane (G) of a coordinate-wire batch in that
        channel class; the sparse assignment-frame coordinates of the
        class plane, (i16, f32)."""
        return (planned.slot(src, batch_size, plan.cap, zeros),
                zeros(batch_size, np.float32) if side == "g"
                else zeros((batch_size, geo_stride(src.n_bonds)), np.uint8)
                if side == "G" else None,
                (zeros((plan.assign_cap, n_out, 3), np.int16),
                 zeros((plan.assign_cap, n_out, 3), np.float32))
                if plan.plane_sparse else None)

    # ring-slot gate: the decoder may refill slot b % prefetch only after
    # the main thread has copied batch b - prefetch to the device
    free = threading.Semaphore(prefetch)

    def side_read(chunk, k):
        """A coordinate-wire batch's side channel, by a standalone pass
        (b7 reads its own inline): the membrane COG the b7g side channel
        ships (native/xdr.cpp xtc_cog_axis), or the geometry bitplane;
        padding rows zeroed."""
        buf = sides[k]
        buf[len(chunk):] = 0
        if side == "g":
            membrane, axis = plan.chan_coords[1]
            traj.read_cog_axis(chunk, src.space, membrane, axis, buf,
                               n_threads=src.n_threads)
        else:
            *args, handle_pbc = src.geo
            traj.read_geo_mask(chunk, src.space, *src.bond_slots, *args, buf,
                               handle_pbc=handle_pbc, n_threads=src.n_threads)
        return buf

    def plane_read(chunk, b):
        """Decode only this batch's assignment frames (1/N of frames for
        `!every N`, one frame for `!once`) → (batch rows, i16 coords and
        scale, or f32 coords and None), or None when no frame assigns."""
        qbuf, fbuf = planes[b % prefetch]
        a0 = shard_start + b * batch_size
        ana = np.arange(a0, a0 + len(chunk), dtype=np.int64)
        rows = np.nonzero(leaflets.assignment_source(ana) == ana)[0]
        if not len(rows):
            return None
        res = traj.read_frames_quantized(chunk[rows], src.space,
                                         n_threads=src.n_threads, out=qbuf)
        if res is not None:
            return rows, qbuf[:len(rows)], res[1].copy()
        traj.read_frames(chunk[rows], src.space, n_threads=src.n_threads,
                         out=fbuf)
        return rows, fbuf[:len(rows)], None

    def decode(b):
        free.acquire()
        with timers.phase("decode"):
            chunk = frames[b * batch_size:(b + 1) * batch_size]
            wire, slot = planned, slots[b % prefetch]
            while (got := wire.read(src, chunk, slot)) is None:
                if wire.changed:
                    log.warning("wire fallback: batch %d exceeds the %s "
                                "format (%s changed mid-run); shipping "
                                "int16", b, wire.name, wire.changed)
                wire = WIRES[wire.fallback]
                slot = wire.slot(src, batch_size, 0)
            arrays, inv_prec, boxes = got
            if wire.sided and sides is not None:
                arrays += (side_read(chunk, b % prefetch),)
            own = wire is planned
            return (wire, plan.kind if own else wire.name + side, arrays,
                    inv_prec, boxes, plane_read(chunk, b) if own and planes
                    else None, len(chunk))

    with ring_slots(device, prefetch, make) as ring:
        slots, sides, planes = (None if col[0] is None else col
                                for col in zip(*ring))
        executor = cf.ThreadPoolExecutor(max_workers=1)
        try:
            yield (collections.deque(executor.submit(decode, b)
                                     for b in range(n_batches)),
                   free.release)
        finally:
            # unblock a decode waiting on a ring slot, and join the worker
            # before the pool takes the buffers back
            for _ in range(prefetch + 1):
                free.release()
            executor.shutdown(wait=True, cancel_futures=True)


def run_batches(analysis, system, steps, normal_vec, n_types: int, space,
                bond_slots, leaflets=None, n_molecules: int = 0, *, mesh,
                batch_size: int, normals=None, map_spec=None,
                geom_spec=None, geom_mode=None, geom_payload=None,
                on_batch=None, shard=None):
    """→ (OrderAccumulator, Trajectory, analyzed frame indices, map, shard
    start): the map is {class: (2, T·n0·n1 + 1) int64 [Σq, count]} of an
    ordermap run (`map_spec`), else None. The frame indices are all the
    run's analyzed frames, also when `shard=(i, n)` restricts the loop to
    shard i's block, which starts at analyzed frame `shard start` (0
    without a shard).

    A geometry run gives its `geom_spec` with `geom_mode` "point" (the
    (3,) `geom_payload`), "center", or "selection" (`geom_payload` the
    selection's slot indices): `engine/prepare.py _prepare_geometry`.

    `bond_slots` (atom_a, atom_b) makes the b7 wire eligible; UA steps pass
    None and ride int16 or f32 positions, as ordermap runs do. `leaflets`
    is the run's LeafletRuntime and `normals` its NormalsRuntime, or None;
    with `normals`, `normal_vec` is unused. `on_batch`, if given, is called
    with each slice's DeviceBatch after its step is dispatched.

    `mesh` is the run's `parallel.mesh.FrameMesh` (of one device without
    data parallelism) and `steps` the step of each of its devices; the
    batch size is a multiple of the mesh's size. Host work (the leaflet
    runtime's carried state, the bootstrap of a shard) runs on the first
    device."""
    device = mesh.devices[0]
    accum = OrderAccumulator(
        n_types, ("total", "upper", "lower") if leaflets else ("total",),
        keep_timewise=analysis.estimate_error is not None)
    with timers.phase("prepare"), timers.phase("open"):
        traj = Trajectory(analysis.trajectory,
                          expected_atoms=system.n_atoms)
        frame_indices = traj.select_frames(
            analysis.begin if np.isfinite(analysis.begin) else None,
            analysis.end if np.isfinite(analysis.end) else None,
            analysis.step,
        )
    if len(frame_indices) == 0:
        raise AnalysisError(
            "no trajectory frames are within the specified time range")
    if leaflets is not None:
        leaflets.validate(len(frame_indices))
    if normals is not None:
        normals.validate(len(frame_indices))

    n_threads = max(1, analysis.n_threads)
    full_frame_indices = frame_indices
    shard_start = 0
    if shard is not None:
        align = 1
        if (leaflets is not None and leaflets.classify is not None
                and leaflets.frequency.kind == "every"):
            align = leaflets.frequency.n
        shard_start, shard_end = _shard_block(len(frame_indices), shard,
                                              align)
        frame_indices = frame_indices[shard_start:shard_end]
        log.info("shard %d/%d: frames %d..%d of %d", shard[0], shard[1],
                 shard_start, shard_end, len(full_frame_indices))
        if len(frame_indices) == 0:
            empty_map = None
            if map_spec is not None:
                n_seg = n_types * map_spec.ncells + 1
                empty_map = {cls: np.zeros((2, n_seg), np.int64)
                             for cls in accum.classes}
            return accum, traj, full_frame_indices, empty_map, shard_start
        if (shard_start > 0 and leaflets is not None
                and leaflets.classify is not None):
            _bootstrap_shard(leaflets, traj, full_frame_indices[:1], space,
                             n_threads, device)

    with timers.phase("pick"):
        group_of, n_groups, _ = wire_groups(system, space)
        plan = plan_wire(traj=traj, frame_indices=frame_indices,
                         space=space, bond_slots=bond_slots,
                         leaflets=leaflets, normals=normals,
                         map_spec=map_spec,
                         geometry=(None if geom_mode is None else
                                   (geom_spec, geom_mode, geom_payload)),
                         handle_pbc=analysis.handle_pbc, n_threads=n_threads,
                         batch_size=batch_size, group_of=group_of,
                         n_groups=n_groups, device=device)
    consumers = Consumers(
        coords=leaflets.fused_classify() if leaflets is not None else None,
        channel_coords=plan.chan_coords[0] if plan.chan_coords else None,
        channel=plan.channel_classify, aux=plan.aux_classify,
        normals=normals.fused() if normals is not None else None,
        aux_normals=plan.aux_normals, n_atoms=space.n_out)
    # each device's consumers, with its own map state
    consumers = [dataclasses.replace(consumers, map_state=(
        init_map_state(len(accum.classes), n_types, map_spec, d)
        if map_spec is not None else None)) for d in mesh.devices]

    with _decode_ring(traj, frame_indices, plan, batch_size, leaflets,
                      shard_start, device) as ring:
        outputs = _batch_loop(
            *ring, plan=plan, analysis=analysis, mesh=mesh, steps=steps,
            consumers=consumers, leaflets=leaflets, normals=normals,
            normal_vec=normal_vec, geom_mode=geom_mode,
            geom_payload=geom_payload, on_batch=on_batch,
            batch_size=batch_size, shard_start=shard_start,
            n_frames=len(frame_indices), n_molecules=n_molecules)
    with timers.phase("drain"):
        map_host = _drain(traj, frame_indices, outputs, accum, consumers,
                          leaflets, normals, batch_size)
    log.info("analyzed %d frames", accum.n_frames)
    return accum, traj, full_frame_indices, map_host, shard_start


def _batch_loop(futures, release, *, plan, analysis, mesh, steps,
                consumers, leaflets, normals, normal_vec, geom_mode,
                geom_payload, on_batch, batch_size: int, shard_start: int,
                n_frames: int, n_molecules: int):
    """The batch loop: each batch of the decode ring (`futures`) copied to
    the devices, its slot `release`d, its host classes and manual normals
    made, its step dispatched on every device and `on_batch` called → for
    the drain, each batch's (valid frames, its slices' `Used`, the insides
    of an export of normals restricted to a geometry, the xtc wire's
    statuses, its index)."""
    wire, src = WIRES[plan.wire], plan.source
    n_dev, device, n_out = mesh.size, mesh.devices[0], src.space.n_out
    # host classes (manual tables, frequency-gated methods) come from
    # classes_for_batch; every-frame methods classify with the step
    host_classes = leaflets is not None and leaflets.fused_classify() is None
    manual_normals = normals is not None and normals.fused() is None
    collect = leaflets is not None and leaflets.collect_frames is not None
    collect_normals = normals is not None and normals.collected is not None
    molecule_inside = (normals.molecule_inside if collect_normals
                       else None)
    # the wire's run constants on each device (s6's value groups, the xtc
    # wire's slot map), and a copy stream of each device where its copies
    # go on one and they are cards
    const = wire.constants(src)
    consts = (replicate(mesh, const) if const is not None
              else [None] * n_dev)
    copy_streams = ([torch.cuda.Stream(d) for d in mesh.devices]
                    if wire.copy_stream and device.type == "cuda" else None)
    normal_devs = replicate(mesh, np.asarray(normal_vec, np.float32))
    # the geometry's reference on each device, for the steps that compute
    # the inside mask themselves (not the geometry channel class): a
    # selection's slot indices, or the fixed point tiled to (B/N, 3); the
    # box center is taken per batch
    device_geom = None if plan.geo_channel else geom_mode
    geom_consts = [None] * n_dev
    if device_geom == "selection":
        geom_consts = replicate(mesh, np.asarray(geom_payload, np.int32))
    elif device_geom == "point":
        geom_consts = replicate(mesh, np.tile(np.asarray(
            geom_payload, np.float32), (batch_size // n_dev, 1)))
    progress = ProgressPrinter(n_frames) if not analysis.silent else None
    outputs = []
    try:
        for b in range(len(futures)):
            with timers.phase("wait"):
                (batch_wire, kind, arrays, inv_prec, boxes, extra,
                 n_valid) = futures.popleft().result()
            if analysis.handle_pbc:
                check_box_batch(boxes[:n_valid])
            box = np.ones((batch_size, 3), np.float32)
            box[:n_valid] = boxes[:n_valid, [0, 1, 2], [0, 1, 2]]
            mask = np.zeros(batch_size, bool)
            mask[:n_valid] = True
            scale = None
            if inv_prec is not None:
                scale = np.ones(batch_size, np.float32)
                scale[:n_valid] = inv_prec
                scale[n_valid:] = inv_prec[n_valid - 1]
            streams = copy_streams if batch_wire.copy_stream else None
            with timers.phase("transfer"):
                with _on_streams(streams):
                    wires = _shard_wire(batch_wire, arrays, mesh)
                    boxes_dev, masks_dev = shard_batch(mesh, box, mask)
                    scales_dev = (shard_batch(mesh, scale)
                                  if scale is not None else [None] * n_dev)
                if streams is not None:
                    # made on the copy streams, read on the current ones
                    for t in [*wires, boxes_dev, masks_dev, scales_dev]:
                        for x in (t if isinstance(t, (list, tuple)) else (t,)):
                            if x is not None:
                                x.record_stream(
                                    torch.cuda.current_stream(x.device))
                statuses = None
                if batch_wire.status:
                    statuses = [torch.empty(batch_size // n_dev,
                                            dtype=torch.int32, device=d)
                                for d in mesh.devices]
                wires = [batch_wire.attach(w, c, statuses and statuses[i])
                         for i, (w, c) in enumerate(zip(wires, consts))]
                shipped = [box, mask, scale]
                sparse = None
                if extra is not None:
                    rows, coords, sc = extra
                    sparse = (rows, to_device(coords, device),
                              to_device(sc, device) if sc is not None
                              else None)
                    shipped += [coords, sc]
                timers.count("transfer_bytes", sum(
                    a.nbytes for a in shipped if a is not None))
                # of the bytes counted, those the ring's pinned buffers held
                timers.count("pinned_transfer_bytes", pinned_bytes(
                    [*arrays, *shipped]) if device.type == "cuda" else 0)
            # the devices hold copies now: the decoder may reuse the slot
            release()
            classes = [None] * n_dev
            if host_classes:
                with timers.phase("classify"):
                    classes = shard_batch(mesh, _host_classes(
                        leaflets, kind, wires, scales_dev, boxes_dev,
                        sparse, shard_start + b * batch_size, n_valid,
                        batch_size, n_molecules, n_out))
            normal = normal_devs
            if manual_normals:
                with timers.phase("transfer"):
                    table = normals.manual_for_batch(
                        shard_start + b * batch_size, n_valid, batch_size)
                    normal = shard_batch(mesh, table)
                    timers.count("transfer_bytes", table.nbytes)
            geom_refs = ([bx * 0.5 for bx in boxes_dev]
                         if device_geom == "center" else geom_consts)
            useds, insides = [], []
            if statuses is not None:
                timers.count("device_decode_frames", n_valid)
            with timers.phase("dispatch"):
                for i in range(n_dev):
                    useds.append(BY_KIND[kind](
                        steps[i], wires[i], scales_dev[i], boxes_dev[i],
                        normal[i], masks_dev[i], consumers[i], classes[i],
                        geom_ref=geom_refs[i]))
                    if molecule_inside is not None:
                        coords_f = decode_positions(kind, wires[i], n_out)
                        if scales_dev[i] is not None:
                            coords_f = (coords_f.to(torch.float32)
                                        * scales_dev[i][:, None, None])
                        insides.append(molecule_inside(
                            coords_f, boxes_dev[i], geom_refs[i]))
            if useds[0].classes is not None and not host_classes and b == 0:
                leaflets.log_first_stats(useds[0].classes[0].cpu().numpy())
            if on_batch is not None:
                for i, used in enumerate(useds):
                    on_batch(DeviceBatch(
                        b, kind, wires[i], scales_dev[i], boxes_dev[i],
                        used.normal, masks_dev[i], used.classes, steps[i],
                        used.out, consumers[i].map_state, geom_refs[i],
                        shard=i, consumers=consumers[i]))
            outputs.append((n_valid, [used._replace(
                classes=used.classes if collect and not host_classes
                else None,
                normal=used.normal if collect_normals else None)
                for used in useds], insides or None, statuses, b))
            if progress is not None:
                progress.update(min((b + 1) * batch_size, n_frames))
    finally:
        if progress is not None:
            progress.finish()
    return outputs


def _drain(traj, frames, outputs, accum, consumers, leaflets, normals,
           batch_size: int):
    """The drain: each batch's xtc statuses and dynamic normals' guard
    checked, its slices' outputs added to `accum` in frame order, the
    classes and normals its step used collected → an ordermap run's
    {class: map}, its devices' map states added up, else None."""
    for n_valid, useds, insides, statuses, b in outputs:
        if statuses is not None:
            _check_decoded(traj, frames[b * batch_size:
                                        b * batch_size + n_valid], statuses)
        for used in useds:
            if used.guard is not None:
                check_normal_guard(used.guard)
        # the slices' outputs, classes and normals in frame order
        out = np.concatenate([u.out.cpu().numpy() for u in useds])
        accum.add_step(out[:n_valid], n_valid)
        # the classes and normals this batch's step consumed, in frame
        # order; restricted to a geometry, NaN for a molecule with no
        # bond inside (gorder_tpu/engine/normals_runtime.py:50-57)
        if useds[0].classes is not None:
            classes = gather([u.classes for u in useds])
            leaflets.collect_frames.extend(
                classes[:n_valid].cpu().numpy().astype(np.int32))
        if useds[0].normal is not None:
            values = gather([u.normal for u in useds])[:n_valid]
            values = values.cpu().numpy()
            if insides is not None:
                inside = gather(insides)[:n_valid].cpu().numpy()
                values = values.copy()
                values[~inside] = np.nan
            normals.collected.append(values)
    if consumers[0].map_state is None:
        return None
    # exact in int64, in any order
    total = sum(c.map_state.cpu().numpy() for c in consumers)
    return dict(zip(accum.classes, total))


def _host_classes(leaflets, kind, wires, scales, boxes, sparse, start: int,
                  n_valid: int, batch_size: int, n_molecules: int,
                  n_atoms: int) -> np.ndarray:
    """The batch's (B, M) int32 host classes: manual table rows, or
    frequency-gated classification of its assignment frames (the sparse
    read of a b7m batch, or the full coordinates of a coordinate-wire
    batch, its slices joined on the first device), carried between them.
    Padding rows are 0 and masked."""
    analyzed = np.arange(start, start + n_valid, dtype=np.int64)
    coords = rows = None
    box = gather(boxes)
    if kind == "b7m":
        if sparse is not None:
            rows, q, sc = sparse
            coords = (q.to(torch.float32) * sc[:, None, None]
                      if sc is not None else q)
    elif leaflets.manual_table is None:
        # the valid frames only: padding frames are never classified
        coords = gather([decode_positions(kind, w, n_atoms)
                         for w in wires])[:n_valid]
        if scales[0] is not None:
            coords = (coords.to(torch.float32)
                      * gather(scales)[:n_valid, None, None])
    classes = leaflets.classes_for_batch(coords, box[:n_valid], analyzed,
                                         rows=rows)
    full = np.zeros((batch_size, n_molecules), np.int32)
    full[:n_valid] = classes
    return full
