"""The frame-batch loop: decode → device → kernel → accumulate (port of the
main-path subset of `gorder_tpu/engine/batches.py:61-1203`).

A decode thread fills a prefetch ring of host buffers (the native codec
releases the GIL) while the main thread copies batch k to the device and
launches its kernels. The decoder reuses its buffers, so the main thread
copies each batch to the device synchronously (pageable `copy_`) before
it releases the ring slot. Padding frames of the last batch are masked. A
batch that no longer fits the b7 wire mid-run falls back to int16, and a
batch that no longer fits int16 to f32, as in the JAX package.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import logging
import threading
import time

import numpy as np
import torch

from .._ref.errors import AnalysisError
from .._ref.io.native import b7_stride
from .._ref.io.traj import Trajectory, check_box_batch
from .._ref.utils.progress import ProgressPrinter
from .._ref.utils.timers import timers
from ..core.order import OrderAccumulator
from .channels import plan_wire
from .fused import BY_KIND

log = logging.getLogger("gorder")

#: frames per device batch: the JAX package's accelerator default
#: (gorder_tpu/analysis.py:32); results do not depend on it
DEFAULT_BATCH_SIZE = 512
_PREFETCH = 4


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A copy of the host array on `device` that no longer reads `a`."""
    return torch.from_numpy(a).to(device, copy=True)


def run_batches(analysis, system, step, normal_vec, n_types: int, space,
                bond_slots, *, device, batch_size: int = DEFAULT_BATCH_SIZE):
    """→ (OrderAccumulator, Trajectory, analyzed frame indices).

    `bond_slots` (atom_a, atom_b) makes the b7 wire eligible; UA steps pass
    None and ride int16 or f32 positions."""
    device = torch.device(device)
    accum = OrderAccumulator(
        n_types, ("total",),
        keep_timewise=analysis.estimate_error is not None)
    traj = Trajectory(analysis.trajectory, expected_atoms=system.n_atoms)
    frame_indices = traj.select_frames(
        analysis.begin if np.isfinite(analysis.begin) else None,
        analysis.end if np.isfinite(analysis.end) else None,
        analysis.step,
    )
    if len(frame_indices) == 0:
        raise AnalysisError(
            "no trajectory frames are within the specified time range")

    n_threads = max(1, analysis.n_threads)
    plan = plan_wire(traj=traj, frame_indices=frame_indices, space=space,
                     bond_slots=bond_slots, n_threads=n_threads,
                     batch_size=batch_size)
    n_out = space.n_out
    n_batches = (len(frame_indices) + batch_size - 1) // batch_size
    prefetch = min(_PREFETCH, max(2, n_batches))
    if plan.wire == "b7":
        buffers = [(np.zeros((batch_size, b7_stride(plan.n_bonds)), np.uint8),
                    np.zeros((batch_size, plan.esc_cap), np.uint16),
                    np.zeros((batch_size, plan.esc_cap), np.int16))
                   for _ in range(prefetch)]
    else:
        dtype = np.int16 if plan.wire == "i16" else np.float32
        buffers = [np.zeros((batch_size, n_out, 3), dtype)
                   for _ in range(prefetch)]

    # ring-slot gate: the decoder may refill slot b % prefetch only after
    # the main thread has copied batch b - prefetch to the device
    slots = threading.Semaphore(prefetch)

    def decode_f32(chunk, buf):
        _, boxes, _, _ = traj.read_frames(chunk, space, n_threads=n_threads,
                                          out=buf)
        buf[len(chunk):] = 0
        return ("f32", (buf,)), None, boxes

    def decode_i16(chunk, buf):
        res = traj.read_frames_quantized(chunk, space, n_threads=n_threads,
                                         out=buf)
        if res is None:
            return decode_f32(chunk, np.zeros((batch_size, n_out, 3),
                                              np.float32))
        _, inv_prec, boxes, _, _ = res
        buf[len(chunk):] = 0
        return ("i16", (buf,)), inv_prec, boxes

    def decode_b7(b, chunk, buf):
        pk, eg, ev = buf
        if len(chunk) < batch_size:
            # padding rows decode to the (masked) base differences
            pk[len(chunk):] = 0
            eg[len(chunk):] = 0
            ev[len(chunk):] = 0
        res, _ = traj.read_frames_b7(chunk, space, bond_slots[0],
                                     bond_slots[1], pk, eg, ev,
                                     n_threads=n_threads)
        if res is not None:
            base, inv_prec, boxes, _, _ = res
            return ("b7", (pk, eg.view(np.int16), ev, base)), inv_prec, boxes
        log.warning("wire fallback: batch %d exceeds the b7 format (escape "
                    "demand or value range changed mid-run); shipping int16",
                    b)
        return decode_i16(chunk, np.zeros((batch_size, n_out, 3), np.int16))

    def decode_batch(b):
        slots.acquire()
        t0 = time.perf_counter()
        try:
            chunk = frame_indices[b * batch_size:(b + 1) * batch_size]
            buf = buffers[b % prefetch]
            if plan.wire == "b7":
                out = decode_b7(b, chunk, buf)
            elif plan.wire == "i16":
                out = decode_i16(chunk, buf)
            else:
                out = decode_f32(chunk, buf)
            return out + (len(chunk),)
        finally:
            timers.add("decode", time.perf_counter() - t0)

    normal_dev = torch.as_tensor(np.asarray(normal_vec, np.float32),
                                 device=device)
    executor = cf.ThreadPoolExecutor(max_workers=1)
    progress = ProgressPrinter(len(frame_indices)) \
        if not analysis.silent else None
    outputs = []
    try:
        futures = collections.deque(
            executor.submit(decode_batch, b) for b in range(n_batches))
        for b in range(n_batches):
            with timers.phase("wait"):
                (kind, arrays), inv_prec, boxes, n_valid = \
                    futures.popleft().result()
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
            with timers.phase("transfer"):
                wire = tuple(_to_device(a, device) for a in arrays)
                box_dev = _to_device(box, device)
                mask_dev = _to_device(mask, device)
                scale_dev = (_to_device(scale, device)
                             if scale is not None else None)
            # the device holds copies now: the decoder may reuse the slot
            slots.release()
            with timers.phase("dispatch"):
                out = BY_KIND[kind](step, wire, scale_dev, box_dev,
                                    normal_dev, mask_dev)
            outputs.append((out, n_valid))
            if progress is not None:
                progress.update(min((b + 1) * batch_size,
                                    len(frame_indices)))
    finally:
        # unblock a decode waiting on a ring slot before joining the worker
        for _ in range(prefetch + 1):
            slots.release()
        executor.shutdown(wait=True, cancel_futures=True)
        if progress is not None:
            progress.finish()

    with timers.phase("drain"):
        for out, n_valid in outputs:
            accum.add_batch({"total": out[:n_valid].cpu().numpy()}, n_valid)
    log.info("analyzed %d frames", accum.n_frames)
    return accum, traj, frame_indices
