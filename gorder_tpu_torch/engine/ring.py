"""The decode ring's host memory: a process-wide pool of buffers, lent a
set to one run at a time (`RING_POOL`, `ring_slots`).

For a CUDA device the buffers are page-locked (pinned), so each batch's
copy to the card is one DMA at the link's rate: from pageable memory the
CUDA driver first copies the batch into its own staging buffer on the
CPU, and that copy, not the link, paced the xtc wire. Pinning is slow (the
pages are locked one by one), so a set is allocated once a process and
lent again to every later run that fits in it. On the CPU the buffers
are plain numpy, lent by the same rules.

A set is one buffer a ring slot. Each wire's `slot` (`engine/wire.py
WIRES`) still states a slot's arrays: it is called with an `np.zeros`
stand-in that lays each array it asks for after the last in the slot's
buffer (`_Carve`). A buffer is zeroed once, when it is allocated; a set
lent again holds what the last run left, and each entry's `pad` and
`read` set every byte a step reads (`tests/test_torch_ring.py` runs every
wire on buffers filled with 0xFF).

The pool keeps one set a device type. A run that needs larger slots or
more of them gets a new set, and the smaller one is freed. A run that
overlaps another (two threads of one process) finds the set lent and gets
one of its own; when both have ended the pool keeps the larger. Where
pinning fails the ring falls back to pageable numpy, with one warning a
process.

Counters (`utils/timers.py`): `ring_allocations`, the buffers allocated
for a run (0 when it was lent an existing set).
"""

from __future__ import annotations

import contextlib
import logging
import threading

import numpy as np
import torch

from ..utils.timers import timers

log = logging.getLogger("gorder")

#: bytes each array of a slot is aligned to in its buffer
ALIGN = 64

_pin_warned = False


def _pinned_zeros(nbytes: int) -> np.ndarray:
    return torch.zeros(nbytes, dtype=torch.uint8, pin_memory=True).numpy()


def host_buffer(device, nbytes: int) -> np.ndarray:
    """`nbytes` of zeroed host memory as a uint8 array: page-locked where
    `device` is a CUDA device, else (or where pinning fails, warned once a
    process) pageable numpy."""
    global _pin_warned
    if torch.device(device).type == "cuda":
        try:
            return _pinned_zeros(nbytes)
        except RuntimeError as e:
            if not _pin_warned:
                _pin_warned = True
                log.warning("cannot pin %d bytes of host memory (%s); the "
                            "decode ring copies from pageable memory",
                            nbytes, e)
    return np.zeros(nbytes, np.uint8)


class _Carve:
    """An `np.zeros` stand-in that lays each array it is asked for after
    the last one in `buf`, `ALIGN`ed; without a buffer it only sizes them
    (`size`, the bytes they take), giving arrays that hold no memory."""

    def __init__(self, buf=None):
        self.buf, self.size = buf, 0

    def __call__(self, shape, dtype):
        dtype = np.dtype(dtype)
        start = -(-self.size // ALIGN) * ALIGN
        n = int(np.prod(shape)) * dtype.itemsize
        self.size = start + n
        if self.buf is None:
            return np.broadcast_to(np.zeros((), dtype), shape)
        return self.buf[start:start + n].view(dtype).reshape(shape)


class RingPool:
    """One set of ring buffers a device type, lent to one run at a time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sets = {}              # device type -> the idle set

    @contextlib.contextmanager
    def lend(self, device, n: int, nbytes: int):
        """`n` buffers of at least `nbytes` each, for `device`'s ring, until
        the block ends: the idle set where it is large enough, else a new
        one of the larger of each dimension."""
        kind = torch.device(device).type
        with self._lock:
            bufs = self._sets.pop(kind, None)
        if bufs is not None and len(bufs) >= n and len(bufs[0]) >= nbytes:
            timers.count("ring_allocations", 0)
        else:
            if bufs is not None:     # grown: the smaller set freed first
                n, nbytes = max(n, len(bufs)), max(nbytes, len(bufs[0]))
                del bufs
            bufs = [host_buffer(device, nbytes) for _ in range(n)]
            timers.count("ring_allocations", n)
        try:
            yield bufs
        finally:
            with self._lock:
                idle = self._sets.get(kind)
                if idle is None or (len(idle) * len(idle[0])
                                    < len(bufs) * len(bufs[0])):
                    self._sets[kind] = bufs


#: the process's pool
RING_POOL = RingPool()


@contextlib.contextmanager
def ring_slots(device, n: int, make):
    """`n` ring slots for `device`, each what `make(zeros)` returns with its
    arrays laid in a buffer that `RING_POOL` lends, until the block ends."""
    sizing = _Carve()
    make(sizing)
    with RING_POOL.lend(device, n, max(sizing.size, 1)) as bufs:
        yield [make(_Carve(buf)) for buf in bufs[:n]]


def pinned_bytes(arrays) -> int:
    """The bytes of the host `arrays` (None skipped) that lie in
    page-locked memory."""
    return sum(a.nbytes for a in arrays
               if a is not None and torch.from_numpy(a).is_pinned())
