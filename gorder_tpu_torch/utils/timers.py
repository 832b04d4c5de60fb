"""Phase timers and counters: the port's spans.

Lightweight wall-clock phase timers, logged after every run: each
`gorder_tpu_torch.run` accumulates per-phase wall times and logs one
summary line at INFO level, its counters last. The phases, in the layer
that does the work (a phase may nest in another; each keeps its own sum):

- `engine/drivers.py`: `prepare` (everything before the batch loop:
  `structure`, `topology`, `atom_space`, `runtimes`, `steps`), then
  `trajectory` (the loop) and `convert`;
- `engine/batches.py`: `open` (the trajectory opened and its frames
  selected, counted into `prepare` too), `pick` (the wire pick), `decode`
  (on the decode thread), `wait`, `transfer`, `classify`, `dispatch`,
  `drain`;
- `engine/wire.py`, under `pick`: `pick.link`, `pick.host_rate` and one
  phase a probe, `pick.b7`, `pick.s6`, `pick.d8`, `pick.i12`, `pick.i16`,
  and `pick.xtc` (the xtc wire's host read over the anchor frames);
- `engine/fused.py`: `normals` (dynamic normals) and `classify` (the
  leaflet classifiers a batch's program calls).

The counters: `transfer_bytes`, the bytes of the host arrays the batch
loop copies to the devices; `probe_frames`, the frames the pick's
probes decode (a retried probe counts again); and `slow_parse_lines`,
the GRO atom lines and bonds-file lines that `io/gro.py` and
`io/bnd.py` parsed one at a time because their whole-array pass refused
the file (0 for a file the pass took); and `device_decode_frames`, the
frames of xtc-wire batches, which the device decoded from their records
(`ops/xtc.py`) and the host only copied (under the xtc wire the `decode`
phase times that copy); `pinned_transfer_bytes`, of the `transfer_bytes`
on a CUDA device those that crossed from the decode ring's page-locked
buffers (`engine/ring.py`); and `ring_allocations`, the ring buffers the
pool allocated for the run (0 when it lent a set it held).

Timers are monotonic (`time.perf_counter`) and additive: entering the same
phase several times accumulates. Decode time is recorded from the prefetch
worker thread; a lock keeps the sums consistent.

Under `traced()` every phase is also a `torch.profiler.record_function`
span named `gorder.<phase>`, so a profiler trace holds the phases on the
device trace's clock, nested as they nest, each on its thread. Off, a
phase costs one check more than its clock reads.

`profiled_run` wraps one run: it resets the timers, times the run as
"total" and, when `GORDER_TPU_PROFILE` names a directory, traces the run
with `torch.profiler` (host and CUDA activity, the phases' spans) into a
Chrome trace there (port of `gorder_tpu/utils/timers.py:75-118`, a
`jax.profiler` trace).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

#: the prefix of the phases' profiler spans
SPAN_PREFIX = "gorder."


class PhaseTimers:
    """Accumulating wall-clock phase timers and counters (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._times: Dict[str, float] = {}
        self._order: list = []
        self._counts: Dict[str, int] = {}
        self._traced = False

    def reset(self) -> None:
        with self._lock:
            self._times.clear()
            self._order.clear()
            self._counts.clear()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            if name not in self._times:
                self._times[name] = 0.0
                self._order.append(name)
            self._times[name] += seconds

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    @contextmanager
    def traced(self):
        """Make every phase entered meanwhile, on any thread, a profiler
        span too."""
        was, self._traced = self._traced, True
        try:
            yield self
        finally:
            self._traced = was

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            if self._traced:
                import torch

                with torch.profiler.record_function(SPAN_PREFIX + name):
                    yield
            else:
                yield
        finally:
            self.add(name, time.perf_counter() - start)

    def get(self, name: str) -> float:
        with self._lock:
            return self._times.get(name, 0.0)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def snapshot(self) -> Dict[str, float]:
        """Every phase's seconds, then every counter's total, by name (a
        counter's name ends in its unit, so never a phase's)."""
        with self._lock:
            return {**{k: self._times[k] for k in self._order},
                    **self._counts}

    def summary(self) -> str:
        with self._lock:
            parts = [f"{k} {self._times[k]:.3f}s" for k in self._order]
            parts += [f"{k} {v}" for k, v in self._counts.items()]
        return " | ".join(parts) if parts else "no phases recorded"


#: process-wide registry used by the analysis pipeline
timers = PhaseTimers()


class _Profiler:
    """Opt-in torch.profiler trace around a run (GORDER_TPU_PROFILE=dir)."""

    def __init__(self) -> None:
        self.dir: Optional[str] = os.environ.get("GORDER_TPU_PROFILE") or None
        self._prof = None

    def start(self) -> None:
        if not self.dir:
            return
        import torch

        try:
            os.makedirs(self.dir, exist_ok=True)
        except OSError as e:
            logging.getLogger("gorder").warning(
                "cannot write profiler trace to '%s' (%s); profiling "
                "disabled for this run", self.dir, e)
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # every thread's host events: the decode thread's spans too
        self._prof = torch.profiler.profile(
            activities=activities,
            experimental_config=torch.profiler._ExperimentalConfig(
                profile_all_threads=True))
        self._prof.start()

    def spans(self):
        """The phases' spans while this profiler traces, else nothing."""
        return (timers.traced() if self._prof is not None
                else contextlib.nullcontext())

    def stop(self) -> None:
        if self._prof is None:
            return
        self._prof.stop()
        path = os.path.join(self.dir, f"trace-{os.getpid()}-"
                            f"{time.time_ns()}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        logging.getLogger("gorder").info("profiler trace written to %s",
                                         path)


@contextmanager
def profiled_run():
    """Reset timers and (optionally) trace the device for one analysis run."""
    timers.reset()
    prof = _Profiler()
    prof.start()
    try:
        with prof.spans(), timers.phase("total"):
            yield timers
    finally:
        prof.stop()
