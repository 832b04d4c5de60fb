"""Phase timers.

Lightweight wall-clock phase timers, logged after every run: each
`gorder_tpu_torch.run` accumulates per-phase wall times (structure,
topology, trajectory, decode, wait, transfer, dispatch, drain, convert)
and logs one summary line at INFO level.

Timers are monotonic (`time.perf_counter`) and additive: entering the same
phase several times accumulates. Decode time is recorded from the prefetch
worker thread; a lock keeps the counters consistent.

`profiled_run` wraps one run: it resets the timers, times the run as
"total" and, when `GORDER_TPU_PROFILE` names a directory, traces the run
with `torch.profiler` (host and CUDA activity) into a Chrome trace there
(port of `gorder_tpu/utils/timers.py:75-118`, a `jax.profiler` trace).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional


class PhaseTimers:
    """Accumulating wall-clock phase timers (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._times: Dict[str, float] = {}
        self._order: list = []

    def reset(self) -> None:
        with self._lock:
            self._times.clear()
            self._order.clear()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            if name not in self._times:
                self._times[name] = 0.0
                self._order.append(name)
            self._times[name] += seconds

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - start)

    def get(self, name: str) -> float:
        with self._lock:
            return self._times.get(name, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {k: self._times[k] for k in self._order}

    def summary(self) -> str:
        snap = self.snapshot()
        if not snap:
            return "no phases recorded"
        return " | ".join(f"{k} {v:.3f}s" for k, v in snap.items())


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
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()

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
        with timers.phase("total"):
            yield timers
    finally:
        prof.stop()
