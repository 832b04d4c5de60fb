"""Phase timers.

Lightweight wall-clock phase timers, logged after every run: each
`gorder_tpu_torch.run` accumulates per-phase wall times (structure,
topology, trajectory, decode, wait, transfer, dispatch, drain, convert)
and logs one summary line at INFO level.

Timers are monotonic (`time.perf_counter`) and additive: entering the same
phase several times accumulates. Decode time is recorded from the prefetch
worker thread; a lock keeps the counters consistent.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict


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
