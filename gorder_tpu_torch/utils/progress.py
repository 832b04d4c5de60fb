"""In-place terminal progress line for the trajectory loop.

Behavioral reference: the groan ProgressPrinter the reference attaches to
non-silent runs (src/analysis/common.rs:255-259) — an updating
``[ ANALYZING ] Step … | Time …`` line on stdout. Here the unit is frames
(the step/time pair lives host-side only per batch); the line only renders
on a real terminal so piped output and tests stay clean.
"""

from __future__ import annotations

import sys
import time


class ProgressPrinter:
    """Throttled ``\\r``-updating progress line; no-op off-terminal."""

    def __init__(self, total_frames: int, stream=None,
                 min_interval: float = 0.2):
        self.stream = sys.stdout if stream is None else stream
        self.total = int(total_frames)
        self.min_interval = min_interval
        self._last = 0.0
        self._active = bool(getattr(self.stream, "isatty", lambda: False)())
        self._finished = False

    def _render(self, label: str, done: int) -> None:
        pct = 100.0 * done / self.total if self.total else 100.0
        self.stream.write(f"\r[ {label} ]   Frame {done:>10} / "
                          f"{self.total} ({pct:5.1f} %)")
        self.stream.flush()

    def update(self, frames_done: int) -> None:
        if not self._active or self._finished:
            return
        now = time.monotonic()
        if now - self._last < self.min_interval:
            return
        self._last = now
        self._render("ANALYZING", min(frames_done, self.total))

    def finish(self) -> None:
        if not self._active or self._finished:
            return
        self._finished = True
        self._render("COMPLETED", self.total)
        self.stream.write("\n")
        self.stream.flush()
