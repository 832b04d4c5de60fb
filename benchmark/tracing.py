"""The traced window: `torch.profiler` over the measured analyses (host
operations and every kernel, copy and memset on the card), read in memory
from the profiler's events, never written out.

The harness marks its own spans with `record_function`: `bench.analysis`
(one whole analysis), `bench.run` (the `run` call), `bench.first_batch`
(an instant, the first `on_batch` call) and `bench.write`. The window is
the first analysis's start to the last one's end. From the device events
inside it: the union of their intervals (busy seconds), each operation's
summed seconds, and the idle gaps between them, each named after what the
host was doing then."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

_NS = 1e-9
#: breakdown lists keep this many entries, and names this many characters
TOP = 10
NAME_CHARS = 120


@dataclass
class TraceData:
    window_s: float
    busy_s: float
    device_s: dict = field(default_factory=dict)   # operation → seconds
    gaps: list = field(default_factory=list)       # [(label, seconds)]

    def kernel_seconds(self, *fragments) -> float:
        """Summed seconds of the device operations whose name holds any
        of `fragments`."""
        return sum(s for name, s in self.device_s.items()
                   if any(f in name for f in fragments))

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
                "idle_gaps": [[label, s] for label, s in gaps]}


def _times(event):
    if hasattr(event, "start_ns"):
        start, dur = event.start_ns(), event.duration_ns()
    else:
        start, dur = event.start_us() * 1000, event.duration_us() * 1000
    return start, start + dur


class Tracer:
    """Profile the window when `enabled`; `span(name)` marks a host span
    (nothing when disabled)."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self._prof = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def stop(self):
        """→ TraceData of the window, or None when not tracing."""
        if self._prof is None:
            return None
        import torch

        self._prof.stop()
        spans = {}
        device = []
        for ev in self._prof.profiler.kineto_results.events():
            name = ev.name()
            if name.startswith("bench."):
                # the harness's spans; the profiler also mirrors them on
                # the device's timeline, where they are no device work
                if ev.device_type() != torch.autograd.DeviceType.CUDA:
                    spans.setdefault(name, []).append(_times(ev))
            elif ev.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((*_times(ev), name))
        self._prof = None
        return summarize(spans, device)


def _label(t, spans):
    """What the host was doing at time t (ns), by the harness's spans."""
    for lo, hi in spans.get("bench.write", ()):
        if lo <= t < hi:
            return "write: results.write() (present/)"
    marks = sorted(lo for lo, _ in spans.get("bench.first_batch", ()))
    for lo, hi in spans.get("bench.run", ()):
        if lo <= t < hi:
            first = next((m for m in marks if lo <= m < hi), hi)
            return ("run: set-up to the first batch (structure, topology, "
                    "runtimes, wire pick, first decode)" if t < first else
                    "run: batch loop to its return (decode wait, dispatch, "
                    "drain, convert)")
    for lo, hi in spans.get("bench.analysis", ()):
        if lo <= t < hi:
            return "analysis: Analysis.from_file"
    return "between analyses"


def summarize(spans: dict, device: list) -> TraceData:
    """TraceData from the harness's spans {name: [(start, end) ns]} and
    the device events [(start, end, name)]."""
    analyses = spans.get("bench.analysis", [])
    if not analyses:
        return TraceData(window_s=0.0, busy_s=0.0)
    w0 = min(lo for lo, _ in analyses)
    w1 = max(hi for _, hi in analyses)
    per_op = {}
    clipped = []
    for lo, hi, name in device:
        lo, hi = max(lo, w0), min(hi, w1)
        if hi <= lo:
            continue
        per_op[name] = per_op.get(name, 0.0) + (hi - lo) * _NS
        clipped.append((lo, hi))
    clipped.sort()
    busy = 0
    gaps = []
    cursor = w0
    for lo, hi in clipped:
        if lo > cursor:
            gaps.append((cursor, lo))
        if hi > cursor:
            busy += hi - max(lo, cursor)
            cursor = hi
    if cursor < w1:
        gaps.append((cursor, w1))
    labelled = [(_label((lo + hi) // 2, spans), (hi - lo) * _NS)
                for lo, hi in gaps]
    return TraceData(window_s=(w1 - w0) * _NS, busy_s=busy * _NS,
                     device_s=per_op, gaps=labelled)
