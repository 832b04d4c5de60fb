"""Name the card's idle time by what the port was doing: read the Chrome
traces a `GORDER_TPU_PROFILE=DIR` run writes (`utils/timers.py`), and cut
every idle gap of the device at the boundaries of the port's `gorder.*`
phase spans.

    python3 -m gorder_tpu_torch.diagnostics.spans DIR/trace-*.json \
        [--top N]

Each trace holds one run: its window is the run's `gorder.total` span.
The device is busy where a kernel, copy or memset runs (the union of
their intervals); each idle stretch in the window is cut where a phase on
the run's thread (the one that holds `gorder.total`) opens or closes, and
each piece is labelled with the innermost phase open over it. The pieces
of every trace add up by label; the idle seconds under a phase other than
`total` are the attributed share. Prints the top N labels and one JSON
line last.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys

from gorder_tpu_torch.utils.timers import SPAN_PREFIX

#: the trace's categories of device work (its `gpu_user_annotation`
#: events mirror host spans on the device's timeline: no work)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOTAL = SPAN_PREFIX + "total"


def load(path: str):
    """→ (the phases on the run's thread [(start, end, name)], the device
    intervals [(start, end)]), in µs, from one Chrome trace."""
    with open(path) as fh:
        events = [ev for ev in json.load(fh)["traceEvents"]
                  if ev.get("ph") == "X"]
    phases = [ev for ev in events if ev.get("cat") == "user_annotation"
              and ev["name"].startswith(SPAN_PREFIX)]
    total = [ev for ev in phases if ev["name"] == TOTAL]
    if len(total) != 1:
        raise ValueError(f"{path}: {len(total)} {TOTAL} spans, not one")
    thread = (total[0]["pid"], total[0]["tid"])
    spans = [(ev["ts"], ev["ts"] + ev["dur"], ev["name"]) for ev in phases
             if (ev["pid"], ev["tid"]) == thread]
    device = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in events
              if ev.get("cat") in DEVICE_CATEGORIES]
    return spans, device


def idle_gaps(device, lo, hi):
    """The stretches of [lo, hi) that no device interval covers."""
    gaps = []
    cursor = lo
    for start, end in sorted(device):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    if cursor < hi:
        gaps.append((cursor, hi))
    return gaps


def innermost(spans, lo, hi):
    """[lo, hi) cut at the boundaries of `spans` (nested, on one thread)
    → [(start, end, the innermost span's name or None)]."""
    pieces = []
    stack = []                               # (end, name), innermost last
    cursor = lo

    def advance(t):
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cursor:
                pieces.append((cursor, end, name))
                cursor = end
        if t > cursor:
            pieces.append((cursor, t, stack[-1][1] if stack else None))
            cursor = t

    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        advance(start)
        stack.append((end, name))
    advance(hi)
    return pieces


def cut(gaps, pieces):
    """The gaps split at the pieces' boundaries → [(name, length)]; both
    lists sorted and each without overlaps."""
    out = []
    j = 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            p0, p1, name = pieces[k]
            length = min(g1, p1) - max(g0, p0)
            if length > 0:
                out.append((name, length))
            k += 1
    return out


def attribute(spans, device):
    """One run's {window, busy, idle} seconds and its idle seconds by the
    innermost phase open over them ({label: s})."""
    lo, hi = next((s0, s1) for s0, s1, name in spans if name == TOTAL)
    gaps = idle_gaps(device, lo, hi)
    idle = collections.Counter()
    for name, length in cut(gaps, innermost(spans, lo, hi)):
        idle[name] += length * 1e-6
    idle_s = sum(g1 - g0 for g0, g1 in gaps) * 1e-6
    window = (hi - lo) * 1e-6
    return {"window_s": window, "busy_s": window - idle_s,
            "idle_s": idle_s}, idle


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("traces", nargs="+")
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)
    sums = collections.Counter()
    idle = collections.Counter()
    for path in args.traces:
        run, by_label = attribute(*load(path))
        sums.update(run)
        idle.update(by_label)
        print(f"{path}: window {run['window_s']:.4f} s, device busy "
              f"{run['busy_s']:.4f} s, idle {run['idle_s']:.4f} s",
              flush=True)
    named = sum(s for label, s in idle.items()
                if label.startswith(SPAN_PREFIX) and label != TOTAL)
    share = named / sums["idle_s"] if sums["idle_s"] > 0 else 0.0
    print(f"{len(args.traces)} runs: idle {sums['idle_s']:.4f} s of "
          f"{sums['window_s']:.4f} s; {100 * share:.2f} % under a phase "
          f"other than {TOTAL}")
    for label, seconds in idle.most_common(args.top):
        print(f"  idle {seconds:.4f} s  {label}")
    print(json.dumps({"runs": len(args.traces), **sums,
                      "idle_named_share": share,
                      "idle_by_phase": dict(idle.most_common())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
