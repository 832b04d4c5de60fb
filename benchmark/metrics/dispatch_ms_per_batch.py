"""dispatch_ms_per_batch (ms; step dispatch: engine/batches.py into core/
and ops/): the port's `dispatch` timer over the window's analyses, per
batch handed to the steps (host time: launches are asynchronous)."""


def read(run):
    batches = sum(a.batches for a in run.analyses)
    if not batches:
        return None
    return 1e3 * sum(a.timers.get("dispatch", 0.0)
                     for a in run.analyses) / batches
