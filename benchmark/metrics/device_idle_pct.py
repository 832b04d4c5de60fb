"""device_idle_pct (%; the device): the share of the traced window in
which no kernel, copy or memset runs on the card, from the union of the
profiler's device intervals."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
