"""write_ms_per_analysis (ms; output: engine/convert.py, present/): the
benchmark's span around `results.write()` plus the port's `convert`
timer, the mean over the window's analyses."""


def read(run):
    if not run.analyses:
        return None
    return 1e3 * sum((a.t_write_end - a.t_run_end)
                     + a.timers.get("convert", 0.0)
                     for a in run.analyses) / len(run.analyses)
