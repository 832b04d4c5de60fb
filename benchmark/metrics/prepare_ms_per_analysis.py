"""prepare_ms_per_analysis (ms; analysis set-up: engine/drivers.py,
engine/prepare.py, topology/, select/, the leaflet and normal runtimes'
set-up, the trajectory's opening in engine/batches.py): the port's
`prepare` timer, everything before the batch loop but the wire pick, the
mean over the window's analyses. None where the program times no
`prepare`."""


def read(run):
    spans = [a.timers["prepare"] for a in run.analyses
             if "prepare" in a.timers]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
