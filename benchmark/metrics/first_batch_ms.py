"""first_batch_ms (ms; analysis set-up: engine/prepare.py, topology/,
select/, the leaflet and normal runtimes' set-up, the engine/wire.py pick
and its probes): from the `run` call to the first `on_batch` call, the
mean over the window's analyses. It holds the first batch's decode,
transfer and dispatch too."""


def read(run):
    spans = [a.t_first_batch - a.t_run for a in run.analyses
             if a.t_first_batch is not None]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
