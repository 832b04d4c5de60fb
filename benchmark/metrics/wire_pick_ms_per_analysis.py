"""wire_pick_ms_per_analysis (ms; wire pick: engine/channels.py
`plan_wire`, engine/wire.py: the link probe, the host's int16 rate and
each wire's probe): the port's `pick` timer, the mean over the window's
analyses. None where the program times no `pick`."""


def read(run):
    spans = [a.timers["pick"] for a in run.analyses if "pick" in a.timers]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
