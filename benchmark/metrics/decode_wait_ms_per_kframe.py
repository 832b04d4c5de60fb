"""decode_wait_ms_per_kframe (ms; decode: io/traj.py, native/xdr.cpp, the
decode thread of engine/batches.py): the port's `wait` timer, the batch loop
blocked on the decoder, summed over the window's analyses, per 1,000
frames."""


def read(run):
    frames = sum(a.frames for a in run.analyses)
    if not frames:
        return None
    return 1e6 * sum(a.timers.get("wait", 0.0) for a in run.analyses) \
        / frames
