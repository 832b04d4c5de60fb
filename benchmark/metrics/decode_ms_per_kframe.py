"""decode_ms_per_kframe (ms; decode: io/traj.py, native/xdr.cpp, the
decode thread of engine/batches.py): the port's `decode` timer, the decode
thread busy on the batches (beside `decode_wait_ms_per_kframe`, the batch
loop waiting on it), summed over the window's analyses, per 1,000
frames."""


def read(run):
    timed = [a for a in run.analyses if "decode" in a.timers]
    frames = sum(a.frames for a in timed)
    if not frames:
        return None
    return 1e6 * sum(a.timers["decode"] for a in timed) / frames
