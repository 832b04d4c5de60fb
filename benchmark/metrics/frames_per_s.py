"""frames_per_s (frames/s, end to end, host clock): every trajectory frame
of every analysis the window completed, over the window's seconds; an
analysis counts from `Analysis.from_file` to its YAML written, and the
window runs from the first one's start to the last one's end."""


def read(run):
    if not run.analyses or run.window_s <= 0:
        return None
    return sum(a.frames for a in run.analyses) / run.window_s
