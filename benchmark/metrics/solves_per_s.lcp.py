"""LCPs solved a second over the traced window (host clock), the LCP
cell.  The profiler's host cost about halves the calls of an untraced
window, and the host's speed drifts within a run, so this rate is read
beside the cell's end-to-end metrics and bounds nothing."""


def read(run):
    if not run.calls or not run.window_s:
        return None
    return run.calls * run.loop.B / run.window_s
