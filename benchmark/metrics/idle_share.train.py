"""The share of the window in which rank 0's card ran nothing, %: its busy
time a step in the traced window (the union of its kernels, copies and
sets) times the steady steps, against the steady part of the window (both
outside the profiled and probed steps, whose host overhead would count)."""


def read(run):
    w = run.window
    if not (w and w.units and w.device and run.units_total):
        return None
    return 100.0 * (1.0 - w.busy_s / w.units * run.units_total / run.window_total_s)
