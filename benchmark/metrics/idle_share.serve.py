"""The share of the window in which the card ran nothing, %: its busy time
a batch in the traced window times the window's batches, against the
window's length (every request falls due inside it). By design the card
waits while batches fill."""


def read(run):
    w = run.window
    if not (w and w.units and w.device and run.units_total):
        return None
    return 100.0 * (1.0 - w.busy_s / w.units * run.units_total / run.window_total_s)
