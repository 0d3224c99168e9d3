"""The served forward's share of the card's bf16 peak, %: one batch's
FLOPs (``FlopCounterMode`` at set-up, padding included: the card computes
it) times the batches in the traced window, over the time the card was
busy there and the peak."""


def read(run):
    w = run.window
    if not (w and w.units and run.flops and run.peaks and w.busy_s > 0):
        return None
    return 100.0 * run.flops * w.units / w.busy_s / run.peaks["bf16_flop_s"]
