"""The whole step's share of the card's bf16 peak, %: one step's FLOPs (as
``FlopCounterMode`` counts them at set-up) times the window's steady
steps, over the steady part of the window and the peak (outside the
profiled and probed steps). Each card runs its own step, so a card's
share is the whole run's."""


def read(run):
    if not (run.flops and run.peaks and run.units_total):
        return None
    return 100.0 * run.flops * run.units_total / run.window_total_s / run.peaks["bf16_flop_s"]
