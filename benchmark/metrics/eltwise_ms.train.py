"""Elementwise, copy and cast kernel time a step, ms, from the device trace
(rank 0's card)."""

from benchmark.trace import ELEMENTWISE


def read(run):
    w = run.window
    t = w.category_s(*ELEMENTWISE) if w and w.units else 0.0
    return t / w.units * 1e3 if t > 0 else None
