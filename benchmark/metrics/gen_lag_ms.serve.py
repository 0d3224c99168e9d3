"""How late the batcher dispatched, ms: the mean over the window's batches
of the time from when a batch could go (full, or its oldest request timed
out) to its dispatch; the benchmark's host clock."""

import numpy as np


def read(run):
    lags = run.spans.get("gen_lag")
    return float(np.mean(lags)) * 1e3 if lags else None
