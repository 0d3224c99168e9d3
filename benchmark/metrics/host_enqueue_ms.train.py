"""The host's time in one call of the train step, ms: the median of calls
each made after a synchronize, so the launch queue never blocks them; the
benchmark's host clock around the call."""

import numpy as np


def read(run):
    spans = run.spans.get("host_enqueue")
    return float(np.median(spans)) * 1e3 if spans else None
