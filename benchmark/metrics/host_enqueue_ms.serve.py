"""The host's time in one call of ``eval_logits``, ms: the median over the
window's batches; the benchmark's host clock around the call."""

import numpy as np


def read(run):
    spans = run.spans.get("host_enqueue")
    return float(np.median(spans)) * 1e3 if spans else None
