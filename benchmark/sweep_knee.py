"""Find the serving cell's knee: the open loop at a few fixed rates in one
process, each for ``--seconds``, with how late the batcher ran.

    python3 -m benchmark.sweep_knee --workload ar50_serve_b128_open --rates 1500,2000,2400

One JSON line a rate: the batcher's lag (mean, 95th percentile, largest,
and the mean over the window's first and last quarters: a lag that grows
through the window marks a rate above what the system sustains) and the
latency's median and 95th percentile. The knee is the highest rate whose
lag stays bounded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers import serve_open


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="ar50_serve_b128_open")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    harness.set_caches()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cell = harness.Cell(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate_per_s"] = rate
        s = serve_open.serve(cell, args.seed, args.seconds, False, time.perf_counter(),
                             torch.device("cuda", 0))
        lags = np.asarray(s["lags"]) * 1e3
        q = max(1, len(lags) // 4)
        print(json.dumps({"rate_per_s": rate, "batches": len(lags),
                          "lag_ms_mean": float(lags.mean()),
                          "lag_ms_p95": float(np.percentile(lags, 95)),
                          "lag_ms_max": float(lags.max()),
                          "lag_ms_first_quarter": float(lags[:q].mean()),
                          "lag_ms_last_quarter": float(lags[-q:].mean()),
                          "p50_ms": float(np.percentile(s["lat"], 50) * 1e3),
                          "p95_ms": float(np.percentile(s["lat"], 95) * 1e3)}), flush=True)
        del s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
