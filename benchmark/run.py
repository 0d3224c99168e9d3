"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds ``axcnn_torch``. The cell, its
configuration, its traffic and its limits come from ``BENCHMARK.json`` and
the files it names (``benchmark/harness.py``). It exits 1 with no result
where no CUDA card is present or fewer than the cell asks for, and where a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")

    from benchmark import harness

    harness.set_caches()
    cell = harness.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    print(f"device {kind} x{cell.chips} (of {torch.cuda.device_count()}), power limit "
          f"{harness.power_limit()}", file=sys.stderr)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), _T0)

    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(out["peak"])}
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"]}
    if args.trace:
        run = harness.TracedRun(cell, kind, out)
        metrics = {}
        for m in cell.per_layer:
            v = harness.read(m["name"], run)
            if v is not None:
                metrics[m["name"]] = harness.metric(v, m["unit"])
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
        result.update(metrics=metrics, device=device,
                      breakdown={"device_ops": out["window"].device_ops(),
                                 "idle_gaps": out["window"].idle_gaps()})
    else:
        result.update(metrics={m["name"]: out["end_to_end"][m["name"]]
                               for m in cell.end_to_end}, device=device)
    result["checks"] = out["checks"]
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
