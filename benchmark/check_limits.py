"""The readings that a cell's limits are set from, on the card at the cell's
own size, one process for every seed.

    python3 -m benchmark.check_limits --workload NAME --seeds 1,2,3 [--window S]

For each seed, one JSON line for each reading, every number that the judge
computes (``benchmark/judge.py``):

- ``program``: the program as the run drives it (training: its first
  steps; serving: ``--window`` seconds of the cell's open loop), against
  the reference; data-parallel cells read their program in the runs.
- ``control``: the nearest lower precision against the reference.
  Training: the reference with every conv and dense input and weight
  rounded to float8 e4m3 (``reference.step.fp8_round``). Serving: the
  program's own int8 path (``INT8_SERVING_POLICY``) in the same loop.
- faults, planted in the reference put in the program's place, or in the
  program's answers: ``half`` (training: half of each batch left out, the
  mean over the rest), ``no_exchange`` (data parallel: one rank's shard
  alone, as a rank computes with the exchange between cards left out),
  ``altered`` (serving: one answer swapped for another image's).
- witnesses of the training gaps, on one card: ``bf16_reference`` (the
  reference with every tensor between operations and its gradient rounded
  to bfloat16, the configuration's precision, as ``control`` rounds to
  float8) against the reference; ``reference64`` (the float32 reference
  judged against the same reference in float64) and ``program64`` (the
  program against the float64 reference).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import harness, judge

OUT = harness.ROOT / "chiprun_out"


def _emit(fh, **row):
    line = json.dumps(harness._clean(row))
    print(line, flush=True)
    fh.write(line + "\n")
    fh.flush()


def train_rows(cell, seed, device, fh):
    from benchmark import program
    from benchmark.drivers import train_synthetic as ts
    from benchmark.reference.step import bf16_round, fp8_round

    tr = cell.traffic
    world = tr["ranks"]
    ref = None
    if world == 1:
        state = program.build_state(cell.config, seed, device,
                                    use_ema=cell.config["train"]["use_ema"])
        state.step = tr["start_step"]
        fn = program.train_step_fn(cell.config, tr)
        pool = ts.Pool(cell.config, tr, seed, device, 1)
        prog = ts.program_readings(state, fn, pool, seed, 0, tr["checked_steps"])
        del state, fn, pool
        torch.cuda.empty_cache()
        ref = ts.reference_readings(cell, seed, device)
        _emit(fh, seed=seed, reading="program", **judge.train_numbers(prog, ref),
              worst_grad=judge.worst_leaves(prog["grad"], ref["grad"]),
              worst_param=judge.worst_leaves(prog["param"], ref["param"]))
    ref = ref or ts.reference_readings(cell, seed, device)
    glob = tr["per_card_batch"] * world
    others = {"control": dict(quant=fp8_round), "half": dict(rows=slice(0, glob // 2))}
    if world > 1:
        others["no_exchange"] = dict(rows=slice(0, tr["per_card_batch"]))
    else:
        others["bf16_reference"] = dict(quant=bf16_round)
    for name, kw in others.items():
        t = time.perf_counter()
        other = ts.reference_readings(cell, seed, device, **kw)
        _emit(fh, seed=seed, reading=name, seconds=time.perf_counter() - t,
              **judge.train_numbers(other, ref),
              worst_grad=judge.worst_leaves(other["grad"], ref["grad"]),
              worst_param=judge.worst_leaves(other["param"], ref["param"]))
    if world == 1:
        t = time.perf_counter()
        ref64 = ts.reference_readings(cell, seed, device, dtype=torch.float64)
        _emit(fh, seed=seed, reading="reference64", seconds=time.perf_counter() - t,
              **judge.train_numbers(ref, ref64),
              worst_grad=judge.worst_leaves(ref["grad"], ref64["grad"]))
        _emit(fh, seed=seed, reading="program64", **judge.train_numbers(prog, ref64),
              worst_grad=judge.worst_leaves(prog["grad"], ref64["grad"]),
              worst_param=judge.worst_leaves(prog["param"], ref64["param"]))


def serve_rows(cell, seed, device, window, fh):
    from benchmark.drivers import serve_open as so

    ref = None
    for reading, dtype in (("program", cell.config["dtype"]), ("control", "int8")):
        s = so.serve(cell, seed, window, False, time.perf_counter(), device, dtype=dtype)
        torch.cuda.empty_cache()
        ref = ref if ref is not None else so.reference_logits(cell, seed, device)
        answered = torch.ones(len(s["lat"]), dtype=torch.bool)
        _emit(fh, seed=seed, reading=reading, requests=len(s["lat"]),
              p95_ms=float(torch.tensor(s["lat"]).quantile(0.95)) * 1e3,
              **judge.serve_numbers(s["answers"], answered, s["images"], ref))
        if reading == "program":
            answers, images = s["answers"].clone(), s["images"]
            other = int((images != images[0]).nonzero()[0])
            answers[0] = answers[other]
            _emit(fh, seed=seed, reading="altered",
                  **judge.serve_numbers(answers, answered, images, ref))
        del s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--window", type=float, default=3.0)
    args = ap.parse_args(argv)
    harness.set_caches()
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    OUT.mkdir(exist_ok=True)
    path = Path(OUT / f"limits_{args.workload}.jsonl")
    with path.open("a") as fh:
        for seed in (int(s) for s in args.seeds.split(",")):
            if cell.traffic["kind"] == "serve_open":
                serve_rows(cell, seed, device, args.window, fh)
            else:
                train_rows(cell, seed, device, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
