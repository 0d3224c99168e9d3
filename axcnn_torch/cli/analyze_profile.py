"""The per-op roofline of a traced window: a ``torch.profiler`` Chrome trace
joined with the per-op accountant's table of bytes and FLOPs
(``scripts/analyze_profile.py``).

    python -m axcnn_torch.cli.analyze_profile --trace DIR/trace.json --ops DIR/ops.json \\
        [--top 25] [--calibration CALIBRATION.json]

The two files are what ``python -m axcnn_torch.cli.profile_roofline
--trace_out=DIR`` saves for its accounted window; this module reads them
offline, with no card, and ``profile_roofline`` calls the same ``join`` in
its process. The table's records (``RooflineAccountant``): one a dispatched
aten op or hand-written kernel launch, ``i`` its index, with its name,
inputs, non-tensor arguments, FLOPs, bytes and whether it ran in a remat
replay; each ran inside a profiler range named ``roofline#i``.

**Attribution.** Each device event (a kernel, memcpy or memset) is joined
by its ``correlation`` to the runtime or driver API call that launched it,
and attributed to the innermost ``roofline#i`` range that holds that call
on the same thread (the autograd engine's thread launches the backward's).
A device event under no range is unattributed. In a trace of the CPU
(``"device": "cpu"`` in the table) the device events are the CPU ops that
run directly under a range or under none: an op nested in another op is
part of it, and an op that holds a range (an autograd node, the dispatch
around the mode) is only a container.

**The per-op table** groups the records by signature (name, inputs and
arguments) and gives the top ``--top`` rows by device time a step, under
the reference's key names: the category of its longest device events
(``cat``), records (``calls``) and device events (``count``) a step, device
``ms``, ``gb``, ``gbps``, ``gflop`` and ``tfs`` (TFLOP/s) a step, the bound
``ideal_ms`` (the larger of its bytes over 3,350 GB/s and its FLOPs over 989
TFLOP/s; ``bound_by`` says which), the share of the bound its time reaches
and, with ``--calibration`` (a ``calibrate_roofline`` row), its GB/s as a
share of the measured STREAM wall. A row faster than the wall's bytes allow
stays in the table unclamped, flagged ``above_hbm_wall``: its operands came
from L2. ``sum_per_op_ideal_ms`` sums every row's bound,
``per_op_roofline_fraction`` is that over the summed device time.
**Categories** are ``profile_step.CATEGORIES``, matched on the device
events' names: ms and launches a step, and the GB, GB/s, GFLOP, TFLOP/s and
summed bounds of the records each owns (a record belongs to the category
of its longest device event). **Unattributed** device time is given in ms
and as a share of the busy time (the union of the device events'
intervals, ``device_busy_ms_per_step``). **The whole step** (``step_keys``) takes the table's
totals and a wall: FLOPs as executed (``train_gflop_per_step``, a remat
replay included) and without the replay (``model_gflop_per_step``), bytes,
TFLOP/s, ``mfu`` (against 989 TFLOP/s), ``hbm_gbps``, the speed of light
(the larger of the two bounds) and the wall's fraction of it, and with a
calibration the same against the measured walls.

Prints one JSON line with the table's ``card``.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from axcnn_torch.cli.calibrate_roofline import SPEC_HBM_GBPS, SPEC_TFLOPS_BF16
from axcnn_torch.cli.profile_step import busy_us, category

RANGE = "roofline#"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 25
_EPS_US = 1e-3  # a child's end may round past its parent's in the trace's µs


def load_trace(path: str) -> list:
    """The complete events (``"ph": "X"``) of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def load_calibration(path: str) -> dict:
    """The last ``calibrate_roofline`` row in a file of JSON lines."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.lstrip().startswith("{")]
    rows = [r for r in rows if "measured_hbm_gbps" in r]
    if not rows:
        raise ValueError(f"{path} holds no calibrate_roofline row")
    return rows[-1]


def _range_index(e) -> int | None:
    name = e.get("name", "")
    if e.get("cat") == "gpu_user_annotation" or not name.startswith(RANGE):
        return None
    return int(name[len(RANGE):])


def _innermost(ranges, points):
    """``ranges``: ``(start, end, i)`` of one thread, properly nested;
    ``points``: ``(t, key)``. Returns ``{key: i of the innermost range that
    holds t, or None}``."""
    items = sorted([(s, 0, -e, i) for s, e, i in ranges]
                   + [(t, 1, 0.0, key) for t, key in points], key=lambda x: x[:3])
    stack, out = [], {}
    for t, kind, neg_end, val in items:
        while stack and stack[-1][0] + _EPS_US < t:
            stack.pop()
        if kind == 0:
            stack.append((-neg_end, val))
        else:
            out[val] = stack[-1][1] if stack else None
    return out


def _device_events_gpu(events):
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], e["ts"])
    ranges = defaultdict(list)
    for e in events:
        i = _range_index(e)
        if i is not None:
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], i))
    devs = [e for e in events if e.get("cat") in DEVICE_CATS]
    points = defaultdict(list)
    for k, e in enumerate(devs):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            points[launch[0]].append((launch[1], k))
    owner = {}
    for tid, pts in points.items():
        owner.update(_innermost(ranges.get(tid, []), pts))
    return [(e["name"], e["ts"], e["dur"], owner.get(k)) for k, e in enumerate(devs)]


def _device_events_cpu(events):
    by_tid = defaultdict(list)
    for e in events:
        i = _range_index(e)
        if i is not None or e.get("cat") == "cpu_op":
            by_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"], i, e))
    out = []
    for items in by_tid.values():
        items.sort(key=lambda x: (x[0], -x[1]))
        stack = []  # (end, range index or None, candidate slot or None)
        for start, end, i, e in items:
            while stack and stack[-1][0] + _EPS_US < end:
                stack.pop()
            if i is not None:
                # the ops between this range and the one that holds it hold a range:
                # containers, not device events
                for _, j, slot in reversed(stack):
                    if j is not None:
                        break
                    if slot is not None:
                        out[slot] = None
                stack.append((end, i, None))
                continue
            above = next((j for _, j, _ in reversed(stack) if j is not None), None)
            nested = bool(stack) and stack[-1][1] is None
            slot = None
            if not nested:
                slot = len(out)
                out.append((e["name"], start, end - start, above))
            stack.append((end, None, slot))
    return [d for d in out if d is not None]


def device_events(events, cpu: bool = False) -> list:
    """``(name, ts µs, dur µs, record index or None)`` of each device event
    of a trace (module docstring)."""
    return _device_events_cpu(events) if cpu else _device_events_gpu(events)


def signature(rec) -> str:
    return f"{rec['op']}({', '.join(rec['inputs'] + rec['args'])})"


def _bound(gbytes: float, gflop: float):
    """(ms, what bounds it) at the published peaks."""
    by_bytes, by_flops = gbytes / SPEC_HBM_GBPS * 1e3, gflop / SPEC_TFLOPS_BF16
    return max(by_bytes, by_flops), "bytes" if by_bytes >= by_flops else "operations"


def categories(devs, steps: int, owned=None) -> dict:
    """ms and launches a step by ``profile_step`` category; where ``owned``
    (category -> [bytes, FLOPs, bound µs] of the records it owns, over the
    window) is given, also GB, GB/s, GFLOP, TFLOP/s and the records' summed
    bounds (``ideal_ms``) a step."""
    cats = defaultdict(lambda: [0.0, 0])
    for name, _, dur, _ in devs:
        c = cats[category(name)]
        c[0] += dur
        c[1] += 1
    out = {}
    for cat, (us, n) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        row = {"ms": us / 1e3 / steps, "launches": n / steps}
        if owned is not None:
            nbytes, flops, ideal_us = owned.get(cat, (0, 0, 0.0))
            gb, gflop = nbytes / 1e9 / steps, flops / 1e9 / steps
            row.update(gb=gb, gbps=gb / (row["ms"] / 1e3) if us else None, gflop=gflop,
                       tfs=gflop / row["ms"] if us else None, ideal_ms=ideal_us / 1e3 / steps)
        out[cat] = row
    return out


def join(events, table: dict, *, top: int = TOP, calibration: dict | None = None) -> dict:
    """The per-op roofline of one accounted window (module docstring):
    ``events`` of its trace, ``table`` the accountant's (``"device"``,
    ``"steps"``, ``"ops"``). The rows and categories take the reference's
    key names: ``count`` (device events a step), ``ms``, ``gb``, ``gbps``,
    ``gflop``, ``tfs`` (TFLOP/s), ``ideal_ms`` (the bound), ``cat``."""
    steps = table["steps"]
    recs = {r["i"]: r for r in table["ops"]}
    devs = device_events(events, table["device"] == "cpu")
    per = defaultdict(lambda: [0.0, 0, defaultdict(float)])  # i -> [us, launches, cat -> us]
    unattributed = 0.0
    for name, _, dur, i in devs:
        if i is None or i not in recs:
            unattributed += dur
            continue
        p = per[i]
        p[0] += dur
        p[1] += 1
        p[2][category(name)] += dur
    wall_gbps = calibration["measured_hbm_gbps"] if calibration else SPEC_HBM_GBPS
    groups = defaultdict(lambda: {"calls": 0, "count": 0, "us": 0.0, "bytes": 0, "flops": 0,
                                  "cats": defaultdict(float)})
    owned = defaultdict(lambda: [0, 0, 0.0])
    for i, rec in recs.items():
        g = groups[signature(rec)]
        us, n, cats = per.get(i, (0.0, 0, {}))
        g["calls"] += 1
        g["count"] += n
        g["us"] += us
        g["bytes"] += rec["bytes"]
        g["flops"] += rec["flops"]
        for cat, t in cats.items():
            g["cats"][cat] += t
        if cats:
            own = owned[max(cats, key=cats.get)]
            own[0] += rec["bytes"]
            own[1] += rec["flops"]
            own[2] += _bound(rec["bytes"] / 1e9, rec["flops"] / 1e9)[0] * 1e3
    rows, ideal_ms = [], 0.0
    for sig, g in sorted(groups.items(), key=lambda kv: -kv[1]["us"]):
        ms, gb, gflop = g["us"] / 1e3 / steps, g["bytes"] / 1e9 / steps, g["flops"] / 1e9 / steps
        bound_ms, bound_by = _bound(gb, gflop)
        ideal_ms += bound_ms
        if len(rows) == top:
            continue
        gbps = gb / (ms / 1e3) if ms else None
        row = {"op": sig[:240], "cat": max(g["cats"], key=g["cats"].get) if g["cats"] else None,
               "calls": g["calls"] / steps, "count": g["count"] / steps, "ms": ms, "gb": gb,
               "gbps": gbps, "gflop": gflop, "tfs": gflop / ms if ms else None,
               "ideal_ms": bound_ms, "bound_by": bound_by,
               "share_of_bound": bound_ms / ms if ms else None,
               "above_hbm_wall": gbps is not None and gbps > wall_gbps}
        if calibration:
            row["share_of_stream"] = gbps / calibration["measured_hbm_gbps"] if ms else None
        rows.append(row)
    busy_ms = busy_us((ts, ts + dur) for _, ts, dur, _ in devs) / 1e3 / steps
    traced_ms = sum(dur for _, _, dur, _ in devs) / 1e3 / steps
    return {
        "steps": steps, "records_per_step": len(recs) / steps,
        "device_events_per_step": len(devs) / steps, "device_busy_ms_per_step": busy_ms,
        "total_traced_ms_per_step": traced_ms, "sum_per_op_ideal_ms": ideal_ms,
        "per_op_roofline_fraction": ideal_ms / traced_ms if traced_ms else None,
        "unattributed_ms": unattributed / 1e3 / steps,
        "unattributed_share": unattributed / 1e3 / steps / busy_ms if busy_ms else None,
        "categories": categories(devs, steps, owned),
        "top_ops": rows,
        "totals": totals(table),
    }


def totals(table: dict) -> dict:
    """The table's FLOPs (as executed and without a remat replay) and bytes
    a step."""
    steps, ops = table["steps"], table["ops"]
    return {"flops": sum(r["flops"] for r in ops) / steps,
            "model_flops": sum(r["flops"] for r in ops if not r["replay"]) / steps,
            "bytes": sum(r["bytes"] for r in ops) / steps}


def step_keys(tot: dict, wall_s: float, calibration: dict | None = None) -> dict:
    """``bench.py``'s step keys from ``totals`` and a step's wall."""
    flops, nbytes = tot["flops"], tot["bytes"]
    sol_s = max(flops / (SPEC_TFLOPS_BF16 * 1e12), nbytes / (SPEC_HBM_GBPS * 1e9))
    out = {"train_gflop_per_step": flops / 1e9, "model_gflop_per_step": tot["model_flops"] / 1e9,
           "gbytes_per_step": nbytes / 1e9, "step_ms": wall_s * 1e3,
           "tflops": flops / wall_s / 1e12, "mfu": flops / wall_s / 1e12 / SPEC_TFLOPS_BF16,
           "hbm_gbps": nbytes / wall_s / 1e9,
           "hbm_fraction_of_spec": nbytes / wall_s / 1e9 / SPEC_HBM_GBPS,
           "speed_of_light_ms": sol_s * 1e3, "fraction_of_speed_of_light": sol_s / wall_s}
    if calibration:
        gbps, tflops = calibration["measured_hbm_gbps"], calibration["measured_tflops_bf16"]
        ach_s = max(flops / (tflops * 1e12), nbytes / (gbps * 1e9))
        out.update(measured_hbm_gbps=gbps, measured_tflops_bf16=tflops,
                   hbm_fraction_of_measured=nbytes / wall_s / 1e9 / gbps,
                   speed_of_light_achievable_ms=ach_s * 1e3, fraction_of_achievable=ach_s / wall_s)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", required=True, help="the accounted window's Chrome trace")
    ap.add_argument("--ops", required=True, help="the accountant's table (JSON)")
    ap.add_argument("--top", type=int, default=TOP)
    ap.add_argument("--calibration", help="a file holding a calibrate_roofline row")
    args = ap.parse_args(argv)
    with open(args.ops) as f:
        table = json.load(f)
    calibration = load_calibration(args.calibration) if args.calibration else None
    result = join(load_trace(args.trace), table, top=args.top, calibration=calibration)
    if table.get("wall_ms"):
        result.update(step_keys(result["totals"], table["wall_ms"] / 1e3, calibration))
    print(json.dumps({"profile": "analyze", **result, "card": table.get("card")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
