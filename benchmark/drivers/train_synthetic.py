"""Training on a resident synthetic batch: ``make_train_step``'s step,
enqueued back to back, one rank a card.

Set-up builds the train state and the step once, on each rank, and drives
that same object through the ``checked_steps`` first steps on distinct
batches of the pool; their losses, the first gradient as the optimizer
takes it (the momentum after one step) and the changes of the parameters,
moving statistics and EMA are what ``correct`` judges. Then
``warm_steps`` steps, timed, fix how many steps the window takes (the
same on every rank): as many as the warm-up's pace fits into
``--seconds``. The window enqueues them back to back and ends when the
card has run the last; ``train_img_s`` is every rank's images over that
time.

A traced run profiles ``trace_steps`` steps from the window's middle,
then times ``enqueue_probe_steps`` calls on the host, each after a
synchronize, and counts one step's FLOPs at set-up. Its per-layer readers
see the rest of the window as its steady part: the steps and the time
outside the profiled and probed steps.

Several ranks: this process is rank 0 and starts the others (``spawn``);
they meet over NCCL at a free local TCP port, and rank 0 gathers their
readings and prints the line. The reference runs on rank 0's card once
every rank has freed its state: one step over the global batch.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from benchmark import judge, program, trace
from benchmark.harness import metric
from benchmark.reference import step as ref_step
from benchmark.reference.model import param_shapes
from benchmark.weights import make_images, make_labels, make_params


class Pool:
    """``pool_batches`` global batches of seeded images and labels on the
    device; ``batch(i, rank)`` is rank ``rank``'s shard of global
    batch ``i`` (cycling)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, world: int):
        self.per = traffic["per_card_batch"]
        self.glob = self.per * world
        self.k = traffic["pool_batches"]
        n = self.k * self.glob
        self.images = make_images(n, config["image_size"], seed, device)
        self.labels = make_labels(n, config["model"]["num_classes"], seed, device)

    def rows(self, i: int, rank: int | None = None) -> slice:
        """Global batch ``i``'s rows: rank ``rank``'s shard, or all."""
        first = (i % self.k) * self.glob
        if rank is None:
            return slice(first, first + self.glob)
        return slice(first + rank * self.per, first + (rank + 1) * self.per)

    def batch(self, i: int, rank: int) -> dict:
        r = self.rows(i, rank)
        return {"images": self.images[r], "labels": self.labels[r]}


def _norms(tensors: dict, minus=None) -> dict:
    keys = list(tensors)
    vals = torch.stack([(tensors[k].double() - (0.0 if minus is None else minus[k].double()))
                        .norm() for k in keys]).tolist()
    return dict(zip(keys, vals))


def program_readings(state, step_fn, pool, seed: int, rank: int, steps: int) -> dict:
    """Drive ``state`` through its first ``steps`` steps; the readings that
    the judge compares."""
    model = state.model
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    losses, grad = [], None
    for i in range(steps):
        state, m = step_fn(state, pool.batch(i, rank), seed)
        losses.append(float(m["loss"]))
        if i == 0:
            grad = _norms(state.velocity)
    buffers = dict(model.named_buffers())
    init = {k: torch.full_like(b, 0.0 if k.endswith("running_mean") else 1.0)
            for k, b in buffers.items()}
    return {"losses": losses, "grad": grad,
            "param": _norms(dict(model.named_parameters()), p0),
            "bnstat": _norms(buffers, init),
            "ema": _norms(state.ema, p0) if state.ema is not None else {}}


def reference_readings(cell, seed: int, device, *, quant=None, rows=None,
                       dtype=torch.float32) -> dict:
    """The reference's readings of the same steps: one step over the
    global batch (``rows``: the rows of each batch it takes, default all),
    computed in ``dtype``."""
    config, traffic = cell.config, cell.traffic
    model, recipe = config["model"], config["train"]
    world = traffic["ranks"]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pool = Pool(config, traffic, seed, device, world)
    P = {k: p.to(dtype) for k, p in make_params(param_shapes(model), seed, device).items()}
    M = ref_step.moving_init(model, device, dtype)
    V = {k: torch.zeros_like(p) for k, p in P.items()}
    p0 = {k: p.clone() for k, p in P.items()}
    E = {k: p.clone() for k, p in P.items()} if recipe["use_ema"] else None
    rows = rows or slice(None)
    n = len(range(pool.glob)[rows])
    stepper = ref_step.Step(model, recipe, shards=max(1, n // pool.per) if n % pool.per == 0
                            else 1, quant=quant)
    start, ramp = traffic["start_step"], traffic["dropblock_ramp_steps"]
    losses, grad = [], None
    for i in range(traffic["checked_steps"]):
        b = pool.rows(i)
        images, labels = pool.images[b][rows], pool.labels[b][rows]
        s = start + i
        loss, grads = stepper(P, M, V, E, images, labels, seed, s,
                              lr=ref_step.recipe_lr(recipe, s), progress=np.float32(s) / np.float32(max(ramp, 1)))
        losses.append(loss)
        if i == 0:
            grad = _norms(grads)
        del grads
    bn = {}
    for name, (mean, var) in M.items():
        bn[f"{name}.running_mean"] = float(mean.double().norm())
        bn[f"{name}.running_var"] = float((var.double() - 1.0).norm())
    return {"losses": losses, "grad": grad, "param": _norms(P, p0), "bnstat": bn,
            "ema": _norms(E, p0) if E is not None else {}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _flops(step_fn, state, batch, seed) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step_fn(state, batch, seed)
    return float(counter.get_total_flops())


def rank_main(cell, seed, seconds, trace_on, rank, world, port, t0, device=None):
    """One rank's run; returns its summary (rank 0: with the reference's
    judgement)."""
    config, traffic = cell.config, cell.traffic
    device = device or torch.device("cuda", rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = None
    if world > 1:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=180))
        group = dist.group.WORLD
    state = program.build_state(config, seed, device, use_ema=config["train"]["use_ema"])
    state.step = traffic["start_step"]
    step_fn = program.train_step_fn(config, traffic, group)
    pool = Pool(config, traffic, seed, device, world)
    readings = program_readings(state, step_fn, pool, seed, rank,
                                traffic["checked_steps"])
    k = traffic["checked_steps"]
    _sync(device)
    w0 = time.perf_counter()
    for i in range(traffic["warm_steps"]):
        step_fn(state, pool.batch(k + i, rank), seed)
        _sync(device)
    pace = (time.perf_counter() - w0) / traffic["warm_steps"]
    count = torch.tensor([max(1, math.ceil(seconds / pace))], device=device)
    if group is not None:
        dist.broadcast(count, 0)
    n_steps = int(count.item())
    k += traffic["warm_steps"]
    flops = None
    if trace_on:
        flops = _flops(step_fn, state, pool.batch(k, rank), seed)
        k += 1
    _sync(device)
    setup_s = time.perf_counter() - t0

    losses, window, enqueue = [], None, []
    perturbed_steps, perturbed_s = 0, 0.0
    t_start = time.perf_counter()
    i = 0
    traced_from = n_steps // 2 if trace_on else n_steps
    while i < n_steps:
        if i == traced_from:
            p0, i0 = time.perf_counter(), i
            units = []
            with trace.traced(device, units) as out:
                for _ in range(min(traffic["trace_steps"], n_steps - i)):
                    _, m = step_fn(state, pool.batch(k + i, rank), seed)
                    losses.append(m["loss"])
                    units.append(1)
                    i += 1
            for _ in range(min(traffic["enqueue_probe_steps"], n_steps - i)):
                _sync(device)
                h0 = time.perf_counter()
                _, m = step_fn(state, pool.batch(k + i, rank), seed)
                enqueue.append(time.perf_counter() - h0)
                losses.append(m["loss"])
                i += 1
            _sync(device)
            perturbed_steps, perturbed_s = i - i0, time.perf_counter() - p0
            continue
        _, m = step_fn(state, pool.batch(k + i, rank), seed)
        losses.append(m["loss"])
        i += 1
    _sync(device)
    elapsed = time.perf_counter() - t_start
    if trace_on:
        window = out[0]()
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    mine = {"rank": rank, "readings": readings, "peak": peak, "steps": n_steps,
            "failed": failed, "elapsed": elapsed, "setup_s": setup_s,
            "steady": (n_steps - perturbed_steps, elapsed - perturbed_s),
            "busy_s": window.busy_s if window else None,
            "window_s": window.window_s if window else None}
    gathered = [mine]
    if group is not None:
        gathered = [None] * world
        dist.all_gather_object(gathered, mine)
        dist.barrier()
        dist.destroy_process_group()
    del state, step_fn, pool, losses
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    return _finish(cell, seed, device, gathered, window, flops, enqueue)


def rate(ranks: list, per_card: int) -> float:
    """Every rank's images over the window: from its start until the card
    of the last rank to finish has run its last step."""
    return sum(r["steps"] for r in ranks) * per_card / max(r["elapsed"] for r in ranks)


def _finish(cell, seed, device, ranks, window, flops, enqueue) -> dict:
    traffic = cell.traffic
    world = len(ranks)
    ref = reference_readings(cell, seed, device)
    numbers = {}
    for r in ranks:
        for k, v in judge.train_numbers(r["readings"], ref).items():
            numbers[k] = max(numbers.get(k, 0.0), v if v == v else math.inf)
    for k, v in numbers.items():
        print(f"reading {k} {v!r}", file=sys.stderr)
    checked = judge.checks(numbers, cell.limits)
    r0 = ranks[0]
    out = {
        "correct": judge.is_correct(checked),
        "attempted": r0["steps"],
        "failed": max(r["failed"] for r in ranks),
        "end_to_end": {"train_img_s": metric(rate(ranks, traffic["per_card_batch"]), "img/s"),
                       "setup_s": metric(r0["setup_s"], "s")},
        "peak": max(r["peak"] for r in ranks),
        "checks": checked,
        "window": window,
        "flops": flops,
        "spans": {"host_enqueue": enqueue},
        "units_total": r0["steady"][0],
        "window_total_s": r0["steady"][1],
    }
    if window is not None:
        out["busy_s"] = sum(r["busy_s"] for r in ranks) / world
        out["window_s"] = window.window_s
    return out


def _rank_entry(cell, seed, seconds, trace_on, rank, world, port, t0, device_type):
    from benchmark.harness import set_caches

    set_caches()
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    rank_main(cell, seed, seconds, trace_on, rank, world, port, t0, device)


def run(cell, seed: int, seconds: float, trace_on: bool, t0: float, device=None) -> dict:
    world = cell.traffic["ranks"]
    if world == 1:
        return rank_main(cell, seed, seconds, trace_on, 0, 1, None, t0, device)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    kind = "cuda" if device is None else device.type
    procs = [ctx.Process(target=_rank_entry, args=(cell, seed, seconds, trace_on, r, world, port,
                                                   t0, kind))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        result = rank_main(cell, seed, seconds, trace_on, 0, world, port, t0, device)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return result
