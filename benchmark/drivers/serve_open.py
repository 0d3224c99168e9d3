"""Serving an open loop of one-image requests through a dynamic batcher:
``eval_logits`` on batches of ``batch`` images, at most ``max_inflight``
batches in flight.

Arrivals: ``rate_per_s`` times ``--seconds`` requests whose gaps are one
fixed set, the quantiles of an exponential distribution scaled to fill the
window, in an order drawn from the seed; so every seed offers the same
gaps, in another order, and every request falls due inside the window.
Each request is one image of a pool of ``pool_images`` seeded images held
in pinned host memory, drawn from the seed.

The batcher dispatches when ``batch`` requests are due, or when the oldest
has waited ``timeout_ms``; a short batch is padded, so one shape is ever
run. A dispatch copies each request's image from the pinned pool into the
card's input buffer, enqueues the forward and copies the logits into
pinned host memory, then records an event. A request's latency runs from when it was
due to when that event completes, on the card's clock mapped onto the
host's at the window's start; the tail is over every request due in the
window. Set-up warms the one shape with ``warm_batches`` dispatches.

A traced run profiles the dispatches of ``trace_s`` seconds from the
window's middle (the card synchronized at both ends) and counts one
batch's FLOPs at set-up; its host spans are those of the batches
dispatched before the profiler started. Python's garbage collector is
off in the window, so its pauses do not fall on the served path, and the
batcher waits for a batch's time by polling the clock, as a server's
polling loop does, so the host core stays awake between batches.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import math
import sys
import time

import numpy as np
import torch

from benchmark import judge, program, trace
from benchmark.harness import metric
from benchmark.reference import step as ref_step
from benchmark.reference.model import param_shapes
from benchmark.weights import make_images, make_params, stream_seed


class Schedule:
    def __init__(self, traffic: dict, seed: int, seconds: float):
        n = max(1, round(traffic["rate_per_s"] * seconds))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
        gaps *= seconds / gaps.sum()
        gaps = np.random.default_rng(stream_seed(seed, "arrivals")).permutation(gaps)
        self.due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        self.image = np.random.default_rng(stream_seed(seed, "requests")).integers(
            0, traffic["pool_images"], n)


def ready_at(due: np.ndarray, first: int, batch: int, timeout: float) -> float:
    """When the batch that starts at request ``first`` may go: once
    ``batch`` requests are due, or once the first has waited ``timeout``."""
    full = due[first + batch - 1] if first + batch - 1 < len(due) else math.inf
    return min(full, due[first] + timeout)


def batch_size_at(due: np.ndarray, first: int, batch: int, now: float) -> int:
    """The requests from ``first`` that are due at ``now``, at most ``batch``."""
    return int(min(batch, np.searchsorted(due, now, side="right") - first))


def tails(lat: np.ndarray, answered: np.ndarray) -> tuple[float, float]:
    """The median and the 95th percentile of every request's latency, one
    that was never answered counting as missing every limit."""
    full = np.where(answered, lat, np.inf)
    return tuple(float(v) for v in np.percentile(full, (50, 95), method="higher"))


class Server:
    """The dispatch path: each request's image copied to the card as the
    batch is received, the forward, the logits copied back, an event a
    batch."""

    def __init__(self, fn, pool_host, batch: int, slots: int, requests: int, classes: int,
                 device):
        self.fn, self.pool, self.batch, self.device = fn, pool_host, batch, device
        shape = (batch,) + tuple(pool_host.shape[1:])
        self.dev_in = [torch.zeros(shape, dtype=torch.uint8, device=device) for _ in range(slots)]
        self.answers = torch.empty((requests, classes), dtype=torch.float32,
                                   pin_memory=device.type == "cuda")

    def dispatch(self, first: int, idx: np.ndarray, slot: int):
        """Returns (start marker, completion marker, host seconds in the
        forward's call): CUDA events on the card, host times elsewhere."""
        count = len(idx)
        cuda = self.device.type == "cuda"
        start = torch.cuda.Event(enable_timing=True) if cuda else time.perf_counter()
        if cuda:
            start.record()
        d = self.dev_in[slot]
        for j, i in enumerate(idx.tolist()):
            d[j].copy_(self.pool[i], non_blocking=True)
        h0 = time.perf_counter()
        logits = self.fn(d)
        enq = time.perf_counter() - h0
        self.answers[first:first + count].copy_(logits[:count], non_blocking=True)
        if cuda:
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            return start, done, enq
        return start, time.perf_counter(), enq


def open_loop(server: Server, sched: Schedule, traffic: dict, seconds: float, trace_on: bool):
    """Serve every request of ``sched``; returns (latencies s, gen lags s,
    enqueue s, traced window or None, batches); in a traced run the lags
    and enqueue times are those of the batches before the profiler
    started."""
    B, timeout = traffic["batch"], traffic["timeout_ms"] / 1e3
    due, n = sched.due, len(sched.due)
    cuda = server.device.type == "cuda"
    slots = len(server.dev_in)
    trace_from, trace_to = (seconds * 0.5, seconds * 0.5 + traffic["trace_s"]) if trace_on \
        else (math.inf, math.inf)
    stack, units, traced, window = contextlib.ExitStack(), [], None, None
    if cuda:
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        e0.synchronize()
    t0 = time.perf_counter()
    batches, lags, enq, inflight = [], [], [], collections.deque()
    nxt = 0
    while nxt < n:
        ready = ready_at(due, nxt, B, timeout)
        if traced is None and ready >= trace_from:
            traced = stack.enter_context(trace.traced(server.device, units))
            spans = (list(lags), list(enq))
        elif traced is not None and window is None and ready >= trace_to:
            stack.close()
            window = traced[0]
        while time.perf_counter() - t0 < ready:
            pass
        if len(inflight) >= traffic["max_inflight"]:
            done = inflight.popleft()
            if cuda:
                done.synchronize()
        now = time.perf_counter() - t0
        count = batch_size_at(due, nxt, B, now)
        start, marker, e = server.dispatch(nxt, sched.image[nxt:nxt + count],
                                           len(batches) % slots)
        lags.append(now - ready)
        enq.append(e)
        inflight.append(marker)
        batches.append((nxt, count, marker, start))
        if traced is not None and window is None:
            units.append(1)
        nxt += count
    if traced is not None and window is None:
        stack.close()
        window = traced[0]
    if cuda:
        torch.cuda.synchronize()
    if traced is not None:
        lags, enq = spans
        window = window()
    lat, card_ms = np.empty(n), []
    for first, count, marker, start in batches:
        done = e0.elapsed_time(marker) / 1e3 if cuda else marker - t0
        lat[first:first + count] = done - due[first:first + count]
        card_ms.append(start.elapsed_time(marker) if cuda else (marker - start) * 1e3)
    print(f"batch on the card ms p5/50/95/max {np.percentile(card_ms, (5, 50, 95, 100))}",
          file=sys.stderr)
    return lat, lags, enq, window, len(batches)


def _flops(fn, images) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(images)
    return float(counter.get_total_flops())


def serve(cell, seed: int, seconds: float, trace_on: bool, t0: float, device, dtype=None):
    """Set-up and the window; returns (summary, program-side state to free)."""
    config, traffic = cell.config, cell.traffic
    dtype = dtype or config["dtype"]
    state = program.build_state(config, seed, device, use_ema=False)
    fn = program.serve_fn(state, dtype)
    pool = make_images(traffic["pool_images"], config["image_size"], seed, device).cpu()
    if device.type == "cuda":
        pool = pool.pin_memory()
    sched = Schedule(traffic, seed, seconds)
    B = traffic["batch"]
    server = Server(fn, pool, B, traffic["max_inflight"] + 1, len(sched.due),
                    config["model"]["num_classes"], device)
    for i in range(traffic["warm_batches"]):
        server.dispatch(0, np.arange(B) % traffic["pool_images"], i % len(server.dev_in))
        if device.type == "cuda":
            torch.cuda.synchronize()
    flops = _flops(fn, server.dev_in[0]) if trace_on else None
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gc.collect()
    gc.disable()
    try:
        lat, lags, enq, window, batches = open_loop(server, sched, traffic, seconds, trace_on)
    finally:
        gc.enable()
    pct = (50, 95, 99, 100)
    print(f"gen lag ms p50/95/99/max {np.percentile(lags, pct) * 1e3}, enqueue ms "
          f"{np.percentile(enq, pct) * 1e3}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return {"lat": lat, "lags": lags, "enq": enq, "window": window, "flops": flops,
            "setup_s": setup_s, "peak": peak, "answers": server.answers,
            "images": torch.from_numpy(sched.image), "batches": batches}


def reference_logits(cell, seed: int, device) -> torch.Tensor:
    config, traffic = cell.config, cell.traffic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = config["model"]
    P = make_params(param_shapes(model), seed, device)
    M = ref_step.moving_init(model, device)
    images = make_images(traffic["pool_images"], config["image_size"], seed, device)
    return ref_step.serve_logits(model, P, M, images, block=traffic["batch"])


def run(cell, seed: int, seconds: float, trace_on: bool, t0: float, device=None) -> dict:
    device = device or torch.device("cuda", 0)
    s = serve(cell, seed, seconds, trace_on, t0, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_logits(cell, seed, device)
    answered = np.isfinite(s["lat"])
    numbers = judge.serve_numbers(s["answers"], torch.from_numpy(answered), s["images"], ref)
    for k, v in numbers.items():
        print(f"reading {k} {v!r}", file=sys.stderr)
    checked = judge.checks(numbers, cell.limits)
    lat = s["lat"]
    p50, p95 = tails(lat, answered)
    out = {
        "correct": judge.is_correct(checked),
        "attempted": len(lat),
        "failed": int((~answered).sum()),
        "end_to_end": {"serve_p50_ms": metric(p50 * 1e3, "ms"),
                       "serve_p95_ms": metric(p95 * 1e3, "ms"),
                       "setup_s": metric(s["setup_s"], "s")},
        "peak": s["peak"],
        "checks": checked,
        "window": s["window"],
        "flops": s["flops"],
        "spans": {"host_enqueue": s["enq"], "gen_lag": s["lags"]},
        "units_total": s["batches"],
        "window_total_s": seconds,
    }
    if s["window"] is not None:
        out["busy_s"] = s["window"].busy_s
        out["window_s"] = s["window"].window_s
    return out
