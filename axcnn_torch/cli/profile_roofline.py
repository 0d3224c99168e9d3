"""The per-op roofline of the train step or the serving forward on one CUDA
card: every aten op and hand-written kernel's bytes and FLOPs, joined with a
profiler trace (``scripts/profile_roofline.py``).

    python -m axcnn_torch.cli.profile_roofline                      # R50 b128 train step
    python -m axcnn_torch.cli.profile_roofline --mode=serve         # its b128 serving forward
    python -m axcnn_torch.cli.profile_roofline --remat              # the step, remat=blocks
    python -m axcnn_torch.cli.profile_roofline --calibration=CAL.json --trace_out=DIR

**The accountant** (``RooflineAccountant``, a ``TorchDispatchMode``) records
one entry for every aten op the step dispatches, forward and backward: its
name, its inputs' dtypes and shapes, its non-tensor arguments (stride,
padding, groups, ...), and

- **FLOPs** from ``torch.utils.flop_counter``'s own formulas
  (``flop_registry``, the convention of ``profile_step.forward_gflops``):
  convolutions and matmuls count, their padding taps included; every other
  op counts 0. As ``FlopCounterMode`` does, an op with a
  ``CompositeImplicitAutograd`` kernel (``conv2d`` and ``linear`` under
  ``inference_mode``) is counted as the ops it decomposes into;
- **bytes**: each input storage read once and each output storage written
  once, counted by storage (two views of one storage count its elements
  they reach once; a broadcast input its distinct elements). A view moves
  nothing; an in-place op counts its buffer read and written, but one that
  only overwrites it (``copy_``, ``fill_``, ``zero_``, the random fills)
  counts it written; a factory writes its output, and ``empty`` nothing;
  the ``_like`` and ``new_`` factories read no input; ``_foreach`` lists
  count every tensor; an ``out=`` argument is written, not read. Eager
  torch does not fuse, so this is each op's traffic, L2 hits aside;
- whether it ran in a remat replay (``ops.norm.in_replay``), and
- an index ``i``: the op runs inside a profiler range ``roofline#i``
  (``torch._C._profiler._RecordFunctionFast``, which dispatches no op), so
  the kernels it launches can be joined to it.

The hand-written kernels launch through ``ctypes``, which no dispatch mode
sees: each wrapper enters its kernel through
``axcnn_torch.kernels.build.launch``, which while an accountant is active
records the kernel (``kernel::<name>``, its reads and writes under the same
rule, no FLOPs) and brackets the launch in a range of its own. A kernel
launched inside a recorded op (the serving forward's
``axcnn::blur_pool3_s2``) carries that op's bytes, and the op counts none.

**The run.** ``train``: ``profile_step._step_runner``'s step of ``--config``
(1001 classes; bf16, mixup 0.2, label smoothing 0.1; ``--remat``: with
``model.remat=blocks``) on a resident batch of ``--batch`` seeded uint8
images. ``serve``: the bf16 ``eval_logits`` forward of the same model on
such a batch (``latency_bench``'s served function). After ``WARMUP`` (3)
steps: ``--untraced`` steps each timed to the host's read of its loss
(``profile_step.untraced_steps``: ``synced_step_ms``, and the host's
``enqueue_ms``), then ``CHAINED_WINDOWS`` (3) windows of ``--untraced``
steps enqueued back to back with one read at the end of each (the
reference's ``_timed_steps``): each window's ms a step (``chained_ms``),
their median the chained wall (``step_ms``), and on the card
``nvidia-smi``'s SM clock, power draw and limit before the first window and
after each (``smi``), so that a throttled card shows beside the wall. Then
a traced window of ``--steps`` steps without the accountant, summed by
``profile_step.breakdown`` (``plain_busy_ms``, ``plain_idle_share``,
``plain_categories``); last, a traced window of as many steps with the
accountant, under ``FlopCounterMode`` too, joined by
``analyze_profile.join``: the per-op table, the categories with their
bytes, the unattributed device time, and the step's keys over the chained
wall (``analyze_profile.step_keys``; with ``--calibration``, a
``calibrate_roofline`` row, against the measured walls too). The
accountant slows the host and should not move device time:
``busy_ratio`` is the accounted window's busy time over the plain one's.
``flop_counter_gflop_per_step`` is ``FlopCounterMode``'s count of the same
window, which the table's must equal; ``kernels`` gives each hand-written
kernel's launches a step and the bytes of each launch.

``--trace_out=DIR`` keeps the accounted window's trace and table
(``DIR/trace.json``, ``DIR/ops.json``) for ``analyze_profile``. Prints one
JSON line with ``card`` (the ``nvidia-smi`` name and power limit). There is
no fallback: a failed trace fails the run. ``--cpu`` runs it on the host
(the tests, at ``--width`` and ``--image_size`` below the defaults; the
device events are then the CPU ops); without it and without a card it
exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
import json
import os
import sys
import tempfile
import threading
import time
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from axcnn_torch.cli import analyze_profile
from axcnn_torch.cli.calibrate_roofline import smi_line
from axcnn_torch.cli.profile_step import (SEED, _step_runner, breakdown, chained_s,
                                          measurement_device, preset_model, untraced_steps)
from axcnn_torch.kernels import build
from axcnn_torch.ops.norm import in_replay

WARMUP = 3
UNTRACED = 10
CHAINED_WINDOWS = 3
_NO_TRAFFIC = frozenset({"aten::empty", "aten::empty_strided", "aten::empty_like",
                         "aten::new_empty", "aten::new_empty_strided", "aten::resize_",
                         "aten::set_"})
_SHAPE_ONLY = frozenset({"aten::zeros_like", "aten::ones_like", "aten::full_like",
                         "aten::rand_like", "aten::randn_like", "aten::randint_like",
                         "aten::new_zeros", "aten::new_ones", "aten::new_full"})
_OVERWRITE = frozenset({"aten::copy_", "aten::fill_", "aten::zero_", "aten::uniform_",
                        "aten::normal_", "aten::bernoulli_", "aten::random_",
                        "aten::exponential_", "aten::geometric_", "aten::log_normal_",
                        "aten::cauchy_"})
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
           torch.float64: "f64", torch.int64: "i64", torch.int32: "i32", torch.int8: "i8",
           torch.uint8: "u8", torch.bool: "bool"}


def _range(i: int):
    return torch._C._profiler._RecordFunctionFast(f"{analyze_profile.RANGE}{i}")


def _render(t: torch.Tensor) -> str:
    return f"{_DTYPES.get(t.dtype, str(t.dtype))}[{','.join(map(str, t.shape))}]"


def tensor_bytes(tensors) -> int:
    """Bytes of ``tensors``, each storage counted once: the elements its
    tensors reach (a broadcast dimension once), at most the span they
    cover."""
    reach, spans = defaultdict(int), defaultdict(list)
    for t in tensors:
        if t.numel() == 0:
            continue
        item, distinct, extent = t.element_size(), 1, 0
        for size, stride in zip(t.shape, t.stride()):
            if stride:
                distinct *= size
            extent += (size - 1) * abs(stride)
        key = (t.device, t.untyped_storage().data_ptr())
        reach[key] += distinct * item
        lo = t.storage_offset() * item
        spans[key].append((lo, lo + (extent + 1) * item))
    total = 0
    for key, nbytes in reach.items():
        covered, end = 0, -1
        for lo, hi in sorted(spans[key]):
            if hi > end:
                covered += hi - max(lo, end)
                end = hi
        total += min(nbytes, covered)
    return total


def _tensors(value) -> list:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [v for v in value if isinstance(v, torch.Tensor)]
    return []


def _bound_arguments(func, args, kwargs):
    """``(schema argument, value)`` of each argument passed."""
    positional = [a for a in func._schema.arguments if not a.kwarg_only]
    yield from zip(positional, args)
    for a in func._schema.arguments:
        if a.name in kwargs:
            yield a, kwargs[a.name]


def op_bytes(func, args, kwargs, out) -> int:
    """The op's bytes under the module's rule."""
    name = func._schema.name
    if name in _NO_TRAFFIC:
        return 0
    reads, writes = [], []
    for a, value in _bound_arguments(func, args, kwargs):
        tensors = _tensors(value)
        if not tensors:
            continue
        if a.is_out:
            writes += tensors
            continue
        if a.alias_info is not None and a.alias_info.is_write:
            writes += tensors
            if name in _OVERWRITE:
                continue
        reads += tensors
    if name in _SHAPE_ONLY:
        reads = []
    inputs = {(t.device, t.untyped_storage().data_ptr()) for t in reads + writes}
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    fresh = [t for t in outs if (t.device, t.untyped_storage().data_ptr()) not in inputs]
    if outs and not fresh and not writes:
        return 0  # a view
    return tensor_bytes(reads) + tensor_bytes(writes + fresh)


@functools.cache
def _decomposes(func) -> bool:
    """Whether ``func`` has a ``CompositeImplicitAutograd`` kernel (what
    ``OpOverload.decompose`` runs)."""
    key = torch._C.DispatchKey.CompositeImplicitAutograd
    return key in func.py_kernels or torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), key)


def _render_inputs(args, kwargs) -> list:
    """Each tensor argument's dtype and shape; a list of tensors as its length."""
    out = []
    for value in itertools.chain(args, kwargs.values()):
        tensors = _tensors(value)
        if isinstance(value, torch.Tensor):
            out.append(_render(value))
        elif tensors:
            out.append(f"[{len(tensors)} tensors]")
    return out


def _render_args(func, args, kwargs) -> list:
    """Each non-tensor argument passed, ``name=value``."""
    return [f"{a.name}={value!r}"[:80] for a, value in _bound_arguments(func, args, kwargs)
            if value is not None and not _tensors(value)]


class RooflineAccountant(TorchDispatchMode):
    """Records every aten op dispatched and every hand-written kernel
    launched while it is active (module docstring); ``ops`` holds the
    records (dicts of strings and numbers, no tensor), in the order the ops
    began."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self._index = itertools.count()
        self._local = threading.local()
        self._depth = 0
        self._previous = None

    def __enter__(self):
        self._depth += 1
        if self._depth == 1:
            self._previous, build.ACCOUNTANT = build.ACCOUNTANT, self
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            build.ACCOUNTANT = self._previous
        return super().__exit__(*exc)

    def _open(self) -> list:
        """This thread's records of ops still running, innermost last."""
        if not hasattr(self._local, "open"):
            self._local.open = []
        return self._local.open

    def _record(self, op: str, inputs, args, kernel: bool = False) -> dict:
        rec = {"i": next(self._index), "op": op, "inputs": inputs, "args": args, "flops": 0,
               "bytes": 0, "replay": in_replay(), "kernel": kernel}
        self.ops.append(rec)
        return rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.ops.prim.device.default and _decomposes(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        rec = self._record(str(func), _render_inputs(args, kwargs),
                           _render_args(func, args, kwargs))
        running = self._open()
        running.append(rec)
        try:
            with _range(rec["i"]):
                out = func(*args, **kwargs)
        finally:
            running.pop()
        packet = func.overloadpacket
        if packet in flop_registry:
            rec["flops"] = int(flop_registry[packet](*args, **kwargs, out_val=out))
        inner = rec.pop("inner_kernel", False)
        rec["bytes"] = 0 if inner else op_bytes(func, args, kwargs, out)
        return out

    def launch(self, name: str, reads, writes, fn, *args):
        """A hand-written kernel's launch, ``fn(*args)`` (``build.launch``)."""
        rec = self._record(f"kernel::{name}", [_render(t) for t in reads], [], kernel=True)
        rec["bytes"] = tensor_bytes(reads) + tensor_bytes(writes)
        running = self._open()
        if running:
            running[-1]["inner_kernel"] = True
        with _range(rec["i"]):
            return fn(*args)


def kernel_summary(ops, steps: int) -> dict:
    """Each hand-written kernel's launches a step and the sorted bytes of
    its launches over the window."""
    out = defaultdict(lambda: {"launches": 0, "bytes": []})
    for rec in ops:
        if rec["kernel"]:
            k = out[rec["op"].removeprefix("kernel::")]
            k["launches"] += 1
            k["bytes"].append(rec["bytes"])
    return {name: {"launches": k["launches"] / steps, "bytes": sorted(k["bytes"])}
            for name, k in sorted(out.items())}


def count_step(enqueue, wait) -> dict:
    """One step under the accountant: its ``analyze_profile.totals``
    (FLOPs as executed and without a remat replay, bytes)."""
    accountant = RooflineAccountant()
    with accountant:
        wait(enqueue())
    return analyze_profile.totals({"steps": 1, "ops": accountant.ops})


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def traced_window(enqueue, wait, steps: int, device, path: str, *modes):
    """``(events, seconds)`` of a ``torch.profiler`` window of ``steps``
    steps run under ``modes`` (entered in order), saved to ``path`` as a
    Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for mode in modes:
                stack.enter_context(mode)
            for _ in range(steps):
                wait(enqueue())
        _sync(device)
        seconds = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    return analyze_profile.load_trace(path), seconds


def runner(mode: str, cfg, device, batch: int, image_size: int):
    """``(enqueue, wait)`` of the train step or the serving forward."""
    if mode == "train":
        return _step_runner(cfg, device=device, batch_size=batch, image_size=image_size)
    from axcnn_torch.cli.latency_bench import serve_fn, served_state

    serve = serve_fn(served_state(cfg, device), "bf16")
    u8 = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (batch, image_size, image_size, 3), dtype=np.uint8)).to(device)
    return (lambda: serve(u8)), (lambda logits: logits[0, 0].item())


def chained_windows(enqueue, wait, steps: int, windows: int, device) -> dict:
    """``windows`` chained windows of ``steps`` steps each (``chained_s``):
    each window's ms a step, their median, and on the card ``nvidia-smi``'s
    SM clock, power draw and limit before the first window and after each."""
    smi = [smi_line()] if device.type == "cuda" else None
    ms = []
    for _ in range(windows):
        ms.append(chained_s(enqueue, wait, steps)[0] / steps * 1e3)
        if smi is not None:
            smi.append(smi_line())
    return {"chained_ms": ms, "chained_median_ms": float(np.median(ms)), "smi": smi}


def profile_roofline(enqueue, wait, device, *, steps: int = 2, warmup: int = WARMUP,
                     untraced: int = UNTRACED, top: int = analyze_profile.TOP,
                     calibration: dict | None = None, trace_dir: str | None = None,
                     card: str = "cpu") -> dict:
    """The run of the module docstring on ``(enqueue, wait)``."""
    synced = untraced_steps(enqueue, wait, untraced, warmup)
    chained = chained_windows(enqueue, wait, untraced, CHAINED_WINDOWS, device)
    wall_s = chained["chained_median_ms"] / 1e3
    cpu = device.type == "cpu"
    with contextlib.ExitStack() as stack:
        directory = trace_dir or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(directory, exist_ok=True)
        events, seconds = traced_window(enqueue, wait, steps, device,
                                        os.path.join(directory, "plain_trace.json"))
        plain = breakdown(((name, ts, ts + dur) for name, ts, dur, _
                           in analyze_profile.device_events(events, cpu)), steps, seconds)
        accountant, counter = RooflineAccountant(), FlopCounterMode(display=False)
        events, _ = traced_window(enqueue, wait, steps, device,
                                  os.path.join(directory, "trace.json"), counter, accountant)
        table = {"device": device.type, "steps": steps, "card": card, "wall_ms": wall_s * 1e3,
                 "ops": accountant.ops}
        if trace_dir:
            with open(os.path.join(directory, "ops.json"), "w") as f:
                json.dump(table, f)
    joined = analyze_profile.join(events, table, top=top, calibration=calibration)
    busy = joined["device_busy_ms_per_step"]
    return {**analyze_profile.step_keys(joined.pop("totals"), wall_s, calibration),
            "synced_step_ms": synced["untraced_wall_ms"],
            "enqueue_ms": synced["untraced_enqueue_ms"], "untraced": untraced,
            "chained_windows": CHAINED_WINDOWS, **chained,
            "flop_counter_gflop_per_step": counter.get_total_flops() / steps / 1e9,
            "plain_busy_ms": plain["busy_ms"], "plain_idle_share": plain["idle_share"],
            "accounted_busy_ms": busy, "busy_ratio": busy / plain["busy_ms"],
            "plain_categories": plain["by_category_ms"],
            **joined, "kernels": kernel_summary(accountant.ops, steps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="assemble_resnet50", help="a preset (1001 classes)")
    ap.add_argument("--mode", choices=("train", "serve"), default="train")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=2, help="steps in each traced window")
    ap.add_argument("--untraced", type=int, default=UNTRACED,
                    help="steps timed synchronized, and in each chained window")
    ap.add_argument("--top", type=int, default=analyze_profile.TOP)
    ap.add_argument("--remat", action="store_true", help="model.remat=blocks")
    ap.add_argument("--calibration", help="a file holding a calibrate_roofline row")
    ap.add_argument("--trace_out", help="a directory for the accounted window's trace and table")
    ap.add_argument("--width", type=float, default=1.0, help="width multiplier (tests)")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU (tests)")
    args = ap.parse_args(argv)
    if args.untraced < 1 or args.steps < 1:
        ap.error("--untraced and --steps take 1 or more")
    calibration = (analyze_profile.load_calibration(args.calibration) if args.calibration
                   else None)
    picked = measurement_device(args.cpu, "profile_roofline")
    if picked is None:
        return 1
    device, card = picked
    cfg = preset_model(args.config, width_multiplier=args.width,
                       remat="blocks" if args.remat else "none")
    enqueue, wait = runner(args.mode, cfg, device, args.batch, args.image_size)
    result = profile_roofline(enqueue, wait, device, steps=args.steps, warmup=WARMUP,
                              untraced=args.untraced, top=args.top, calibration=calibration,
                              trace_dir=args.trace_out, card=card)
    print(json.dumps({"profile": "roofline", "mode": args.mode, "config": args.config,
                      "remat": cfg.remat, "batch": args.batch, "image_size": args.image_size,
                      "width": args.width, "dtype": "bf16",
                      "images_per_sec": args.batch / result["step_ms"] * 1e3, **result,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
