"""Reading a ``torch.profiler`` window: the device's busy time, kernel time
by category and by name, and the idle gaps by what the host was doing.

``CATEGORIES``, ``category`` and ``busy_us`` are frozen copies of
``axcnn_torch/cli/profile_step.py``'s, so a later change to the program
does not move the yardstick.
"""

from __future__ import annotations

import bisect
import contextlib
import re

import torch

WINDOW = "bench.window"

CATEGORIES = (  # (category, substrings of a device event's name); the first match wins
    ("hand-written kernels", ("blur3_s2", "dropblock_")),
    ("NCCL collectives", ("nccl",)),
    ("elementwise_kernel<128, 2>", ("elementwise_kernel<128, 2,",)),
    ("other elementwise, copies and casts", ("elementwise_kernel", "elementwise")),
    ("reductions", ("reduce_kernel", "Reduce", "reduce")),
    ("optimizer and EMA (_foreach)", ("multi_tensor_apply",)),
    ("memcpy and memset", ("Memcpy", "Memset")),
    ("convolutions and GEMMs", ("cudnn", "xmma", "gemm", "cutlass", "conv", "sm90", "dgrad",
                                "wgrad", "implicit")),
)
ELEMENTWISE = ("elementwise_kernel<128, 2>", "other elementwise, copies and casts")


def category(name: str) -> str:
    return next((cat for cat, keys in CATEGORIES if any(k in name for k in keys)), "other")


def busy_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


class Window:
    """What one traced window holds: ``device`` [(name, start µs, end µs)]
    clipped to the window, ``host`` the same of the host's operations,
    ``start``/``end`` the window's bounds (µs), ``units`` the steps or
    batches that ran inside it."""

    def __init__(self, device, host, start, end, units):
        self.device, self.host, self.start, self.end, self.units = device, host, start, end, units

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return busy_us((s, e) for _, s, e in self.device) / 1e6

    def category_s(self, *cats) -> float:
        return sum(e - s for n, s, e in self.device if category(n) in cats) / 1e6

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return labelled(sorted(by.items(), key=lambda kv: -kv[1])[:top])

    def idle_gaps(self, top: int = 10) -> list:
        """The device's idle time inside the window, by the innermost host
        operation that was running at each gap's middle."""
        gaps, end = [], self.start
        for s, e in sorted((s, e) for _, s, e in self.device):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.end > end:
            gaps.append((end, self.end))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = {}
        for g0, g1 in gaps:
            t = (g0 + g1) / 2
            i = bisect.bisect_right(starts, t) - 1
            name = "no_host_event"
            for j in range(i, max(i - 4000, -1), -1):
                if host[j][2] >= t:
                    name = host[j][0]
                    break
            by[name] = by.get(name, 0.0) + (g1 - g0) / 1e6
        return labelled(sorted(by.items(), key=lambda kv: -kv[1])[:top])


NOISE = ("void ", "at::native::", "(anonymous namespace)::", "at::", "c10::", "std::")


def labelled(rows) -> list:
    """[[label, seconds]]: each name as its kernel and the last functor or
    op it names, without namespaces, in 64 characters of
    ``[A-Za-z0-9_.:-]``; a label that repeats gets ``#2``, ``#3``."""
    out, seen = [], {}
    for name, v in rows:
        for n in NOISE:
            name = name.replace(n, "")
        if "<" in name:
            head = re.match(r"[\w:]*", name).group()
            ops = re.findall(r"\w*(?:Functor|Ops|Op|copy|Sum|Mean|Max)\w*", name[len(head):])
            name = head + ("." + ops[-1] if ops else "")
        label = re.sub(r"[^A-Za-z0-9_.:-]+", "_", name)[:61]
        seen[label] = seen.get(label, 0) + 1
        out.append([label if seen[label] == 1 else f"{label}#{seen[label]}", v])
    return out


@contextlib.contextmanager
def traced(device, units: list):
    """Profile the body as one window; the body appends to ``units`` one
    entry per step or batch it runs. Yields a list that holds, once the
    body has ended (the device synchronized at both ends), a function that
    reads the ``Window``: the reading takes seconds, so a caller whose
    clock runs on calls it afterwards."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out = []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield out
            sync()
    n = len(units)
    out.append(lambda: _window(prof, n))


def _window(prof, units: int) -> Window:
    from torch.autograd import DeviceType

    dev, host, bounds = [], [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("nccl:")
                    or e.name == WINDOW):
                dev.append((e.name, s, t))
        elif e.name == WINDOW:
            bounds = (s, t)
        else:
            host.append((e.name, s, t))
    start, end = bounds
    dev = [(n, max(s, start), min(t, end)) for n, s, t in dev if t > start and s < end]
    return Window(dev, host, start, end, units)
