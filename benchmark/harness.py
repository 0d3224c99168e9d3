"""What every cell shares: the manifest and the files it names, the card
check, the cache directories, the per-layer readers and the result line.

A cell is found by its name in ``BENCHMARK.json``: its configuration file,
``traffic/<traffic>.json`` (whose ``kind`` names the driver,
``drivers/<kind>.py``), ``limits/<workload>.json`` (the limit of each
number compared) and, for each per-layer metric, ``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "axcnn")


class Cell:
    def __init__(self, name: str):
        m = json.loads((ROOT / "BENCHMARK.json").read_text())
        self.manifest = m
        self.workload = next(w for w in m["workloads"] if w["name"] == name)
        conf = next(c for c in m["configs"] if c["name"] == self.workload["config"])
        self.config = json.loads((ROOT / conf["file"]).read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{self.workload['traffic']}.json")
                                  .read_text())
        self.limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
        self.chips = self.workload["chips"]

    def _mine(self, metric) -> bool:
        return self.workload["name"] in metric.get("workloads", [self.workload["name"]])

    @property
    def end_to_end(self) -> list:
        return [m for m in self.manifest["end_to_end"] if self._mine(m)]

    @property
    def per_layer(self) -> list:
        return [m for m in self.manifest["per_layer"] if self._mine(m)]


def set_caches() -> None:
    """Every compiler cache at a fixed path inside the checkout (the
    program's own kernels build into ``axcnn_torch/build/``)."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str | None:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.splitlines()[0].strip() if out.returncode == 0 and out.stdout else None


def read(metric: str, run) -> float | None:
    """The per-layer metric ``metric``'s reader, ``metrics/<metric>.py``'s
    ``read(run)``, applied to ``run``."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}",
                                                  HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def emit(result: dict) -> None:
    """The numbers compared on standard error, then the result line; the
    key ``checks`` comes last in it."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = {k: v for k, v in result.items() if k != "checks"}
    line["checks"] = result["checks"]
    sys.stderr.flush()
    print(json.dumps(_clean(line)), flush=True)


def _clean(v):
    """Non-finite numbers as strings, so the line stays strict JSON."""
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


class TracedRun:
    """What a per-layer reader reads (``metrics/<name>.py``'s ``read``):
    the cell's ``config`` and ``traffic``, the card's published ``peaks``
    (None for a card the table lacks), the traced ``window``
    (``trace.Window``, its ``units`` the steps or batches inside it),
    ``flops`` a step or batch, the host ``spans`` in seconds
    (``host_enqueue``, ``gen_lag``), and the whole measured window:
    ``units_total`` steps or batches in ``window_total_s`` seconds."""

    def __init__(self, cell: Cell, kind: str, out: dict):
        from benchmark import work

        self.config, self.traffic = cell.config, cell.traffic
        self.peaks = work.peaks(kind)
        self.window, self.flops, self.spans = out["window"], out["flops"], out["spans"]
        self.units_total, self.window_total_s = out["units_total"], out["window_total_s"]
