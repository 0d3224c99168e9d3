"""The card's sustainable walls: a STREAM-scale memory rate and a bf16 GEMM
rate (``scripts/calibrate_roofline.py``).

    python -m axcnn_torch.cli.calibrate_roofline

The published peaks (an H100 SXM at its full 700 W: 3,350 GB/s of HBM,
989 TFLOP/s of dense bf16) are what no program reaches; these two probes
measure what this card sustains on the friendliest programs, the measured
denominators under a roofline share (``profile_roofline --calibration``).

- **HBM stream**: STREAM "scale", ``x.mul_(a)`` over a 1 GiB fp32 tensor
  (far past the 50 MB L2), ``iters`` times in a row: each pass reads and
  writes the tensor, ``stream_bytes = iters * 2 * elems * 4``.
- **Tensor-core GEMM**: ``c = c @ b`` at 8192 x 8192 in bf16, ``iters``
  times in a row from the same ``c``; cuBLAS accumulates in fp32 (its
  reduced-precision split-K reduction is switched off for the call); ``b``
  is scaled by 1/sqrt(n) so the values stay bounded. ``gemm_flops = iters *
  2 * n**3``. ``torch.matmul`` is right here: the reference's product is
  its compiler's, not a kernel of its own.

Each probe runs its chain once to warm up, then ``repeats`` times; each run
is timed with CUDA events around the chain and ends in a host read of one
element (finite, or the run fails); the best run counts (``_best_of``). On
the CPU (``--cpu``, the tests) the module's ``time`` clock times the chain
and the read instead. There is no fallback: a probe that fails fails the
run.

Prints one JSON line: ``measured_hbm_gbps``, ``measured_tflops_bf16``, their
fractions of the published peaks (``hbm_fraction_of_spec``,
``tensor_core_fraction_of_spec``), the card's SM clock, power draw and
power limit from ``nvidia-smi`` before and after the probes
(``smi_before``, ``smi_after``; none on the CPU) and ``card`` (the
``nvidia-smi`` name and power limit). ``--cpu`` runs the probes at their
sizes on the host (the tests shrink them); without it and without a card it
exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

from axcnn_torch.cli.profile_step import measurement_device

SPEC_HBM_GBPS = 3350.0  # H100 SXM HBM3, data sheet
SPEC_TFLOPS_BF16 = 989.0  # H100 SXM dense bf16 tensor cores, data sheet
SMI_QUERY = "--query-gpu=clocks.sm,power.draw,power.limit"


def _best_of(fn, repeats=3):
    return max(fn() for _ in range(repeats))


def stream_bytes(elems: int, iters: int) -> int:
    """Bytes the scale chain moves: each pass reads and writes the fp32 tensor."""
    return iters * 2 * elems * 4


def gemm_flops(n: int, iters: int) -> int:
    """FLOPs of ``iters`` square products of side ``n`` (2 a multiply-add)."""
    return iters * 2 * n ** 3


def _timed(run, read, device) -> float:
    """Seconds of ``run()`` and a host read of its result (``read``, which
    must return a finite number): CUDA events on the card, the module's
    ``time`` clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        value = read(out)
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        value = read(run())
        seconds = time.perf_counter() - t0
    if not math.isfinite(value):
        raise RuntimeError(f"the probe's result is not finite: {value}")
    return seconds


def measure_hbm_gbps(*, elems=1 << 28, iters=200, repeats=3, device="cuda") -> float:
    """Sustained GB/s on the STREAM-scale chain over ``elems`` fp32 values."""
    device = torch.device(device)
    x = torch.ones(elems, dtype=torch.float32, device=device)

    def scale():
        for _ in range(iters):
            x.mul_(1.0000001)
        return x

    def read(v):
        return v[0].item()

    read(scale())  # warm-up

    def once():
        return stream_bytes(elems, iters) / _timed(scale, read, device) / 1e9

    return _best_of(once, repeats)


def measure_matmul_tflops(*, n=8192, iters=100, repeats=3, device="cuda") -> float:
    """Sustained bf16 TFLOP/s on a chain of square products of side ``n``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    b = (torch.randn(n, n, generator=gen, device=device) / math.sqrt(n)).to(torch.bfloat16)
    c = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)

    def chain():
        out = c
        for _ in range(iters):
            out = out @ b
        return out

    def read(v):
        return v[0, 0].item()

    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        read(chain())  # warm-up

        def once():
            return gemm_flops(n, iters) / _timed(chain, read, device) / 1e12

        return _best_of(once, repeats)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced


def smi_line() -> str:
    """The card's SM clock, power draw and power limit, from ``nvidia-smi``."""
    return subprocess.run(["nvidia-smi", SMI_QUERY, "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU (tests)")
    args = ap.parse_args(argv)
    picked = measurement_device(args.cpu, "calibrate_roofline")
    if picked is None:
        return 1
    device, card = picked
    cuda = device.type == "cuda"
    before = smi_line() if cuda else None
    gbps = measure_hbm_gbps(device=device)
    tflops = measure_matmul_tflops(device=device)
    print(json.dumps({
        "measured_hbm_gbps": gbps, "measured_tflops_bf16": tflops,
        "hbm_fraction_of_spec": gbps / SPEC_HBM_GBPS,
        "tensor_core_fraction_of_spec": tflops / SPEC_TFLOPS_BF16,
        "smi_before": before, "smi_after": smi_line() if cuda else None, "card": card}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
