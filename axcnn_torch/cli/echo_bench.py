"""Loader-fed training throughput by data-echo factor on one CUDA card, with
AutoAugment on the host and on the card (``scripts/echo_bench.py``).

    python -m axcnn_torch.cli.echo_bench [--factors 1,2,4,8] [--aa host,device]

Data echoing (Choi et al. 2019) feeds each host batch to ``factor``
consecutive steps (``EchoIterator`` around ``device_prefetch``: the batch is
on the card already), so host decode, AA and the copy drop to 1/factor while
each step's own draws (mixup, DropBlock, device AA) stay fresh:

- ``host``: the native loader decodes and runs AutoAugment v0 (C++); echoed
  steps share the augmented pixels;
- ``device``: the native loader decodes only; AutoAugment v0 runs in the
  step on the card (``axcnn_torch.data.autoaugment_device``), a fresh policy
  draw each step.

The step is the assembled ResNet-50's (ResNet-D, SE, SK, BlurPool ``sconv``,
DropBlock, zero-gamma, 1000 classes), batch 128, 224x224, bf16, learning
rate 0.4 over 1,000 steps with 100 of warm-up, label smoothing 0.1, mixup
0.2, weight decay 1e-4, EMA, random weights from seed 0; the data is the
reference's bench set, ``loader_bench.make_data``'s 2,048 JPEGs. Per
(placement, factor), a fresh loader (seed 1, a decode thread a core,
prefetch 4) and state, ``WARMUP`` steps, then the best of ``WINDOWS`` windows
of ``TIMED`` steps, each window ending in one read of its last loss: one
JSON line a row with ``aa``, ``factor``, ``echo{factor}`` (img/s, the
reference's key), every window's img/s, the steps and the host batches
they took, ``host_cores`` (``os.cpu_count()``),
``affinity_cores`` (the cores this process may run on) and ``card`` (the
``nvidia-smi`` name and power limit).

``--cpu`` runs it on the host (the tests, at ``--width``, ``--image_size``
and ``--batch`` below the defaults); without it and without a card it exits
1.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

from axcnn_torch.cli import loader_bench
from axcnn_torch.cli.profile_step import _step_runner, chained_s, measurement_device
from axcnn_torch.cli.remat_bench import SCHEDULE, model_config

FACTORS = (1, 2, 4, 8)
TIMED = 24
WINDOWS = 3  # the best of them: the host's scheduler noise
WARMUP = 3
BATCH = 128
N_IMAGES = 2048
DATA_DIR = os.path.join(tempfile.gettempdir(), "axcnn_bench_data")


def measure(aa: str, factor: int, device, *, data_dir=DATA_DIR, n_images=N_IMAGES,
            batch=BATCH, image_size=224, width=1.0, warmup=WARMUP, timed=TIMED,
            windows=WINDOWS) -> dict:
    from axcnn_torch.data.autoaugment_device import make_device_autoaugment
    from axcnn_torch.data.pipeline import EchoIterator, device_prefetch

    ldr = loader_bench.loader(data_dir, n_images, batch, os.cpu_count() or 8,
                              aa=aa == "host", image_size=image_size)
    feed = device_prefetch(iter(ldr), device=device, size=4)
    pulled = [0]  # the host batches the steps took

    def fresh():
        for b in feed:
            pulled[0] += 1
            yield b

    try:
        echoed = EchoIterator(fresh(), factor)
        enqueue, wait = _step_runner(
            model_config("none", width), device=device, batch_size=batch, schedule=SCHEDULE,
            batches=echoed, weight_decay=1e-4,
            autoaugment_fn=make_device_autoaugment("v0") if aa == "device" else None)
        for _ in range(warmup):
            wait(enqueue())
        rates = []
        for _ in range(windows):
            seconds, metrics = chained_s(enqueue, wait, timed)
            assert math.isfinite(float(metrics["loss"]))
            rates.append(timed * batch / seconds)
    finally:
        feed.close()
    return {"aa": aa, "factor": factor, f"echo{factor}": max(rates), "windows_img_s": rates,
            "steps": warmup + windows * timed, "host_batches": pulled[0],
            "host_cores": os.cpu_count() or 1,
            "affinity_cores": len(os.sched_getaffinity(0))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--factors", default=",".join(map(str, FACTORS)))
    ap.add_argument("--aa", default="host,device", help="comma list: host and/or device")
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--timed", type=int, default=TIMED)
    ap.add_argument("--windows", type=int, default=WINDOWS)
    ap.add_argument("--data_dir", default=DATA_DIR)
    ap.add_argument("--n_images", type=int, default=N_IMAGES)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--width", type=float, default=1.0, help="width multiplier (tests)")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU (tests)")
    args = ap.parse_args(argv)
    picked = measurement_device(args.cpu, "echo_bench")
    if picked is None:
        return 1
    device, card = picked
    loader_bench.make_data(args.data_dir, args.n_images)
    for aa in args.aa.split(","):
        for factor in [int(x) for x in args.factors.split(",")]:
            row = measure(aa, factor, device, data_dir=args.data_dir, n_images=args.n_images,
                          batch=args.batch, image_size=args.image_size, width=args.width,
                          warmup=args.warmup, timed=args.timed, windows=args.windows)
            print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
