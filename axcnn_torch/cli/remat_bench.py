"""Step time, FLOP rate, bytes and peak memory of the assembled ResNet-50
train step by ``ModelConfig.remat`` mode and batch on one CUDA card
(``scripts/remat_bench.py``).

    python -m axcnn_torch.cli.remat_bench [--batches 128,256] [--modes none,blocks]

The step is the reference script's: ResNet-D, SE, SK, BlurPool ``sconv``,
DropBlock, zero-gamma, 1000 classes, 224x224, bf16, learning rate 0.4 over
1,000 steps with 100 of warm-up, label smoothing 0.1, mixup 0.2, weight
decay 1e-4, EMA; random uint8 images resident on the card, random weights
from seed 0. Per (batch, mode), after ``WARMUP`` steps: ``TIMED`` steps
enqueued back to back and one read of the last loss; ``ms`` and ``img_s``
per step; then one more step, not timed, counted by the per-op accountant
(``profile_roofline.count_step``): ``gflop``, the step's FLOPs as executed
(``flop_registry``'s convolutions and matmuls; with ``blocks`` the replay's
included, as the reference's cost model counts it), ``model_gflop``
without the replay, ``gb`` (each op's unique input and output bytes);
from them and the timed steps ``tflops``, ``mfu`` (against 989 TFLOP/s of
dense bf16), ``gbps`` and ``hbm_util`` (against 3,350 GB/s: the H100 SXM's
data-sheet peaks); and ``peak_gib`` (``torch.cuda.max_memory_allocated``,
reset before each row). One JSON line a row, with ``card`` (the
``nvidia-smi`` name and power limit).

Left out of the reference's rows: ``temp_gb`` (XLA's memory analysis of
the compiled step; ``peak_gib`` is the card's measure). ``conv`` is an XLA
name policy with no torch meaning: the port refuses it
(``models/resnet.py``), so ``--modes`` with ``conv`` exits 1 with that
refusal and prints no row for it.

``--cpu`` runs it on the host (the tests, at ``--width`` and
``--image_size`` below the defaults); without it and without a card it exits
1.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from axcnn_torch.cli.calibrate_roofline import SPEC_HBM_GBPS, SPEC_TFLOPS_BF16
from axcnn_torch.cli.profile_roofline import count_step
from axcnn_torch.cli.profile_step import _step_runner, chained_s, measurement_device
from axcnn_torch.models.resnet import ModelConfig, refuse_xla_remat

WARMUP = 3
TIMED = 15
SCHEDULE = dict(base_lr=0.4, total_steps=1000, warmup_steps=100)


def model_config(mode: str, width: float = 1.0) -> ModelConfig:
    return ModelConfig(resnet_size=50, num_classes=1000, use_resnet_d=True, use_se_block=True,
                       use_sk_block=True, anti_alias_type="sconv", use_dropblock=True,
                       zero_gamma=True, remat=mode, width_multiplier=width)


def measure(mode: str, batch: int, device, image_size: int = 224, width: float = 1.0,
            warmup: int = WARMUP, timed: int = TIMED) -> dict:
    cfg = model_config(mode, width)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    enqueue, wait = _step_runner(cfg, device=device, batch_size=batch, image_size=image_size,
                                 schedule=SCHEDULE, weight_decay=1e-4)
    for _ in range(warmup):
        wait(enqueue())
    seconds, metrics = chained_s(enqueue, wait, timed)
    dt, loss = seconds / timed, float(metrics["loss"])
    assert math.isfinite(loss), loss
    counted = count_step(enqueue, wait)
    gflop, gb = counted["flops"] / 1e9, counted["bytes"] / 1e9
    tflops, gbps = gflop / dt / 1e3, gb / dt
    return {"mode": mode, "batch": batch, "ms": dt * 1e3, "img_s": batch / dt,
            "gflop": gflop, "model_gflop": counted["model_flops"] / 1e9, "gb": gb,
            "tflops": tflops, "mfu": tflops / SPEC_TFLOPS_BF16, "gbps": gbps,
            "hbm_util": gbps / SPEC_HBM_GBPS, "loss": loss,
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                         if device.type == "cuda" else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="128,256")
    ap.add_argument("--modes", default="none,blocks")
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--timed", type=int, default=TIMED)
    ap.add_argument("--width", type=float, default=1.0, help="width multiplier (tests)")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU (tests)")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    for mode in modes:  # refused before any row is measured
        try:
            refuse_xla_remat(model_config(mode))
        except (NotImplementedError, ValueError) as exc:
            print(f"remat_bench: --modes={mode}: {exc}", file=sys.stderr)
            return 1
    picked = measurement_device(args.cpu, "remat_bench")
    if picked is None:
        return 1
    device, card = picked
    for b in [int(x) for x in args.batches.split(",")]:
        for mode in modes:
            row = measure(mode, b, device, args.image_size, args.width, args.warmup,
                          args.timed)
            print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
