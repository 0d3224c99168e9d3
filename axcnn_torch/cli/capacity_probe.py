"""Peak device memory of the BASELINE config-5 train step on one CUDA card, by
batch and remat mode (``scripts/capacity_probe.py``).

    python -m axcnn_torch.cli.capacity_probe [--batches 64,128] [--modes none,blocks]

The step is the reference script's: an Assemble-ResNet-152 student
(ResNet-D, SE, SK, BlurPool ``sconv``, DropBlock, zero-gamma, 1000 classes)
with ``remat`` set to the mode, a frozen Assemble-ResNet-50 teacher with the
same knobs, ``kd_temp`` 2.0, ``kd_alpha`` 0.5, 224x224, bf16, learning rate
0.1 over 100 steps with 10 of warm-up, label smoothing 0.1, mixup 0.2,
weight decay 1e-4, EMA; random uint8 images resident on the card, random
weights from seed 0 (the teacher from seed 1). The reference compiles the
step and reads XLA's static memory analysis; an eager step has none, so
this runs one warm-up step and one measured step and reads the allocator:
``peak_allocated_gib`` (``torch.cuda.max_memory_allocated``),
``peak_reserved_gib`` (``max_memory_reserved``), both reset before the row,
``card_gib`` (the card's memory) and ``fits_card`` (a step ran). A row whose
step raises ``torch.cuda.OutOfMemoryError`` is the probe's answer ``{"fits_card":
false, "oom": true}``; any other error ends the run with a non-zero exit.
One JSON line a row, with ``card`` (the ``nvidia-smi`` name and power
limit).

Left out of the reference's rows: ``temp_gb``, ``args_gb``, ``out_gb``,
``aliased_gb`` and ``total_gb`` (XLA's memory analysis of the compiled
step) and ``fits_16gb`` (the TPU's memory; ``fits_card`` takes its place).

``--cpu`` runs the step on the host (the tests, at ``--width`` and
``--image_size`` below the defaults; the memory keys are then null); without
it and without a card it exits 1.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys

import torch

from axcnn_torch.cli.profile_step import _step_runner, measurement_device
from axcnn_torch.models.resnet import ModelConfig

# the reference script's knobs of both models
COMMON = dict(num_classes=1000, use_resnet_d=True, use_se_block=True, use_sk_block=True,
              anti_alias_type="sconv", use_dropblock=True, zero_gamma=True)
KD = dict(kd_temp=2.0, kd_alpha=0.5)
SCHEDULE = dict(base_lr=0.1, total_steps=100, warmup_steps=10)
GIB = 2 ** 30


def configs(mode: str, width: float = 1.0):
    """(student, teacher) model configs."""
    return (ModelConfig(resnet_size=152, remat=mode, width_multiplier=width, **COMMON),
            ModelConfig(resnet_size=50, width_multiplier=width, **COMMON))


def _step(mode, batch, device, image_size, width) -> float:
    student, teacher = configs(mode, width)
    enqueue, wait = _step_runner(student, teacher_cfg=teacher, device=device, batch_size=batch,
                                 image_size=image_size, schedule=SCHEDULE, weight_decay=1e-4,
                                 **KD)
    wait(enqueue())
    loss = float(enqueue()["loss"])
    assert math.isfinite(loss), loss
    return loss


def probe(mode: str, batch: int, device, image_size: int = 224, width: float = 1.0) -> dict:
    row = {"mode": mode, "batch": batch}
    cuda = device.type == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    try:
        row["loss"] = _step(mode, batch, device, image_size, width)
    except torch.cuda.OutOfMemoryError:
        row.update(fits_card=False, oom=True)
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    if "oom" in row:
        return row
    if not cuda:  # the host has no device memory to read
        return {**row, **dict.fromkeys(("peak_allocated_gib", "peak_reserved_gib", "card_gib",
                                        "fits_card")), "oom": False}
    return {**row, "peak_allocated_gib": torch.cuda.max_memory_allocated(device) / GIB,
            "peak_reserved_gib": torch.cuda.max_memory_reserved(device) / GIB,
            "card_gib": torch.cuda.get_device_properties(device).total_memory / GIB,
            "fits_card": True, "oom": False}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="64,128")
    ap.add_argument("--modes", default="none,blocks")
    ap.add_argument("--width", type=float, default=1.0, help="width multiplier (tests)")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU (tests)")
    args = ap.parse_args(argv)
    picked = measurement_device(args.cpu, "capacity_probe")
    if picked is None:
        return 1
    device, card = picked
    for b in [int(x) for x in args.batches.split(",")]:
        for mode in args.modes.split(","):
            row = probe(mode, b, device, args.image_size, args.width)
            print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
