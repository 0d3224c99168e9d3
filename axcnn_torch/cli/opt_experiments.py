"""Step-time experiments around the b128 operating point of the assembled
ResNet-50 train step on one CUDA card (``scripts/opt_experiments.py``).

    python -m axcnn_torch.cli.opt_experiments [--cases batch,sk_merged,unrolled_r152] \\
        [--batches 96,128,160,192]

Each row times the reference script's step under one variation
(``time_step``): its ``ModelConfig`` (ResNet-D, SE, SK, BlurPool ``sconv``,
DropBlock, zero-gamma, 1000 classes, 224x224), learning rate 0.4 over 1,000
steps with 100 of warm-up, label smoothing 0.1, mixup 0.2, weight decay
1e-4, EMA, bf16, random uint8 images resident on the card, random weights
from seed 0. ``WARM`` (3) steps, then ``TIMED`` (10) steps enqueued back to
back and one read of the last loss: ``step_ms`` and ``images_per_sec``;
then one more step, not timed, counted by the per-op accountant
(``profile_roofline.count_step``): ``gflop`` (as executed), ``tflops`` and
``mfu`` (against 989 TFLOP/s of dense bf16, the H100 SXM's data-sheet
peak). The rows:

- ``batch_{96,128,160,192}`` (``batch``; ``--batches`` picks the batches);
- ``sk_merged_b128`` (``sk_merged``): SK's two branches as one 5x5 conv
  (``sk_merged_conv=True``) at ``SK_BATCH`` (128);
- ``unrolled_r152_b64`` (``unrolled_r152``): ResNet-152 at ``R152_BATCH`` (64).

The reference's other rows have no torch meaning and are not run:
``pallas_off_b128`` (the port has no kernel switch: a CUDA tensor takes the
kernel, and PERF.md's kernel table gives each plain version's time),
``scan_r50_b128`` and ``scan_r152_b64`` (``scan_blocks`` is a JAX
compile-time lever the port refuses, ``models/resnet.py``), the
``flags_*`` rows (XLA TPU compiler options), and each row's ``compile_s``
(an eager step compiles nothing; the kernels build once a process).

One JSON line a row, with ``case`` and ``card`` (the ``nvidia-smi`` name and
power limit). ``--cpu`` runs it on the host (the tests, at ``--width`` and
``--image_size`` below the defaults); without it and without a card it
exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from axcnn_torch.cli.calibrate_roofline import SPEC_TFLOPS_BF16
from axcnn_torch.cli.profile_roofline import count_step
from axcnn_torch.cli.profile_step import _step_runner, chained_s, measurement_device
from axcnn_torch.models.resnet import ModelConfig

SCHEDULE = dict(base_lr=0.4, total_steps=1000, warmup_steps=100)
WARM = 3
TIMED = 10
SK_BATCH = 128
R152_BATCH = 64
CASES = ("batch", "sk_merged", "unrolled_r152")


def model_config(resnet_size: int = 50, sk_merged: bool = False,
                 width: float = 1.0) -> ModelConfig:
    return ModelConfig(resnet_size=resnet_size, num_classes=1000, use_resnet_d=True,
                       use_se_block=True, use_sk_block=True, sk_merged_conv=sk_merged,
                       anti_alias_type="sconv", use_dropblock=True, zero_gamma=True,
                       width_multiplier=width)


def time_step(batch_size, *, sk_merged=False, resnet_size=50, warm=WARM, timed=TIMED,
              device="cuda", image_size=224, width=1.0) -> dict:
    cfg = model_config(resnet_size, sk_merged, width)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    enqueue, wait = _step_runner(cfg, device=device, batch_size=batch_size,
                                 image_size=image_size, schedule=SCHEDULE, weight_decay=1e-4)
    for _ in range(warm):
        wait(enqueue())
    seconds, metrics = chained_s(enqueue, wait, timed)
    dt, loss = seconds / timed, float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"the step's loss is not finite: {loss}")
    gflop = count_step(enqueue, wait)["flops"] / 1e9
    return {"step_ms": dt * 1e3, "images_per_sec": batch_size / dt, "gflop": gflop,
            "tflops": gflop / dt / 1e3, "mfu": gflop / dt / 1e3 / SPEC_TFLOPS_BF16}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default=",".join(CASES), help=f"comma list of {CASES}")
    ap.add_argument("--batches", default="96,128,160,192", help="the batch sweep's batches")
    ap.add_argument("--width", type=float, default=1.0, help="width multiplier (tests)")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU (tests)")
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    if set(cases) - set(CASES):
        ap.error(f"--cases takes {CASES}, got {args.cases}")
    picked = measurement_device(args.cpu, "opt_experiments")
    if picked is None:
        return 1
    device, card = picked
    rows = []
    if "batch" in cases:
        rows += [(f"batch_{b}", b, {}) for b in map(int, args.batches.split(","))]
    if "sk_merged" in cases:
        rows.append((f"sk_merged_b{SK_BATCH}", SK_BATCH, {"sk_merged": True}))
    if "unrolled_r152" in cases:
        rows.append((f"unrolled_r152_b{R152_BATCH}", R152_BATCH, {"resnet_size": 152}))
    for name, batch, kw in rows:
        row = time_step(batch, warm=WARM, timed=TIMED, device=device,
                        image_size=args.image_size, width=args.width, **kw)
        print(json.dumps({"case": name, "batch": batch, **row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
