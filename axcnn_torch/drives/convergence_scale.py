"""Scaled convergence drive: 50 classes with the production constants (port
of ``scripts/convergence_drive_scale.py``).

- 50 classes, 10 hues x 5 spatial patterns (``drives/data.py``
  ``make_scale_set``): 120 train and 24 held-out generated JPEGs a class,
  seed 0; every class needs a colour and a pattern, both invariant under
  the training augmentations.
- config 4 with ``bn_momentum=0.997`` and ``ema_decay=0.9999`` with its
  ramp, 2,500 steps, batch 64, 224x224, bf16, base LR 0.05 with a warm-up
  of ``STEPS // 15`` steps, label smoothing 0.1, mixup 0.2, weight decay
  1e-4, the native loader with AutoAugment v0.
- Data echoing x2 between the device prefetch and the step
  (``EchoIterator``): echoed steps draw their mixup, DropBlock and crop
  afresh over repeated pixels; step 1 trains on the first batch.
- The held-out eval with the raw and the EMA weights, top-1 and top-5.

Bars (``check``): EMA top-1 >= 85, EMA >= raw - 1, EMA top-5 >= 95.

    python -m axcnn_torch.drives.convergence_scale [root]     # on the card

Options: ``--steps``, ``--batch``, ``--image_size``,
``--width``, the images a class (``--n_train``, ``--n_eval``), ``--cpu``
and ``--no-check``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from axcnn_torch.drives import common
from axcnn_torch.drives.data import SCALE_CLASSES, SCALE_ROOT, make_scale_set
from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.train.schedules import make_lr_schedule
from axcnn_torch.train.train_step import create_train_state, make_train_step

BATCH = 64
IMAGE = 224
STEPS = 2500
ECHO = 2
N_TRAIN, N_EVAL = 120, 24
DEFAULT_ROOT = SCALE_ROOT
OK_LINE = "SCALE CONVERGENCE DRIVE (50 classes, production constants, echo x2) OK"
# the reference's summary (scripts/convergence_drive_scale.py:217-218)
SUMMARY_KEYS = tuple(f"{leg}/{m}" for leg in ("raw", "ema") for m in ("top1", "top5", "loss"))


def model_config(width: float = 1.0) -> ModelConfig:
    return ModelConfig(resnet_size=50, num_classes=SCALE_CLASSES, use_resnet_d=True,
                       use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
                       use_dropblock=True, dropblock_keep_prob=0.9, zero_gamma=True,
                       bn_momentum=0.997, width_multiplier=width)  # production constant


def check(summary: dict) -> None:
    """The reference's bars; ``AssertionError`` with the summary on a miss."""
    raw1, ema1 = summary["raw"]["top1"], summary["ema"]["top1"]
    assert ema1 >= 85.0, f"EMA top-1 {ema1} < 85 on 50 classes: {summary}"
    assert ema1 >= raw1 - 1.0, f"EMA lags raw: {ema1} vs {raw1}: {summary}"
    assert summary["ema"]["top5"] >= 95.0, f"EMA top-5 < 95: {summary}"


def run(root: str = DEFAULT_ROOT, *, steps: int = STEPS, batch: int = BATCH,
        image_size: int = IMAGE, width: float = 1.0, n_train: int = N_TRAIN,
        n_eval: int = N_EVAL, device=None, check_bars: bool = True, log=print) -> dict:
    device = common.resolve_device(device)
    os.makedirs(root, exist_ok=True)
    data_dir, info = make_scale_set(root, n_train=n_train, n_eval=n_eval, seed=0, log=log)
    cfg = model_config(width)
    loader = common.native_loader(data_dir, info, batch=batch, image_size=image_size,
                                  train=True, autoaugment_type="v0", seed=0)
    step_fn = make_train_step(
        cfg, lr_schedule=make_lr_schedule(base_lr=0.05, total_steps=steps,
                                          warmup_steps=steps // 15),
        total_steps=steps, policy=common.POLICY, label_smoothing=0.1, mixup_alpha=0.2,
        weight_decay=1e-4, use_ema=True, ema_decay=0.9999,  # production constant
        mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), device=device,
                               use_ema=True)
    state, record = common.run_steps(step_fn, state, loader, steps, root_seed=1, device=device,
                                     label="train", log_every=500, echo=ECHO, log=log)
    log(f"[train] {steps} steps (echo x{ECHO}) in {record['seconds']:.0f}s = "
        f"{steps * batch / record['seconds']:.0f} img/s end-to-end")
    summary = {}
    for name, use_ema in (("raw", False), ("ema", True)):
        m = common.evaluate_split(cfg, state, data_dir, info, use_ema=use_ema, batch=batch,
                                  image_size=image_size, device=device)
        summary[name] = m
        log(f"eval[{name}] (held-out): top1={m['top1']:.2f}% top5={m['top5']:.2f}% "
            f"loss={m['loss']:.4f} count={m['count']:.0f}")
    summary.update(steps=steps, echo=ECHO, batch=batch, image_size=image_size, train=record,
                   native_loader=True)
    log(json.dumps(summary))
    if check_bars:
        check(summary)
        log(OK_LINE)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?", default=DEFAULT_ROOT)
    common.add_size_args(p, steps=STEPS, batch=BATCH, image_size=IMAGE)
    p.add_argument("--n_train", type=int, default=N_TRAIN)
    p.add_argument("--n_eval", type=int, default=N_EVAL)
    a = p.parse_args(argv)
    return run(a.root, steps=a.steps, batch=a.batch, image_size=a.image_size,
               width=a.width, n_train=a.n_train, n_eval=a.n_eval,
               device="cpu" if a.cpu else None, check_bars=a.check)


if __name__ == "__main__":
    main()
