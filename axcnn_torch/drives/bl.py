"""Big-Little drive: ``bl_resnet50`` trained through the literal training
CLI, and its step timed against its own ablation (port of
``scripts/bl_drive.py``).

- Convergence: ``--config=bl_resnet50`` (bL-Net alpha 2, beta 4) on the
  50-class set of the scale drive (``drives/data.py`` ``make_scale_set``,
  120 train and 24 held-out images a class, in ``--scale_root``), echo 2,
  batch 64, 900 steps, base LR 0.2 a 256 images, warm-up 0.07 of the run,
  the hang watchdog at 600 s (exit 42: the CLI runs again and resumes).
  The held-out EMA eval is the run's own last ``eval`` record.
- Speed: ``step_time_probe``, the train step on one synthetic batch of 64
  224x224 images kept on the card: 5 warm-up steps, then 30 timed, each
  run ending in a host read of the loss; for ``bl_resnet50``, for the same
  preset with ``bl_alpha = bl_beta = 0`` (its ResNet-D ablation) and for
  ``assemble_resnet50``.

Bars (``check``): top-1 >= 85, and the BL step faster than its ablation's.

    python -m axcnn_torch.drives.bl [root]     # on the card

Options: ``--steps`` (the CLI run's), ``--probe_steps`` (the timed
steps), ``--batch``, ``--image_size``, ``--width``, the 50-class set's
images a class (``--n_train``, ``--n_eval``) and its directory
(``--scale_root``), ``--cpu`` and ``--no-check``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from axcnn_torch.drives import common
from axcnn_torch.drives.data import SCALE_ROOT, make_scale_set
from axcnn_torch.train.schedules import make_lr_schedule
from axcnn_torch.train.train_step import create_train_state, make_train_step

BATCH = 64
IMAGE = 224
STEPS = 900
PROBE_WARMUP, PROBE_STEPS = 5, 30
ACC_BAR = 85.0  # the acceptance drive's bar for its training legs
N_TRAIN, N_EVAL = 120, 24
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "axcnn_torch_bl")
OK_LINE = "BIG-LITTLE DRIVE (bl_resnet50 preset, literal CLI) OK"
# the reference's summary (scripts/bl_drive.py:173-181)
SUMMARY_KEYS = ("bl_top1", "bl_top5", "bl_step_ms", "resnet_d_step_ms", "assembled_step_ms",
                "bl_img_per_sec", "bl_vs_resnet_d", "bl_vs_assembled")


def cli_flags(data_dir: str, info, model_dir: str, steps: int, batch: int = BATCH) -> list:
    """The reference's literal flag list."""
    return ["--config=bl_resnet50",
            *common.cli_data_flags(data_dir, info),
            f"--runtime.model_dir={model_dir}",
            f"--train.batch_size={batch}",
            f"--train.train_steps={steps}",
            "--train.lr_warmup_epochs=0.07",
            "--train.base_lr=0.2",
            "--runtime.hang_watchdog_s=600"]


def probe_config(preset: str, num_classes: int, width: float = 1.0, **overrides):
    """``preset``'s model config with the set's head (and ``overrides``)."""
    cfg = importlib.import_module(f"axcnn_torch.configs.{preset}").get_config().model
    return dataclasses.replace(cfg, num_classes=num_classes, width_multiplier=width,
                               **overrides)


def step_time_probe(cfg, *, device, batch: int = BATCH, image_size: int = IMAGE,
                    steps: int = PROBE_STEPS) -> float:
    """Seconds a train step of ``cfg`` on one synthetic batch kept on the
    device (the card-bound number: the CLI run's img/s is the host
    loader's), after ``PROBE_WARMUP`` steps; each run of steps ends in a
    host read of the loss."""
    step = make_train_step(
        cfg, lr_schedule=make_lr_schedule(base_lr=0.05, total_steps=1000, warmup_steps=50),
        total_steps=1000, policy=common.POLICY, label_smoothing=0.1, mixup_alpha=0.2,
        weight_decay=1e-4, use_ema=True)
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0), device=device,
                               use_ema=True)
    rng = np.random.default_rng(0)
    batch_ = {
        "images": torch.from_numpy(rng.integers(0, 255, (batch, image_size, image_size, 3),
                                                dtype=np.uint8)).to(device),
        "labels": torch.from_numpy(rng.integers(0, cfg.num_classes, (batch,),
                                                dtype=np.int32)).to(device),
    }
    for _ in range(PROBE_WARMUP):
        state, m = step(state, batch_, 1)
    loss = float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch_, 1)
    loss = float(m["loss"])
    dt = (time.perf_counter() - t0) / steps
    assert np.isfinite(loss), loss
    return dt


def check(summary: dict) -> None:
    """The reference's bars; ``AssertionError`` with the summary on a miss."""
    assert summary["bl_top1"] >= ACC_BAR, f"BL failed to train: {summary}"
    assert summary["bl_step_ms"] < summary["resnet_d_step_ms"], (
        f"BL not faster than its own no-BL ablation: {summary['bl_step_ms']:.1f} vs "
        f"{summary['resnet_d_step_ms']:.1f} ms: {summary}")


def run(root: str = DEFAULT_ROOT, *, steps: int = STEPS, probe_steps: int = PROBE_STEPS,
        batch: int = BATCH, image_size: int = IMAGE, width: float = 1.0, n_train: int = N_TRAIN, n_eval: int = N_EVAL,
        scale_root: str = SCALE_ROOT, device=None, check_bars: bool = True,
        log=print) -> dict:
    device = common.resolve_device(device)
    os.makedirs(root, exist_ok=True)
    data_dir, info = make_scale_set(scale_root, n_train=n_train, n_eval=n_eval, seed=0, log=log)
    mdir = os.path.join(root, "bl_resnet50")
    seconds = None
    if not common.train_complete(mdir, steps):
        seconds = common.cli(
            [*cli_flags(data_dir, info, mdir, steps, batch),
             *common.cli_run_flags(device, width=width, image_size=image_size,
                                   full_size=IMAGE)],
            "bl-train", mdir, log, retries=2)
    ev = common.last_eval(mdir)
    log(f"[bl] held-out ema top1={ev['top1']:.2f} top5={ev['top5']:.2f} loss={ev['loss']:.4f}")

    log("[probe] step wall time (synthetic batch on the device)...")
    probe = dict(device=device, batch=batch, image_size=image_size, steps=probe_steps)
    t_bl = step_time_probe(probe_config("bl_resnet50", info.num_classes, width), **probe)
    # the same preset with the branches off (a plain ResNet-50-D): what
    # bl_alpha and bl_beta buy
    t_d = step_time_probe(probe_config("bl_resnet50", info.num_classes, width,
                                       bl_alpha=0, bl_beta=0), **probe)
    # and the accuracy-oriented preset BL stands beside
    t_as = step_time_probe(probe_config("assemble_resnet50", info.num_classes, width), **probe)
    summary = {
        "bl_top1": ev["top1"], "bl_top5": ev["top5"],
        "bl_step_ms": t_bl * 1e3, "resnet_d_step_ms": t_d * 1e3,
        "assembled_step_ms": t_as * 1e3, "bl_img_per_sec": batch / t_bl,
        "bl_vs_resnet_d": t_d / t_bl, "bl_vs_assembled": t_as / t_bl,
        "steps": steps, "probe_steps": [PROBE_WARMUP, probe_steps],
        "train_loss": common.train_losses(mdir), "seconds": seconds, "native_loader": True,
    }
    log(json.dumps(summary))
    if check_bars:
        check(summary)
        log(OK_LINE)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?", default=DEFAULT_ROOT)
    common.add_size_args(p, steps=STEPS, batch=BATCH, image_size=IMAGE)
    p.add_argument("--probe_steps", type=int, default=PROBE_STEPS)
    p.add_argument("--n_train", type=int, default=N_TRAIN)
    p.add_argument("--n_eval", type=int, default=N_EVAL)
    p.add_argument("--scale_root", default=SCALE_ROOT)
    a = p.parse_args(argv)
    return run(a.root, steps=a.steps, probe_steps=a.probe_steps,
               batch=a.batch, image_size=a.image_size, width=a.width, n_train=a.n_train,
               n_eval=a.n_eval, scale_root=a.scale_root, device="cpu" if a.cpu else None,
               check_bars=a.check)


if __name__ == "__main__":
    main()
