"""Full-recipe convergence drive (port of ``scripts/convergence_drive.py``).

Trains the whole config-4 stack for a few hundred steps on a generated
4-class set (4 x 64 JPEGs), then evaluates the raw and the EMA weights:
ResNet-D, SK, SE, BlurPool ``sconv`` and DropBlock (both on the card's
kernels), scheduled keep-prob, zero-gamma, AutoAugment v0 in the native
loader, mixup 0.2, label smoothing 0.1, EMA, bf16, at full width, 224x224,
batch 64, 300 steps, base LR 0.05 with 20 warmup steps. ``bn_momentum=0.9``
and ``ema_decay=0.99`` fit the short horizon, as in the reference. Bars
(``check``): raw top-1 >= 90 and EMA top-1 >= raw - 1.

    python -m axcnn_torch.drives.convergence [root]          # on the card
    python -m axcnn_torch.drives.convergence ROOT --cpu --steps=2 --batch=4 \\
        --image_size=64 --width=0.125 --n_per_class=2 --no-check

The options' defaults are the reference's constants; ``--cpu`` runs on the
host CPU, ``--no-check`` prints the summary without asserting the bars.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from axcnn_torch.drives import common
from axcnn_torch.drives.data import CLASSES, make_dataset
from axcnn_torch.models.resnet import ModelConfig
from axcnn_torch.train.schedules import make_lr_schedule
from axcnn_torch.train.train_step import create_train_state, make_train_step

STEPS = 300
BATCH = 64
IMAGE = 224
N_PER_CLASS = 64
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "axcnn_torch_convergence")
OK_LINE = "CONVERGENCE DRIVE OK"
# the reference's eval lines (scripts/convergence_drive.py:126-128)
SUMMARY_KEYS = tuple(f"{w}/{m}" for w in ("raw", "ema") for m in ("top1", "top5", "loss", "count"))


def model_config(num_classes: int = len(CLASSES), width: float = 1.0) -> ModelConfig:
    """Config 4, with ``bn_momentum`` 0.9 so that the moving statistics
    settle within 300 steps."""
    return ModelConfig(resnet_size=50, num_classes=num_classes, use_resnet_d=True,
                       use_se_block=True, use_sk_block=True, anti_alias_type="sconv",
                       use_dropblock=True, dropblock_keep_prob=0.9, zero_gamma=True,
                       bn_momentum=0.9, width_multiplier=width)


def check(summary: dict) -> None:
    """The reference's bars; ``AssertionError`` with the summary on a miss."""
    raw, ema = summary["raw"]["top1"], summary["ema"]["top1"]
    assert raw >= 90.0, summary
    assert ema >= raw - 1.0, summary


def run(root: str = DEFAULT_ROOT, *, steps: int = STEPS, batch: int = BATCH,
        image_size: int = IMAGE, width: float = 1.0, num_classes: int = len(CLASSES),
        n_per_class: int = N_PER_CLASS, device=None, check_bars: bool = True,
        log=print) -> dict:
    """Generate the set, train, evaluate raw and EMA; returns the summary
    (``raw``/``ema``: top1, top5, loss, count; ``train``: the step loop's
    record; ``native_loader``). Asserts the bars when ``check_bars``."""
    device = common.resolve_device(device)
    os.makedirs(root, exist_ok=True)
    data_dir, info = make_dataset(root, n_per_class, CLASSES[:num_classes])
    log(f"device: {device}")
    cfg = model_config(num_classes, width)
    loader = common.native_loader(data_dir, info, batch=batch, image_size=image_size,
                                  train=True, autoaugment_type="v0", seed=0)
    step_fn = make_train_step(
        cfg, lr_schedule=make_lr_schedule(base_lr=0.05, total_steps=steps,
                                          warmup_steps=steps // 15),
        total_steps=steps, policy=common.POLICY, label_smoothing=0.1, mixup_alpha=0.2,
        weight_decay=1e-4, use_ema=True, ema_decay=0.99,
        mean_rgb=info.mean_rgb, stddev_rgb=info.stddev_rgb)
    state = create_train_state(cfg, generator=torch.Generator().manual_seed(0),
                               device=device, use_ema=True)
    state, record = common.run_steps(step_fn, state, loader, steps, root_seed=1, device=device,
                                     label="train", log_every=50, log=log)
    summary = {"steps": steps, "batch": batch, "image_size": image_size, "width": width}
    for name, use_ema in (("raw", False), ("ema", True)):
        m = common.evaluate_split(cfg, state, data_dir, info, use_ema=use_ema, batch=batch,
                                  image_size=image_size, device=device)
        summary[name] = m
        log(f"eval[{name}]: top1={m['top1']:.2f}% top5={m['top5']:.2f}% "
            f"loss={m['loss']:.4f} count={m['count']:.0f}")
    summary.update(train=record, native_loader=True)
    log(json.dumps(summary))
    if check_bars:
        check(summary)
        log(OK_LINE)
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", nargs="?", default=DEFAULT_ROOT)
    common.add_size_args(p, steps=STEPS, batch=BATCH, image_size=IMAGE)
    p.add_argument("--num_classes", type=int, default=len(CLASSES))
    p.add_argument("--n_per_class", type=int, default=N_PER_CLASS)
    a = p.parse_args(argv)
    return run(a.root, steps=a.steps, batch=a.batch, image_size=a.image_size, width=a.width,
               num_classes=a.num_classes, n_per_class=a.n_per_class,
               device="cpu" if a.cpu else None, check_bars=a.check)


if __name__ == "__main__":
    main()
